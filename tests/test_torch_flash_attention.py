"""The port's causal softmax attention (``tlie_tpu_torch/ops/attention.py``)
against tlie_tpu's: the plain forward and the backward of
``FlashAttentionFn`` against JAX's own Pallas TPU flash kernel (run in
interpret mode, as tlie_tpu's kernel tests run Pallas on the CPU), against
``_xla_causal_attention`` at ragged lengths and head dims, and against float64.

Inputs are made with numpy from a seed.  Tolerances are stated where they
are used; the shared one holds every output element to
``RTOL_OF_TERMS + logit_rtol`` of the sum of its terms' magnitudes
(``attention.term_scales``), the float32 rounding of its sums and of the
logits that enter its exp.  Two float32 implementations that each sit
within that of the exact value sit within twice that of each other.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tlie_tpu.ops import attention as jax_attention
from tlie_tpu_torch.ops import LAUNCHES
from tlie_tpu_torch.ops import attention as fa

torch.set_num_threads(1)

RTOL_OF_TERMS = 1e-5


def _inputs(B, L, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))


def _port(q, k, v, w, dtype=torch.float32):
    """o and (dq, dk, dv) of Σ o·w through FlashAttentionFn on the CPU."""
    t = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    o = fa.causal_softmax_attention(*t)
    o.backward(torch.tensor(w, dtype=dtype))
    return o.detach(), tuple(a.grad for a in t)


def _jax(fn, q, k, v, w, scale):
    o, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, scale), q, k, v)
    return np.asarray(o), tuple(np.asarray(g) for g in vjp(jnp.asarray(w)))


def _tolerances(q, k, v, w):
    """2·(RTOL_OF_TERMS + logit_rtol)·Σ|terms| of o, dq, dk, dv, from the
    float64 plain version."""
    t = [torch.tensor(a, dtype=torch.float64) for a in (q, k, v, w)]
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, lse = fa.flash_attention_plain(t[0], t[1], t[2], scale)
    rtol = RTOL_OF_TERMS + fa.logit_rtol(t[0].float(), t[1].float(), scale)
    return [2 * rtol * s.numpy() for s in fa.term_scales(*t[:3], t[3], lse, scale)]


def _assert_within(got, want, tols, names=("o", "dq", "dk", "dv")):
    for name, g, w_, tol in zip(names, got, want, tols):
        g = np.asarray(g)
        assert g.shape == w_.shape and np.isfinite(g).all(), name
        ratio = (np.abs(g - w_) / (tol + 1e-30)).max()
        assert ratio <= 1.0, f"{name}: {ratio:.3f} of the tolerance"


@pytest.mark.parametrize("B, L, H, D", [(2, 128, 2, 128), (1, 256, 1, 128)],
                         ids=["b2_l128_h2", "b1_l256_h1"])
def test_matches_the_pallas_flash_kernel(B, L, H, D):
    """o, dq, dk, dv of the port (plain forward, FlashAttentionFn backward)
    against JAX's Pallas TPU flash kernel itself, in interpret mode, at the
    shapes its eligibility rule takes (L % 128 = 0, D % 128 = 0)."""
    q, k, v, w = _inputs(B, L, H, D, seed=L)
    scale = 1.0 / math.sqrt(D)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_g = _jax(jax_attention._pallas_flash_attention, q, k, v, w, scale)
    o, grads = _port(q, k, v, w)
    _assert_within((o,) + grads, (want_o,) + want_g, _tolerances(q, k, v, w))


@pytest.mark.parametrize("B, L, H, D", [(2, 77, 3, 40), (1, 1, 2, 8), (3, 130, 1, 16),
                                        (1, 64, 1, 128)],
                         ids=["ragged_d40", "one_step", "ragged_past_a_tile", "l64_d128"])
def test_matches_xla_attention_at_ragged_shapes(B, L, H, D):
    """The same against ``_xla_causal_attention`` (the reference's oracle)
    at lengths and head dims the Pallas kernel does not take."""
    q, k, v, w = _inputs(B, L, H, D, seed=B * L + D)
    want_o, want_g = _jax(jax_attention._xla_causal_attention, q, k, v, w, 1.0 / math.sqrt(D))
    o, grads = _port(q, k, v, w)
    _assert_within((o,) + grads, (want_o,) + want_g, _tolerances(q, k, v, w))


@pytest.mark.parametrize("B, L, H, D", [(2, 77, 3, 40), (2, 128, 1, 128)],
                         ids=["ragged_d40", "l128_d128"])
def test_float32_is_within_its_tolerance_of_float64(B, L, H, D):
    """The float32 port against the float64 port (one RTOL·Σ|terms|: the
    exact value is the float64 one); the check is not vacuous: the float32
    errors are nonzero."""
    q, k, v, w = _inputs(B, L, H, D, seed=7)
    o32, g32 = _port(q, k, v, w)
    o64, g64 = _port(q, k, v, w, dtype=torch.float64)
    tols = [t / 2 for t in _tolerances(q, k, v, w)]
    _assert_within((o32,) + g32, tuple(a.numpy() for a in (o64,) + g64), tols)
    assert max((a.double() - b).abs().max().item() for a, b in zip((o32,) + g32, (o64,) + g64)) > 0


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """The written-out dK/dV and dQ (from the saved lse and di) against
    autograd through the materialised forward, in float64 (1e-12)."""
    q, k, v, w = (torch.tensor(a, dtype=torch.float64) for a in _inputs(2, 50, 2, 24, seed=3))
    scale = 0.3
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    fa.xla_causal_attention(*leaves, scale).backward(w)
    o, lse = fa.flash_attention_plain(q, k, v, scale)
    di = fa.attention_di(o, w)
    dk, dv = fa.flash_attention_bwd_dkv_plain(q, k, v, w, lse, di, scale)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, w, lse, di, scale)
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=1e-12)
    torch.testing.assert_close(lse, torch.logsumexp(
        (torch.einsum("bthd,bshd->bhts", q, k) * scale).masked_fill(
            ~torch.ones(50, 50, dtype=torch.bool).tril(), float("-inf")), -1), rtol=0, atol=1e-12)
    assert di.shape == (2, 2, 50) and di.is_contiguous()


def test_masked_logits_never_reach_an_exp():
    """A key whose logits overflow float32 (|k| = 1e20 at the last step)
    sits above the diagonal of every earlier row: their outputs and every
    gradient stay finite and equal to those of the sequence cut before it."""
    q, k, v, w = (torch.tensor(a) for a in _inputs(1, 20, 1, 8, seed=4))
    k[:, -1] = 1e20
    t = [a.clone().requires_grad_() for a in (q, k, v)]
    o = fa.causal_softmax_attention(*t)
    (o[:, :-1] * w[:, :-1]).sum().backward()
    cut = [a[:, :-1].clone().requires_grad_() for a in (q, k, v)]
    o_cut = fa.causal_softmax_attention(*cut)
    (o_cut * w[:, :-1]).sum().backward()
    torch.testing.assert_close(o[:, :-1].detach(), o_cut.detach(), rtol=0, atol=0)
    for a, b in zip(t, cut):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad[:, :-1], b.grad, rtol=0, atol=1e-6)


def test_routing_and_the_contract():
    """CPU tensors take the plain versions (no launch counted); ``impl="xla"``
    is the materialised form under autograd; what the kernels do not take
    raises on every device; the kernel wrappers refuse CPU tensors."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(2, 16, 2, 8, seed=5))
    before = dict(LAUNCHES)
    o = fa.causal_softmax_attention(q, k, v)
    assert LAUNCHES == before
    torch.testing.assert_close(fa.causal_softmax_attention(q, k, v, impl="xla"), o,
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        fa.causal_softmax_attention(q, k, v, impl="ring")
    with pytest.raises(TypeError):
        fa.causal_softmax_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one shape"):
        fa.causal_softmax_attention(q, k, v[..., :4])  # Dv != Dk: the config's xla choice
    big = torch.zeros(1, 4, 1, 136)
    with pytest.raises(ValueError, match="head dim"):
        fa.causal_softmax_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        fa.causal_softmax_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    # views with batch, row and head strides (the Wqkv split) are taken as they are
    qkv = torch.randn(2, 16, 3 * 16 + 5)
    views = [qkv[..., i * 16:(i + 1) * 16].reshape(2, 16, 2, 8) for i in range(3)]
    torch.testing.assert_close(fa.causal_softmax_attention(*views),
                               fa.causal_softmax_attention(*(a.contiguous() for a in views)),
                               rtol=0, atol=0)
    lse = torch.zeros(2, 2, 16)
    for call in (lambda: fa.flash_attention_fwd_cuda(q, k, v, 0.5),
                 lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, q, lse, lse, 0.5),
                 lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse, 0.5)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
