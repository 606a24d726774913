"""The port's SSD ops against tlie_tpu's: the decay attention's plain version
(forward and every input gradient) against the Pallas kernel in interpret
mode, the chunked scan against tlie_tpu's and against both recurrent
oracles, the chunk choice, and the depthwise causal conv.

Inputs are made with numpy from a seed and handed to both packages; JAX runs
jitted at HIGHEST matmul precision (tests/conftest.py).  Tolerances are
stated where they are used.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.ops import pallas_ssd as jax_pallas_ssd
from tlie_tpu.ops import ssd as jax_ssd
from tlie_tpu.ops.conv import depthwise_causal_conv1d as jax_conv
from tlie_tpu_torch.ops import decay_attention as da
from tlie_tpu_torch.ops import ssd
from tlie_tpu_torch.ops.conv import depthwise_causal_conv1d

torch.set_num_threads(1)


def _decay_inputs(BG, Q, N, Hg, P, seed=0, a_max=16.0, dt_max=0.1):
    """C, B, cs, xdt, and a cotangent w: cs is the within-chunk cumsum of
    dt·A with A down to −a_max, so |cs| reaches dt_max·a_max·Q and entries
    above the diagonal have cs_i − cs_j far above 88 (exp overflows there)."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((BG, Q, N)).astype(np.float32)
    B = rng.standard_normal((BG, Q, N)).astype(np.float32)
    dt = rng.uniform(0.0, dt_max, (BG, Hg, Q))
    A = -rng.uniform(1.0, a_max, (1, Hg, 1))
    cs = np.cumsum(dt * A, axis=-1).astype(np.float32)
    x = rng.standard_normal((BG, Hg, Q, P)).astype(np.float32)
    w = rng.standard_normal((BG, Hg, Q, P)).astype(np.float32)
    return C, B, cs, x, w


def _jax_decay_attention(C, B, cs, x, w, monkeypatch):
    """y and the four input gradients of Σ y·w through tlie_tpu's Pallas
    kernel in interpret mode (``TLIE_SSD_INTRA=pallas``, as
    tests/test_ops_kernels.py runs it)."""
    monkeypatch.setenv("TLIE_SSD_INTRA", "pallas")
    BG, Hg, Q, P = x.shape
    assert jax_pallas_ssd.eligible(Q, C.shape[2], P, Hg)

    def loss(C, B, cs, x):
        y = jax_pallas_ssd.decay_attention(C, B, cs, x)
        return jnp.sum(y * w), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        C, B, cs, x)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("G, Hg", [(1, 1), (2, 1), (1, 4), (2, 4)],
                         ids=["G1-Hg1", "G2-Hg1", "G1-Hg4", "G2-Hg4"])
def test_plain_decay_attention_matches_pallas_kernel(G, Hg, monkeypatch):
    """y, dC, dB, dcs and dxdt of the plain version against the Pallas
    kernel, at the smallest shape its gate takes (Q 128, N 128, P 64), two
    examples of G groups each.  Each output within 1e-5 of its own max|·|
    (f32 sums of up to N + Q terms in other orders), dcs within 1e-5 of
    max|dcs_i| + max|dcs_j| of the float64 plain version (dcs is the
    difference of those two sums, which cancel)."""
    C, B, cs, x, w = _decay_inputs(2 * G, 128, 128, Hg, 64, seed=G * 10 + Hg)
    want_y, want_g = _jax_decay_attention(C, B, cs, x, w, monkeypatch)

    t = [torch.from_numpy(a).requires_grad_() for a in (C, B, cs, x)]
    y = da.decay_attention(*t)
    y.backward(torch.from_numpy(w))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0,
                               atol=1e-5 * np.abs(want_y).max())
    _, dcs_i, _, _, dcs_j = da.decay_attention_bwd_plain(
        *(torch.from_numpy(a).double() for a in (C, B, cs, x, w)))
    cs_scale = dcs_i.abs().max().item() + dcs_j.abs().max().item()
    for name, got, want in zip(("dC", "dB", "dcs", "dxdt"), t, want_g):
        scale = cs_scale if name == "dcs" else np.abs(want).max()
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """The written-out backward against autograd of the materialised
    forward, in float64 (1e-12 of each output's max)."""
    C, B, cs, x, w = (torch.from_numpy(a).double() for a in _decay_inputs(3, 37, 8, 3, 5))
    t = [a.clone().requires_grad_() for a in (C, B, cs, x)]
    grads = torch.autograd.grad(da.decay_attention_plain(*t), t, w)
    dC, dcs_i, dB, dxdt, dcs_j = da.decay_attention_bwd_plain(C, B, cs, x, w)
    for got, want in zip((dC, dB, dcs_i + dcs_j, dxdt), grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * want.abs().max().item())


def test_overflowing_segments_above_the_diagonal_stay_out_of_the_gradient():
    """cs_i − cs_j reaches hundreds above the diagonal, where exp gives inf;
    masking the segment before the exp keeps y and every gradient finite,
    where masking after it (0·inf) gives NaN."""
    C, B, cs, x, w = (torch.from_numpy(a) for a in _decay_inputs(2, 256, 16, 2, 8, a_max=16,
                                                                   dt_max=0.5))
    seg = cs[..., :, None] - cs[..., None, :]
    assert seg.max() > 100
    t = [a.clone().requires_grad_() for a in (C, B, cs, x)]
    y = da.decay_attention(*t)
    y.backward(w)
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(a.grad).all() for a in t)
    # the mask applied after the exp: its gradient multiplies 0 by inf
    cs_bad = cs.clone().requires_grad_()
    seg_bad = cs_bad[..., :, None] - cs_bad[..., None, :]
    torch.where(torch.ones(256, 256).tril().bool(), torch.exp(seg_bad), 0.0).sum().backward()
    assert torch.isnan(cs_bad.grad).any()


def test_decay_attention_refuses_what_it_does_not_take():
    C, B, cs, x, _ = (torch.from_numpy(a) for a in _decay_inputs(2, 16, 8, 2, 4))
    with pytest.raises(TypeError):
        da.decay_attention(C.double(), B, cs, x)
    with pytest.raises(ValueError):  # cs must be contiguous
        da.decay_attention(C, B, cs.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError):  # C's last dimension must be contiguous
        da.decay_attention(C.transpose(1, 2).contiguous().transpose(1, 2), B, cs, x)
    with pytest.raises(ValueError):
        da.decay_attention(C[:, :8], B, cs, x)
    # row-strided C and B (slices of a wider tensor) are taken as they are
    wide = torch.randn(2, 16, 20)
    y = da.decay_attention(wide[:, :, 3:11], B, cs, x)
    torch.testing.assert_close(y, da.decay_attention_plain(wide[:, :, 3:11].contiguous(), B, cs, x))
    # the kernels' wrappers take CUDA tensors only, never computing another way
    for fn, args in ((da.decay_attention_fwd_cuda, (C, B, cs, x)),
                     (da.decay_attention_bwd_i_cuda, (C, B, cs, x, x)),
                     (da.decay_attention_bwd_j_cuda, (C, B, cs, x, x))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_term_scales_bound_the_plain_outputs():
    """Σ|terms| is at least |output| elementwise (float64 plain version)."""
    C, B, cs, x, w = (torch.from_numpy(a).double() for a in _decay_inputs(2, 40, 8, 2, 6))
    y = da.decay_attention_plain(C, B, cs, x)
    outs = (y,) + da.decay_attention_bwd_plain(C, B, cs, x, w)
    for out, scale in zip(outs, da.term_scales(C, B, cs, x, w)):
        assert (out.abs() <= scale * (1 + 1e-12) + 1e-300).all()


# -- the chunked scan -----------------------------------------------------------

def _ssd_inputs(B, L, H, P, G, N, seed=0, with_h0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32) * 0.3
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


_SCAN_CASES = {
    # (B, L, H, P, G, N, chunk, h0, final, dt_limit)
    "one_chunk": (2, 64, 2, 8, 1, 16, 64, False, False, None),
    "one_chunk_groups": (2, 64, 4, 8, 2, 16, 64, False, False, None),
    "chunks": (2, 96, 4, 8, 2, 16, 32, False, False, None),
    "chunks_h0_final": (1, 64, 2, 4, 1, 8, 16, True, True, None),
    "one_chunk_final": (1, 32, 2, 4, 1, 8, 32, False, True, None),
    "ragged_chunk_dt_limit": (2, 48, 2, 4, 1, 8, 20, True, False, (0.05, 0.4)),
}


@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_chunked_scan_matches_jax_and_the_oracles(case):
    """y (and the final state) of the port's chunked scan against tlie_tpu's
    chunked scan at the same chunk (2e-5 of max|y|: f32, other summation
    orders), and against the port's and tlie_tpu's recurrent oracles (1e-4
    of max|y|: the oracles sum L steps one at a time)."""
    B, L, H, P, G, N, chunk, with_h0, final, dt_limit = _SCAN_CASES[case]
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(B, L, H, P, G, N, seed=L + H, with_h0=with_h0)
    static = dict(chunk_size=chunk, return_final_state=final, dt_limit=dt_limit)
    want = jax.jit(functools.partial(jax_ssd.ssd_chunked_scan, **static))(
        x, dt, A, Bm, Cm, D=D, initial_states=h0)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = ssd.ssd_chunked_scan(t(x), t(dt), t(A), t(Bm), t(Cm), chunk_size=chunk, D=t(D),
                               initial_states=t(h0), return_final_state=final,
                               dt_limit=dt_limit)
    if final:
        (got, got_h), (want, want_h) = got, want
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                                   atol=2e-5 * np.abs(want_h).max())
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * scale)
    oracle = ssd.ssd_recurrent_scan(t(x), t(dt), t(A), t(Bm), t(Cm), D=t(D),
                                    initial_states=t(h0), dt_limit=dt_limit)
    jax_oracle = jax.jit(functools.partial(jax_ssd.ssd_recurrent_scan, dt_limit=dt_limit))(
        x, dt, A, Bm, Cm, D, h0)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(jax_oracle), rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("chunk", [64, 16], ids=["one_chunk", "four_chunks"])
def test_chunked_scan_gradients_match_jax(chunk):
    """Gradients of Σ y·w in x, dt, A, B, C and D against tlie_tpu's
    chunked scan (its XLA path), per input within 1e-4 of its max|g|."""
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(2, 64, 4, 8, 2, 16, seed=5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(*args):
        return jnp.sum(jax_ssd.ssd_chunked_scan(*args[:5], chunk_size=chunk, D=args[5]) * w)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(x, dt, A, Bm, Cm, D)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm, D)]
    y = ssd.ssd_chunked_scan(*t[:5], chunk_size=chunk, D=t[5])
    (y * torch.from_numpy(w)).sum().backward()
    for name, got, g in zip(("x", "dt", "A", "B", "C", "D"), t, want):
        g = np.asarray(g)
        np.testing.assert_allclose(got.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                   err_msg=name)


@pytest.mark.parametrize("B, L, H", [(64, 512, 1), (8, 1024, 8), (32, 64, 1), (512, 1024, 16),
                                     (3, 96, 2), (1, 7, 1)])
def test_auto_chunk_matches_jax_on_the_cpu(B, L, H):
    assert ssd._budget_elements("cpu") == 75_000_000
    assert ssd._auto_chunk(B, L, H, "cpu") == jax_ssd._auto_chunk(B, L, H)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_tlie_ssd_budget_overrides_the_budget_as_in_jax(monkeypatch, device):
    """``TLIE_SSD_BUDGET`` (elements) wins over the device's budget in both
    packages (``tests/test_ops_kernels.py``'s case): at 1e6, B4 × L512 × H8
    needs 4·512·q·8 ≤ 1e6, so q = 32.  It is read before the device is
    asked, so the CUDA case runs without a card."""
    monkeypatch.setenv("TLIE_SSD_BUDGET", "1000000")
    assert ssd._budget_elements(device) == 1_000_000 == jax_ssd._budget_elements()
    assert ssd._auto_chunk(4, 512, 8, device) == 32 == jax_ssd._auto_chunk(4, 512, 8)
    monkeypatch.setenv("TLIE_SSD_BUDGET", "2.5e6")
    assert ssd._budget_elements(device) == 2_500_000 == jax_ssd._budget_elements()
    assert ssd._auto_chunk(4, 512, 8, device) == jax_ssd._auto_chunk(4, 512, 8) == 128


def test_largest_divisor_chunk_and_expand_groups_match_jax():
    for L, q in ((48, 20), (96, 64), (7, 4), (512, 512)):
        assert ssd._largest_divisor_chunk(L, q) == jax_ssd._largest_divisor_chunk(L, q)
    m = np.random.default_rng(0).standard_normal((2, 5, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(ssd._expand_groups(torch.from_numpy(m), 6).numpy(),
                                  np.asarray(jax_ssd._expand_groups(m, 6)))


# -- the depthwise causal conv --------------------------------------------------

@pytest.mark.parametrize("shape, K", [((2, 40, 24), 4), ((3, 2, 17, 5), 3), ((1, 8, 6), 1)])
def test_depthwise_causal_conv_matches_jax(shape, K):
    """The port's conv (weight in nn.Conv1d's (C, 1, K)) against tlie_tpu's
    (weight (K, C)), 1e-6 absolute (four-term f32 sums)."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((K, shape[-1])).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jax.jit(jax_conv)(x, w, b))
    got = depthwise_causal_conv1d(torch.from_numpy(x), torch.from_numpy(w.T[:, None, :].copy()),
                                  torch.from_numpy(b))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
