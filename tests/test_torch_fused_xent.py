"""The port's fused decoder + softmax cross-entropy (the plain version, which
the CPU runs) against tlie_tpu's Pallas kernel in interpret mode, its
eligibility rule against the reference's, and the operands it refuses.

Inputs are made with numpy from a seed and handed to both packages; the
weight goes to the port as ``nn.Linear`` keeps it, (V, D), transposed as a
view.  Tolerances: the loss within 1e-5 relative and each gradient within
1e-6 absolute (float32 on the CPU; the logits sum 32 products, the
gradients up to 1,000 terms of size below 1/256).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tlie_tpu.ops import fused_xent as jax_fx
from tlie_tpu.training.steps import cross_entropy_loss as jax_ce
from tlie_tpu_torch.ops import fused_xent as fx
from tlie_tpu_torch.training import cross_entropy_loss

torch.set_num_threads(1)
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _inputs(M, D, V, seed, ignore_every=5):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((M, D)).astype(np.float32)
    w = (0.2 * rng.standard_normal((D, V))).astype(np.float32)
    b = (0.1 * rng.standard_normal(V)).astype(np.float32)
    y = rng.integers(0, V, M).astype(np.int32)
    if ignore_every:
        y[::ignore_every] = -100
    return h, w, b, y


def _port(h, w, b, y):
    """Torch leaves in the port's layout: w as the transpose of (V, D) rows."""
    th = torch.from_numpy(h).requires_grad_()
    weight = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    return th, weight, tb, torch.from_numpy(y).long()


@jax.jit
def _jax_value_and_grads(h, w, b, y):
    return jax.value_and_grad(jax_fx.fused_softmax_xent, argnums=(0, 1, 2))(h, w, b, y)


CASES = {"ragged_v1000": (256, 32, 1000, 5), "v300_below_a_tile": (256, 32, 300, 3),
         "all_ignored": (256, 32, 1000, 1)}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_matches_the_pallas_kernel(case):
    M, D, V, every = CASES[case]
    h, w, b, y = _inputs(M, D, V, seed=len(case), ignore_every=every)
    with pltpu.force_tpu_interpret_mode():
        jloss, (jdh, jdw, jdb) = _jax_value_and_grads(*map(jnp.asarray, (h, w, b, y)))
    th, weight, tb, ty = _port(h, w, b, y)
    loss = fx.fused_softmax_xent(th, weight.t(), tb, ty)
    loss.backward()
    loss = loss.detach()
    if case == "all_ignored":
        assert float(loss) == float(jloss) == 0.0
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(weight.grad.numpy().T, np.asarray(jdw), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("V", [1000, 300])
def test_plain_matches_materialised_cross_entropy(V):
    """The same loss and gradients as the dense head: materialised logits
    through the port's masked CE, autograd for the backward."""
    h, w, b, y = _inputs(128, 16, V, seed=V)
    th, weight, tb, ty = _port(h, w, b, y)
    fx.fused_softmax_xent(th, weight.t(), tb, ty).backward()
    got = [t.grad.clone() for t in (th, weight, tb)]
    for t in (th, weight, tb):
        t.grad = None
    ref = cross_entropy_loss(th @ weight.t() + tb, ty)
    ref.backward()
    for g, t in zip(got, (th, weight, tb)):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=GRAD_ATOL)


def test_forward_rows_and_backward_pieces():
    """Per-row loss (0 on ignored rows) and lse of the plain forward against
    the reference's own ``_fwd`` in interpret mode, and the plain backward
    for a cotangent g against the VJP scaled by g."""
    h, w, b, y = _inputs(256, 32, 700, seed=9)
    with pltpu.force_tpu_interpret_mode():
        jloss_rows, jlse = jax.jit(jax_fx._fwd)(*map(jnp.asarray, (h, w, b, y)))
    th, weight, tb, ty = _port(h, w, b, y)
    with torch.no_grad():
        loss_rows, lse = fx.fused_xent_fwd_plain(th, weight.t(), tb, ty)
        n_valid = int((ty != -100).sum())
        g = torch.tensor([2.5 / n_valid])
        dh, dw, db = fx.fused_xent_bwd_plain(th, weight.t(), tb, ty, lse, g)
    np.testing.assert_allclose(loss_rows.numpy(), np.asarray(jloss_rows), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)
    assert bool((loss_rows[ty == -100] == 0).all())
    assert dw.shape == (32, 700) and dw.stride() == (1, 32)  # w's layout
    fx.fused_softmax_xent(th, weight.t(), tb, ty).mul(2.5).backward()
    for got, want in ((dh, th.grad), (dw, weight.grad.t()), (db, tb.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_ATOL)


def test_eligibility_and_row_tile_match_the_reference():
    for M in (0, 64, 128, 200, 256, 384, 512, 640, 1024, 3072, 8192, 32768):
        for D in (16, 512, 1024, 1025, 2048):
            for V in (1, 300, 512, 50257):
                assert fx.fused_xent_eligible(M, D, V) == jax_fx.fused_xent_eligible(M, D, V)
        try:
            want = jax_fx._pick_tm(M)
        except ValueError:
            with pytest.raises(ValueError, match="not tileable by 128"):
                fx._pick_tm(M)
        else:
            assert fx._pick_tm(M) == want


def test_refuses_bf16_and_other_layouts():
    """bf16 mixed with float32 operands (all three are float32 or all three
    bfloat16, as ``_fused_loss`` casts them), and every other layout."""
    h, w, b, y = _inputs(128, 16, 300, seed=1)
    th, weight, tb, ty = _port(h, w, b, y)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fx.fused_softmax_xent(th.bfloat16(), weight.t(), tb, ty)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fx.fused_softmax_xent(th, weight.t().bfloat16(), tb, ty)
    # a contiguous (D, V) weight would need a 103 MB copy at LM width: refused
    with pytest.raises(ValueError, match="transpose of a row-major"):
        fx.fused_softmax_xent(th, torch.from_numpy(w), tb, ty)
    with pytest.raises(ValueError, match="not tileable by 128"):
        fx.fused_softmax_xent(th[:100], weight.t(), tb, ty[:100])
    with pytest.raises(ValueError, match="D <= 1024"):
        big = torch.zeros(128, 1040)
        fx.fused_softmax_xent(big, torch.zeros(300, 1040).t(), tb, ty)
    # the kernels take CUDA tensors only: no route to the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        fx.fused_xent_fwd_cuda(th, weight.t(), tb, ty)


def test_forward_splits_cover_the_vocabulary():
    """Every split gets at least one 128-wide vocabulary tile, the splits
    cover the vocabulary, and with the kernel's row tile (64 rows of h,
    ``kFwdRows`` in the source) there are about 32 blocks per SM."""
    src = (Path(fx.__file__).resolve().parent / "csrc" / "fused_xent.cu").read_text()
    rows = int(re.search(r"constexpr int kFwdRows = (\d+);", src).group(1))
    assert rows == fx._KERNEL_ROWS == 64
    for M, V, sms in ((8192, 50257, 132), (128, 300, 132), (1024, 1000, 132), (32, 50257, 8)):
        splits = fx.forward_splits(M, V, sms)
        n_tiles = -(-V // 128)
        per = -(-n_tiles // splits)
        assert 1 <= splits <= n_tiles and (splits - 1) * per < n_tiles <= splits * per
    # the LM's shape: 128 row tiles x 33 splits of 12 vocabulary tiles, 4,224
    # blocks, 32 per SM of an H100
    assert fx.forward_splits(8192, 50257, 132) == 33
    assert -(-8192 // rows) * 33 == 32 * 132


def test_cross_entropy_of_the_port_matches_jax_on_ragged_logits():
    """The dense head the fused one replaces, on the same ignored rows."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 32, 301)).astype(np.float32)
    y = rng.integers(0, 301, (4, 32))
    y[:, ::3] = -100
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(y)))
    assert got == pytest.approx(float(jax_ce(jnp.asarray(logits), jnp.asarray(y))), rel=1e-6)
