"""The numerical design of the fused head's backward kernels
(``tlie_tpu_torch/ops/csrc/fused_xent.cu``), emulated on the CPU.

The kernels run both products of dh and dW on the tensor cores in TF32, with
each operand split x = big + small (big = TF32(x), small = TF32(x − big),
rounded to nearest with ties away from zero) and each product taken as
small·big + big·small + big·big.  The logits are summed 32 deep at a time
before a float32 add, the second product one 128-row vocabulary (or row)
tile at a time.  Here the same split and the same partial sums run in
float32 on the CPU, from numpy inputs made from a seed, and the result is
held to the float64 plain version under the tolerance the card holds the
kernels to (``chip_smoke.py``, ``tests/test_torch_kernels_gpu.py``):
XENT_RTOL + √D·2⁻²⁴·Z of the sum of each element's terms' magnitudes, with
Z = max‖h_m‖·max‖W_v‖ + max|b|.  A single TF32 product fails it, so the test
is not vacuous.  The emulation rounds sums in float32 where the tensor cores
may truncate; the card tests hold the kernels themselves.
"""

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tlie_tpu_torch.ops import fused_xent as fx

torch.set_num_threads(1)
XENT_RTOL = 1e-5
F32_UNIT = 2.0 ** -24
KQ, KBK = 128, 32  # the kernels' tile of the streamed operand and their logits' depth step
SOURCE = Path(fx.__file__).resolve().parent / "csrc" / "fused_xent.cu"


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), as float32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, depth: int, products: int = 3) -> torch.Tensor:
    """a @ b in float32 from TF32 operands, ``depth`` deep at a time into a
    fresh sum that is then added to the result: three products of the split
    (small·big + big·small + big·big), or big·big alone."""
    (ab, as_), (bb, bs) = split(a), split(b)
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], depth):
        k = slice(k0, k0 + depth)
        part = ab[:, k] @ bb[k]
        if products == 3:
            part = as_[:, k] @ bb[k] + ab[:, k] @ bs[k] + part
        out += part
    return out


def emulated_grads(h, w, b, labels, lse, gscale, products=3):
    """(dh, dw in w's layout, db) as the kernels compute them: the logits of
    each 128-wide tile of the streamed operand, t = (softmax − onehot)·g on
    valid rows, then t times that tile, added to the float32 result."""
    M, V = h.shape[0], w.shape[1]
    weight = w.t()  # (V, D), the rows the kernels read
    valid = labels != fx.IGNORE
    dh = torch.zeros_like(h)
    for v0 in range(0, V, KQ):  # dh: P = rows of h, Q = vocabulary
        v = torch.arange(v0, min(v0 + KQ, V))
        logits = mm_tf32(h, weight[v].t(), KBK, products) + b[v]
        t = torch.exp(logits - lse[:, None]) - (labels[:, None] == v).float()
        t = t * (gscale * valid.float())[:, None]
        dh += mm_tf32(t, weight[v], KQ, products)
    dw_rows = torch.zeros_like(weight)
    db = torch.zeros(V)
    for m0 in range(0, M, KQ):  # dW, db: P = vocabulary, Q = rows of h
        m = torch.arange(m0, min(m0 + KQ, M))
        logits = mm_tf32(weight, h[m].t(), KBK, products) + b[:, None]
        t = torch.exp(logits - lse[m]) - (torch.arange(V)[:, None] == labels[m]).float()
        t = t * (gscale * valid[m].float())
        dw_rows += mm_tf32(t, h[m], KQ, products)
        db += t.sum(1)
    return dh, dw_rows.t(), db


def _inputs(M, D, V, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((M, D)).astype(np.float32)
    weight = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(V)).astype(np.float32)
    labels = rng.integers(0, V, M)
    labels[::7] = fx.IGNORE
    return (torch.from_numpy(h), torch.from_numpy(weight).t(), torch.from_numpy(b),
            torch.from_numpy(labels))


@lru_cache(maxsize=None)
def _case(D, products):
    """Each gradient's worst error over its tolerance, against float64."""
    h, w, b, labels = _inputs(64, D, 2000, seed=D)
    _, lse = fx.fused_xent_fwd_plain(h, w, b, labels)  # float32, as the kernels get it
    gscale = torch.full((1,), 1.0 / int((labels != fx.IGNORE).sum()))
    got = emulated_grads(h, w, b, labels, lse, gscale, products)
    h64, w64, b64 = h.double(), w.double(), b.double()
    _, lse64 = fx.fused_xent_fwd_plain(h64, w64, b64, labels)
    want = fx.fused_xent_bwd_plain(h64, w64, b64, labels, lse64, gscale.double())
    scales = fx.grad_term_scales(h64, w64, b64, labels, lse64, gscale.double())
    z = (h.norm(dim=1).max() * w.norm(dim=0).max() + b.abs().max()).item()
    rtol = XENT_RTOL + D ** 0.5 * F32_UNIT * z
    return {name: ((g.double() - x).abs() / (rtol * s + 1e-300)).max().item()
            for name, g, x, s in zip(("dh", "dw", "db"), got, want, scales)}


def test_rounding_is_to_nearest_with_ties_away_from_zero():
    one = 1.0 + 2.0 ** -11  # halfway between 1 and the next TF32 value
    x = torch.tensor([one, -one, one - 2.0 ** -23, 1.5 + 2.0 ** -12, -3.0e38])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.5, -3.0e38])
    got = tf32_rna(x)
    assert torch.equal(got[:4], want[:4])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()  # 10 mantissa bits kept
    assert torch.allclose(got[4:], want[4:], rtol=2.0 ** -11, atol=0)


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = split(x)
    assert torch.equal((x - big).double(), x.double() - big.double())  # exact in float32
    assert ((x.double() - big.double() - small.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


def test_emulation_follows_the_kernel_source():
    src = SOURCE.read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in src
    assert re.search(r"constexpr int kQ = (\d+);", src).group(1) == str(KQ)
    assert re.search(r"constexpr int kBK = (\d+);", src).group(1) == str(KBK)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src


@pytest.mark.parametrize("grad", ["dh", "dw", "db"])
@pytest.mark.parametrize("D", [512, 1024])
def test_three_product_split_holds_the_float32_tolerance(D, grad):
    assert _case(D, 3)[grad] <= 1.0


@pytest.mark.parametrize("D", [512, 1024])
def test_a_single_tf32_product_fails_it(D):
    ratios = _case(D, 1)
    assert ratios["dh"] > 1.0 and ratios["dw"] > 1.0
