"""The numerical design of the port's tensor-core kernels, emulated on the
CPU: the fused head's forward and its dh and dW/db kernels
(``tlie_tpu_torch/ops/csrc/fused_xent.cu``), the flash attention's
forward, dK/dV and dQ kernels (``flash_attention.cu``) and the decay attention's
forward, bwd_i and bwd_j (``decay_attention.cu``).

The kernels run their products on the tensor cores in TF32, with each
operand split x = big + small (big = TF32(x), small = TF32(x − big), rounded
to nearest with ties away from zero) and each product taken as
small·big + big·small + big·big (``tf32_mma.cuh``).  The head's logits are
summed 32 deep at a time before a float32 add, its second product one
128-row vocabulary (or row) tile at a time; the flash forward sums S = q kᵀ
32 deep and P v over one 64-row j tile at a time, with the online rescale;
the flash dK/dV and dQ kernels and the decay attention sum every product 8
deep (one m16n8k8 step) before its float32 add.
Here the same split and the same partial sums run in float32 on the CPU,
from numpy inputs made from a seed, and the result is held to the float64
plain version under the tolerance the card holds the kernels to
(``chip_smoke.py``, ``tests/test_torch_kernels_gpu.py``):

* the head's gradients: XENT_RTOL + √D·2⁻²⁴·Z of the sum of each element's
  terms' magnitudes, with Z = max‖h_m‖·max‖W_v‖ + max|b|;
* the head's forward: lse within XENT_RTOL relative, the batch's loss sum
  within XENT_RTOL relative, and each row's loss within XENT_RTOL of
  |lse| + |picked logit|;
* the flash attention: o, dq, dk and dv within ATTN_RTOL + ``logit_rtol`` of the
  sum of their terms' magnitudes, lse within the same fraction of
  max(1, |lse|);
* the decay attention: y, dC, dcs_i, dB, dxdt and dcs_j within SSD_RTOL of
  the sum of each element's terms' magnitudes
  (``decay_attention.term_scales``).

A single TF32 product fails each, so the tests are not vacuous.  The
emulation rounds sums in float32 where the tensor cores may truncate; the
card tests hold the kernels themselves.
"""

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tlie_tpu_torch.ops import attention as fa
from tlie_tpu_torch.ops import decay_attention as da
from tlie_tpu_torch.ops import fused_xent as fx

torch.set_num_threads(1)
XENT_RTOL = 1e-5
ATTN_RTOL = 1e-5
F32_UNIT = 2.0 ** -24
KQ, KBK = 128, 32  # the head's tile of the streamed operand and its logits' depth step
KT, KSK = 64, 32   # the flash forward's tile edge (rows of i and j) and its S depth step
SSD_RTOL = 1e-5
KFRESH = 8         # the fresh-sum depth of dK/dV, dQ and the decay attention (tile edge KT)
CSRC = Path(fx.__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fused_xent.cu"


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
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], depth):
        k = slice(k0, k0 + depth)
        part = ab[..., k] @ bb[..., k, :]
        if products == 3:
            part = as_[..., k] @ bb[..., k, :] + ab[..., k] @ bs[..., k, :] + part
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
    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    shared = (CSRC / "tf32_mma.cuh").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in shared
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in shared
    head = SOURCE.read_text()
    assert '#include "tf32_mma.cuh"' in head
    assert const(head, "kQ") == KQ and const(head, "kBK") == KBK
    assert "logits_tile_tc<kPRows>(h, p0, M, w, q0, V, D, vec, buf, x)" in head  # the forward
    flash = (CSRC / "flash_attention.cu").read_text()
    assert '#include "tf32_mma.cuh"' in flash
    assert const(shared, "kT") == KT and const(flash, "kSK") == KSK
    assert flash.count("mma_step_3xtf32<1, 8>") == 2  # the forward's S and P v
    # dK/dV: Sᵀ and dPᵀ in one call both warp groups run, dv and dk in
    # another; dQ: S and dP in one, dq in another; each a run of KFRESH-deep
    # fresh sums (tf32_mma.cuh)
    assert const(shared, "kFresh") == KFRESH
    assert flash.count("product_nt32<kTLd>(") == 2 and flash.count("product_64<kDLd, kTLd>(") == 2
    assert "flash_attention_bwd_dq_kernel" in flash and "tile_nt(" not in flash


@pytest.mark.parametrize("grad", ["dh", "dw", "db"])
@pytest.mark.parametrize("D", [512, 1024])
def test_three_product_split_holds_the_float32_tolerance(D, grad):
    assert _case(D, 3)[grad] <= 1.0


@pytest.mark.parametrize("D", [512, 1024])
def test_a_single_tf32_product_fails_it(D):
    ratios = _case(D, 1)
    assert ratios["dh"] > 1.0 and ratios["dw"] > 1.0


# -- the head's forward ------------------------------------------------------------


def emulated_forward(h, w, b, labels, products=3):
    """(loss per row, lse) as the forward kernel computes them: each 128-wide
    vocabulary tile's logits (``mm_tf32``, KBK deep) plus the bias, folded
    into a running max and sum-exp per row, the label's logit picked."""
    M, V = h.shape[0], w.shape[1]
    weight = w.t()
    m, s, picked = torch.full((M,), -1e30), torch.zeros(M), torch.zeros(M)
    for v0 in range(0, V, KQ):
        v = torch.arange(v0, min(v0 + KQ, V))
        x = mm_tf32(h, weight[v].t(), KBK, products) + b[v]
        m_new = torch.maximum(m, x.max(1).values)
        s = s * torch.exp(m - m_new) + torch.exp(x - m_new[:, None]).sum(1)
        m = m_new
        picked += (x * (labels[:, None] == v)).sum(1)
    lse = m + torch.log(s)
    return torch.where(labels != fx.IGNORE, lse - picked, torch.zeros_like(lse)), lse


@lru_cache(maxsize=None)
def _fwd_case(D, products):
    """Each forward check's worst error over its tolerance, against float64.
    V 2001 leaves a ragged last vocabulary tile of 81."""
    h, w, b, labels = _inputs(64, D, 2001, seed=D + 1)
    loss, lse = emulated_forward(h, w, b, labels, products)
    loss64, lse64 = fx.fused_xent_fwd_plain(h.double(), w.double(), b.double(), labels)
    return {
        "lse": ((lse.double() - lse64).abs() / (XENT_RTOL * lse64.abs())).max().item(),
        "loss_sum": abs(loss.double().sum() - loss64.sum()).item()
        / (XENT_RTOL * abs(loss64.sum().item())),
        "loss_rows": ((loss.double() - loss64).abs()
                      / (XENT_RTOL * fx.loss_term_scales(loss64, lse64))).max().item(),
    }


@pytest.mark.parametrize("check", ["lse", "loss_sum", "loss_rows"])
@pytest.mark.parametrize("D", [512, 1024, 100])
def test_forward_three_product_split_holds_the_float32_tolerance(D, check):
    assert _fwd_case(D, 3)[check] <= 1.0


@pytest.mark.parametrize("D", [512, 1024, 100])
def test_forward_single_tf32_product_fails_it(D):
    """One TF32 product rounds each logit by about 2⁻¹¹ of its terms.  lse is
    a softmax-weighted mean of the logits and the loss sum a sum over rows,
    so their errors, random in sign, average out and the lse and loss-sum
    checks alone would pass it at some widths; each row's picked logit
    carries its error undamped, and the per-row loss check fails it."""
    assert _fwd_case(D, 1)["loss_rows"] > 1.0


# -- the flash attention's forward and dK/dV ---------------------------------------


def emulated_flash_forward(q, k, v, scale, products=3):
    """(o, lse) as the forward kernel computes them: for each 64-row i tile,
    the j tiles j ≤ i with S = q kᵀ (``mm_tf32``, KSK deep) times scale, the
    online softmax (rescaling o by exp(m_old − m_new)), and P v summed over
    the tile's 64 j before the float32 add.  q, k, v (B, L, H, D)."""
    B, L, H, D = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, L, D)
    o = torch.zeros(B, H, L, D)
    lse = torch.zeros(B, H, L)
    for i0 in range(0, L, KT):
        i = torch.arange(i0, min(i0 + KT, L))
        m = torch.full((B, H, len(i)), float("-inf"))
        acc, l = torch.zeros(B, H, len(i), D), torch.zeros(B, H, len(i))
        for j0 in range(0, i0 + 1, KT):
            j = torch.arange(j0, min(j0 + KT, L))
            s = mm_tf32(qh[:, :, i], kh[:, :, j].transpose(-1, -2), KSK, products) * scale
            valid = j[None, :] <= i[:, None]
            m_new = torch.maximum(m, s.masked_fill(~valid, float("-inf")).amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros(()))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + mm_tf32(p, vh[:, :, j], KT, products)
            m = m_new
        o[:, :, i] = acc / l[..., None]
        lse[:, :, i] = m + torch.log(l)
    return o.transpose(1, 2), lse


@lru_cache(maxsize=None)
def _flash_case(D, products):
    """o's and lse's worst errors over their tolerances, against float64; L
    200 is not a multiple of the 64-row tile."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 200, 2, D)).astype(np.float32))
               for _ in range(3))
    scale = D ** -0.5
    o, lse = emulated_flash_forward(q, k, v, scale, products)
    o64, lse64 = fa.flash_attention_plain(q.double(), k.double(), v.double(), scale)
    rtol = ATTN_RTOL + fa.logit_rtol(q, k, scale)
    o_scale = fa.term_scales(q.double(), k.double(), v.double(), v.double(), lse64, scale)[0]
    lse_tol = rtol * lse64.abs().clamp_min(1.0)
    return {"o": ((o.double() - o64).abs() / (rtol * o_scale + 1e-300)).max().item(),
            "lse": ((lse.double() - lse64).abs() / lse_tol).max().item()}


@pytest.mark.parametrize("out", ["o", "lse"])
@pytest.mark.parametrize("D", [64, 100, 128])
def test_flash_forward_three_product_split_holds_the_float32_tolerance(D, out):
    assert _flash_case(D, 3)[out] <= 1.0


@pytest.mark.parametrize("D", [64, 100, 128])
def test_flash_forward_single_tf32_product_fails_it(D):
    """A row whose first tile holds few j (row 0 has o = v_0) takes v's TF32
    rounding, 2⁻¹² of |v|, nearly undamped, and each logit's rounding, far
    above ``logit_rtol``, reaches lse: both fail."""
    ratios = _flash_case(D, 1)
    assert ratios["o"] > 1.0 and ratios["lse"] > 1.0


def emulated_flash_bwd_dkv(q, k, v, do, lse, di, scale, products=3):
    """(dk, dv) as the dK/dV kernel computes them: for each 64-row j tile, the
    i tiles i ≥ j with Sᵀ = k_j q_iᵀ and dPᵀ = v_j do_iᵀ (``mm_tf32``, KFRESH
    deep), Pᵀ = exp(scale·Sᵀ − lse_i) where j ≤ i, dSᵀ = Pᵀ ⊙ (dPᵀ − di_i),
    then dv += Pᵀ do_i and dk += dSᵀ q_i, also KFRESH deep; dk times scale
    at the end.  q, k, v, do (B, L, H, D); lse, di (B, H, L)."""
    B, L, H, D = q.shape
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))  # (B, H, L, D)
    dk, dv = torch.zeros(B, H, L, D), torch.zeros(B, H, L, D)
    for j0 in range(0, L, KT):
        j = torch.arange(j0, min(j0 + KT, L))
        acc_k, acc_v = torch.zeros(B, H, len(j), D), torch.zeros(B, H, len(j), D)
        for i0 in range(j0, L, KT):
            i = torch.arange(i0, min(i0 + KT, L))
            st = mm_tf32(kh[:, :, j], qh[:, :, i].transpose(-1, -2), KFRESH, products)
            valid = j[:, None] <= i[None, :]
            pt = torch.where(valid, torch.exp(st * scale - lse[:, :, None, i]), torch.zeros(()))
            dpt = mm_tf32(vh[:, :, j], doh[:, :, i].transpose(-1, -2), KFRESH, products)
            dst = pt * (dpt - di[:, :, None, i])
            acc_v += mm_tf32(pt, doh[:, :, i], KFRESH, products)
            acc_k += mm_tf32(dst, qh[:, :, i], KFRESH, products)
        dk[:, :, j], dv[:, :, j] = acc_k * scale, acc_v
    return dk.transpose(1, 2), dv.transpose(1, 2)


@lru_cache(maxsize=None)
def _flash_dkv_case(D, products):
    """dk's and dv's worst errors over their tolerances, against float64, on
    the forward case's q, k, v (L 200) and a cotangent; the emulation gets
    lse and di from the float32 plain forward, as the kernel does."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 200, 2, D)).astype(np.float32))
               for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((2, 200, 2, D)).astype(np.float32))
    scale = D ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale)
    got = emulated_flash_bwd_dkv(q, k, v, do, lse, fa.attention_di(o, do), scale, products)
    ref = tuple(t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_attention_plain(*ref[:3], scale)
    want = fa.flash_attention_bwd_dkv_plain(*ref, lse64, fa.attention_di(o64, ref[3]), scale)
    rtol = ATTN_RTOL + fa.logit_rtol(q, k, scale)
    scales = fa.term_scales(*ref, lse64, scale)[2:]
    return {name: ((g.double() - w).abs() / (rtol * sc + 1e-300)).max().item()
            for name, g, w, sc in zip(("dk", "dv"), got, want, scales)}


@pytest.mark.parametrize("out", ["dk", "dv"])
@pytest.mark.parametrize("D", [64, 100, 128])
def test_flash_dkv_three_product_split_holds_the_float32_tolerance(D, out):
    assert _flash_dkv_case(D, 3)[out] <= 1.0


@pytest.mark.parametrize("D", [64, 100, 128])
def test_flash_dkv_single_tf32_product_fails_it(D):
    """One TF32 product rounds each operand by up to 2⁻¹¹ of itself: a j row
    near the end, whose dk and dv sum few i, keeps that error nearly
    undamped, far above ATTN_RTOL + ``logit_rtol``."""
    ratios = _flash_dkv_case(D, 1)
    assert ratios["dk"] > 1.0 and ratios["dv"] > 1.0, ratios


def emulated_flash_bwd_dq(q, k, v, do, lse, di, scale, products=3):
    """dq as the dQ kernel computes it: for each 64-row i tile, the j tiles
    j ≤ i with S = q_i k_jᵀ and dP = do_i v_jᵀ (``mm_tf32``, KFRESH deep), P =
    exp(scale·S − lse_i) where j ≤ i, dS = P ⊙ (dP − di_i), then dq += dS k_j,
    also KFRESH deep; dq times scale at the end.  q, k, v, do (B, L, H, D);
    lse, di (B, H, L)."""
    B, L, H, D = q.shape
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))  # (B, H, L, D)
    dq = torch.zeros(B, H, L, D)
    for i0 in range(0, L, KT):
        i = torch.arange(i0, min(i0 + KT, L))
        acc = torch.zeros(B, H, len(i), D)
        for j0 in range(0, i0 + 1, KT):
            j = torch.arange(j0, min(j0 + KT, L))
            s = mm_tf32(qh[:, :, i], kh[:, :, j].transpose(-1, -2), KFRESH, products)
            valid = j[None, :] <= i[:, None]
            p = torch.where(valid, torch.exp(s * scale - lse[:, :, i, None]), torch.zeros(()))
            dp = mm_tf32(doh[:, :, i], vh[:, :, j].transpose(-1, -2), KFRESH, products)
            ds = p * (dp - di[:, :, i, None])
            acc += mm_tf32(ds, kh[:, :, j], KFRESH, products)
        dq[:, :, i] = acc * scale
    return dq.transpose(1, 2)


@lru_cache(maxsize=None)
def _flash_dq_case(D, products):
    """dq's worst error over its tolerance, against float64, on the dK/dV
    case's inputs (L 200); lse and di from the float32 plain forward, as the
    kernel gets them."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 200, 2, D)).astype(np.float32))
               for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((2, 200, 2, D)).astype(np.float32))
    scale = D ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, scale)
    got = emulated_flash_bwd_dq(q, k, v, do, lse, fa.attention_di(o, do), scale, products)
    ref = tuple(t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_attention_plain(*ref[:3], scale)
    want = fa.flash_attention_bwd_dq_plain(*ref, lse64, fa.attention_di(o64, ref[3]), scale)
    rtol = ATTN_RTOL + fa.logit_rtol(q, k, scale)
    sc = fa.term_scales(*ref, lse64, scale)[1]
    return ((got.double() - want).abs() / (rtol * sc + 1e-300)).max().item()


@pytest.mark.parametrize("D", [64, 100, 128])
def test_flash_dq_three_product_split_holds_the_float32_tolerance(D):
    assert _flash_dq_case(D, 3) <= 1.0


@pytest.mark.parametrize("D", [64, 100, 128])
def test_flash_dq_single_tf32_product_fails_it(D):
    """As for dK/dV: row 0's dq is one term, dS_00 k_0, and the first rows sum
    few, so each operand's TF32 rounding stays nearly undamped."""
    assert _flash_dq_case(D, 1) > 1.0


# -- the decay attention's forward, bwd_i and bwd_j --------------------------------


def _decay_tile(cs, i, j):
    """exp(cs_i − cs_j) where j ≤ i, else 0, for rows i and columns j:
    (BG, Hg, len(i), len(j)), the difference taken before the exp."""
    causal = j[None, :] <= i[:, None]
    seg = (cs[..., i, None] - cs[..., None, j]).masked_fill(~causal, 0.0)
    return torch.where(causal, torch.exp(seg), torch.zeros(()))


def emulated_decay_forward(C, B, cs, x, products=3):
    """y as the forward kernel computes it: for each 64-row i tile, the j
    tiles j ≤ i with S = C_i B_jᵀ (``mm_tf32``, KFRESH deep), times the
    decay, then y += S x_j, also KFRESH deep."""
    BG, Hg, Q, P = x.shape
    y = torch.zeros(BG, Hg, Q, P)
    for i0 in range(0, Q, KT):
        i = torch.arange(i0, min(i0 + KT, Q))
        acc = torch.zeros(BG, Hg, len(i), P)
        for j0 in range(0, i0 + 1, KT):
            j = torch.arange(j0, min(j0 + KT, Q))
            s = mm_tf32(C[:, i], B[:, j].transpose(1, 2), KFRESH, products)
            acc += mm_tf32(s[:, None] * _decay_tile(cs, i, j), x[:, :, j], KFRESH, products)
        y[:, :, i] = acc
    return y


def emulated_decay_bwd_j(C, B, cs, x, dy, products=3):
    """(dB, dxdt, dcs_j) as bwd_j computes them: for each 64-row j tile, the i
    tiles i ≥ j with CBᵀ = B_j C_iᵀ and each head's dSᵀ = x_j dy_iᵀ, Dh =
    dSᵀ ⊙ decayᵀ, dcs_j −= rowsum(Dh ⊙ CBᵀ), dx_h += (CBᵀ ⊙ decayᵀ) dy_i and
    dB += (Σ_h Dh) C_i, every product KFRESH deep."""
    BG, Hg, Q, P = x.shape
    dB, dx, dcs = torch.zeros(BG, Q, C.shape[2]), torch.zeros_like(x), torch.zeros(BG, Hg, Q)
    for j0 in range(0, Q, KT):
        j = torch.arange(j0, min(j0 + KT, Q))
        for i0 in range(j0, Q, KT):
            i = torch.arange(i0, min(i0 + KT, Q))
            cbt = mm_tf32(B[:, j], C[:, i].transpose(1, 2), KFRESH, products)
            dect = _decay_tile(cs, i, j).transpose(-1, -2)
            dh = mm_tf32(x[:, :, j], dy[:, :, i].transpose(-1, -2), KFRESH, products) * dect
            dcs[:, :, j] -= (dh * cbt[:, None]).sum(-1)
            dcbt = dh[:, 0]
            for h in range(1, Hg):
                dcbt = dcbt + dh[:, h]
            dx[:, :, j] += mm_tf32(cbt[:, None] * dect, dy[:, :, i], KFRESH, products)
            dB[:, j] += mm_tf32(dcbt, C[:, i], KFRESH, products)
    return dB, dx, dcs


def emulated_decay_bwd_i(C, B, cs, x, dy, products=3):
    """(dC, dcs_i) as bwd_i computes them: for each 64-row i tile, the j
    tiles j ≤ i with CB = C_i B_jᵀ once and each head's dS = dy_i x_jᵀ, Dh =
    dS ⊙ decay, dcs_i += rowsum(Dh ⊙ CB) and dC += (Σ_h Dh) B_j, every
    product KFRESH deep."""
    BG, Hg, Q, P = x.shape
    dC, dcs = torch.zeros(BG, Q, C.shape[2]), torch.zeros(BG, Hg, Q)
    for i0 in range(0, Q, KT):
        i = torch.arange(i0, min(i0 + KT, Q))
        for j0 in range(0, i0 + 1, KT):
            j = torch.arange(j0, min(j0 + KT, Q))
            cb = mm_tf32(C[:, i], B[:, j].transpose(1, 2), KFRESH, products)
            dh = mm_tf32(dy[:, :, i], x[:, :, j].transpose(-1, -2), KFRESH, products)
            dh = dh * _decay_tile(cs, i, j)
            dcs[:, :, i] += (dh * cb[:, None]).sum(-1)
            dcb = dh[:, 0]
            for h in range(1, Hg):
                dcb = dcb + dh[:, h]
            dC[:, i] += mm_tf32(dcb, B[:, j], KFRESH, products)
    return dC, dcs


def _decay_inputs(N, Hg, P):
    """C, B, cs, xdt and dy at BG 2, Q 200 (not a multiple of the 64-row
    tile); cs is the cumsum of dt·A with dt in [0, 0.1) and A in (−16, −1],
    as the card's inputs are drawn (``chip_smoke.decay_inputs``)."""
    rng = np.random.default_rng(100 * N + 10 * Hg + P)
    BG, Q = 2, 200
    C, B = (torch.from_numpy(rng.standard_normal((BG, Q, N)).astype(np.float32))
            for _ in range(2))
    dt = 0.1 * rng.random((BG, Hg, Q))
    A = -1 - 15 * rng.random((1, Hg, 1))
    cs = torch.from_numpy(np.cumsum(dt * A, -1).astype(np.float32))
    x, dy = (torch.from_numpy(rng.standard_normal((BG, Hg, Q, P)).astype(np.float32))
             for _ in range(2))
    return C, B, cs, x, dy


@lru_cache(maxsize=None)
def _decay_case(N, Hg, P, products):
    """y's, dB's, dxdt's and dcs_j's worst errors over their tolerances,
    against float64, on ``_decay_inputs``."""
    C, B, cs, x, dy = _decay_inputs(N, Hg, P)
    got = (emulated_decay_forward(C, B, cs, x, products),) + emulated_decay_bwd_j(
        C, B, cs, x, dy, products)
    ref = tuple(t.double() for t in (C, B, cs, x, dy))
    want = (da.decay_attention_plain(*ref[:4]),) + da.decay_attention_bwd_j_plain(*ref)
    y_sc, _, _, dB_sc, dx_sc, dcs_sc = da.term_scales(*ref)
    return {name: ((g.double() - w).abs() / (SSD_RTOL * sc + 1e-300)).max().item()
            for name, g, w, sc in zip(("y", "dB", "dxdt", "dcs_j"), got, want,
                                      (y_sc, dB_sc, dx_sc, dcs_sc))}


@lru_cache(maxsize=None)
def _decay_bwd_i_case(N, Hg, P, products):
    """dC's and dcs_i's worst errors over their tolerances, against float64,
    on ``_decay_inputs``."""
    C, B, cs, x, dy = _decay_inputs(N, Hg, P)
    got = emulated_decay_bwd_i(C, B, cs, x, dy, products)
    ref = tuple(t.double() for t in (C, B, cs, x, dy))
    want = da.decay_attention_bwd_i_plain(*ref)
    scales = da.term_scales(*ref)[1:3]
    return {name: ((g.double() - w).abs() / (SSD_RTOL * sc + 1e-300)).max().item()
            for name, g, w, sc in zip(("dC", "dcs_i"), got, want, scales)}


DECAY_SHAPES = [(40, 3, 33), (128, 1, 64), (128, 3, 33), (40, 1, 64)]  # (N, Hg, P)


@pytest.mark.parametrize("out", ["y", "dB", "dxdt", "dcs_j"])
@pytest.mark.parametrize("N, Hg, P", DECAY_SHAPES)
def test_decay_three_product_split_holds_the_float32_tolerance(N, Hg, P, out):
    assert _decay_case(N, Hg, P, 3)[out] <= 1.0


@pytest.mark.parametrize("N, Hg, P", DECAY_SHAPES)
def test_decay_single_tf32_product_fails_it(N, Hg, P):
    """One TF32 product rounds each operand by up to 2⁻¹¹ of itself, about
    50 times SSD_RTOL: an element whose terms are few or share a sign keeps
    much of that error, and every output fails (dcs_j, whose terms' signs are
    random over a whole row of i, by the least margin)."""
    ratios = _decay_case(N, Hg, P, 1)
    assert all(ratios[out] > 1.0 for out in ("y", "dB", "dxdt", "dcs_j")), ratios


@pytest.mark.parametrize("out", ["dC", "dcs_i"])
@pytest.mark.parametrize("N, Hg, P", DECAY_SHAPES)
def test_decay_bwd_i_three_product_split_holds_the_float32_tolerance(N, Hg, P, out):
    assert _decay_bwd_i_case(N, Hg, P, 3)[out] <= 1.0


@pytest.mark.parametrize("N, Hg, P", DECAY_SHAPES)
def test_decay_bwd_i_single_tf32_product_fails_it(N, Hg, P):
    """As for bwd_j: each operand's TF32 rounding, about 50 times SSD_RTOL,
    survives in the elements with few terms (the first rows of i)."""
    ratios = _decay_bwd_i_case(N, Hg, P, 1)
    assert ratios["dC"] > 1.0 and ratios["dcs_i"] > 1.0, ratios


def test_decay_emulation_follows_the_kernel_source():
    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    src = (CSRC / "decay_attention.cu").read_text()
    shared = (CSRC / "tf32_mma.cuh").read_text()
    assert '#include "tf32_mma.cuh"' in src
    assert const(shared, "kT") == KT and const(shared, "kFresh") == KFRESH
    # every product is a run of fresh sums, each added in float32: the first
    # products (the forward's S, bwd_j's CBᵀ and dSᵀ, bwd_i's CB and dS: one
    # call in each kernel, both warp groups of a backward kernel run it) over
    # their depth steps, the second products (bwd_j's dB and dx, bwd_i's dC:
    # again one call each) over a tile's KT of j or i, in tf32_mma.cuh; the
    # forward's S x, over a tile's KT of j, in the kernel itself.  The
    # source holds the float32 kernels alone (the bfloat16 ones are
    # decay_attention_bf16.cu's, tests/test_torch_bf16_tiles.py)
    assert src.count("product_nt32<k") == 3
    assert src.count("product_64<kDLd, kTLd>(") == 2
    assert "__nv_bfloat16" not in src and "mma.sync.aligned.m16n8k16" not in src
    assert shared.count("for (int k0 = 0; k0 < kStep; k0 += kFresh) {") == 1
    assert shared.count("for (int k0 = 0; k0 < kT; k0 += kFresh) {") == 1
    assert src.count("for (int k0 = 0; k0 < kT; k0 += kFresh) {") == 1
    assert shared.count("for (int kk = k0; kk < k0 + kFresh; kk += 8)") == 2
    assert src.count("for (int kk = k0; kk < k0 + kFresh; kk += 8)") == 1
    assert shared.count("add_frags(acc, c);") == 2 and "add_frags(acc[hf], c);" in src
