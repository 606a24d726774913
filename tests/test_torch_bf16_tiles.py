"""The numerical design of the decay attention's bfloat16 kernels
(``tlie_decay_attention_*_bf16``, all three in
``tlie_tpu_torch/ops/csrc/decay_attention_bf16.cu``), emulated on the CPU.

On bfloat16 operands every product of the three kernels takes bfloat16
values, whose products are exact in float32, so each runs as one
``mma.sync.m16n8k16`` on bfloat16 fragments with float32 accumulators (in
place of the float32 kernels' three TF32 products), summed 16 deep
(``kFreshBf16``) into a fresh sum before a float32 add, over 64-row tiles of
i and j (``kT``).  The scores C·B·decay are rounded to bfloat16 before their
products with xdt (forward) and dy (bwd_j), and dCB = Σ_h dS·decay is rounded
to bfloat16 before its products with B (bwd_i) and C (bwd_j); dcs stays
float32 throughout.  Here the same tiles, fresh sums and rounding points run
in float32 on the CPU, from numpy inputs made from a seed, and the float32
sums (before the outputs' final rounding to bfloat16) are held to the same
algebra in float64 within 1e-5 of each element's sum of term magnitudes
(``decay_attention.term_scales``), the tolerance the card holds the float32
kernels to.  Leaving the scores or dCB unrounded fails it, so the test sees
the rounding points.  The tile and depth constants and the rounding calls
are read from ``decay_attention_bf16.cu``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tlie_tpu_torch.ops import decay_attention as da

torch.set_num_threads(1)
CSRC = Path(da.__file__).resolve().parent / "csrc"
SOURCE_BF16 = (CSRC / "decay_attention_bf16.cu").read_text()
SSD_RTOL = 1e-5


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


KT = _constant(SOURCE_BF16, "kT")
KFRESH = _constant(SOURCE_BF16, "kFreshBf16")


def test_the_source_is_what_the_emulation_follows():
    """One m16n8k16 bfloat16 product with float32 accumulators, fresh sums
    of 16 over 64-row tiles in all three kernels; the score rounded where
    the forward and bwd_j form it, dCB^T summed head after head and rounded
    after the last in bwd_j, as dCB in bwd_i, the outputs rounded once from
    their float32 sums."""
    assert (KT, KFRESH) == (64, 16)
    assert _constant((CSRC / "tf32_mma.cuh").read_text(), "kT") == KT
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in SOURCE_BF16
    # the forward: S = C.B * decay, rounded as it is packed into A fragments
    assert SOURCE_BF16.count(
        "? cb[2 * kk + u][2 * hh + e] * decay_exp(csi[c][hh] - csj[lj])") == 1
    assert SOURCE_BF16.count("a[0] = pack_bf16(s[0][0][0], s[0][0][1]);") == 1
    # bwd_j and bwd_i: Dh from one decay, dCB^T (dCB) summed head after head
    # from zero in the head loop and rounded once after it; bwd_j's S^T
    # rounded once
    assert SOURCE_BF16.count("const float dh = ds[n][2 * hh + e] * dec;") == 2
    assert SOURCE_BF16.count(
        "dcb[n][2 * hh + e] = h > 0 ? dcb[n][2 * hh + e] + dh : dh;") == 2
    assert SOURCE_BF16.count("for (int h = 0; h < Hg; ++h) {") == 2
    assert SOURCE_BF16.count("st2[e] = cb * dec;") == 1
    assert SOURCE_BF16.count("__floats2bfloat162_rn(st2[0], st2[1])") == 1
    assert SOURCE_BF16.count("__floats2bfloat162_rn(dcb[n][2 * hh], dcb[n][2 * hh + 1])") == 2
    assert SOURCE_BF16.count("yr[col] = __float2bfloat16_rn(acc[c][n][2 * hh + e]);") == 1
    assert SOURCE_BF16.count("out[lj * ld + col] = __float2bfloat16_rn(v[n][2 * hh + e]);") == 1
    assert SOURCE_BF16.count("constexpr int kT = 64;") == 1
    # bwd_i: dcs_i from Dh and CB in float32, dC rounded once from its float32 sums
    assert SOURCE_BF16.count("part = fmaf(dh, e ? cb2.y : cb2.x, part);") == 1
    assert SOURCE_BF16.count(
        "if (n0 + col < N) out[li * d.N + col] = __float2bfloat16_rn(v[n][2 * hh + e]);") == 1
    assert 'extern "C" int tlie_decay_attention_bwd_i_bf16(' in SOURCE_BF16


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32, KFRESH deep at a time into a fresh sum added to the
    result (the products of bfloat16 values are exact in float32)."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], KFRESH):
        out += a[..., k0:k0 + KFRESH] @ b[..., k0:k0 + KFRESH, :]
    return out


def _decay(cs, i0, j0, Q):
    """exp(cs_i − cs_j) for the (i, j) tile, 0 above the diagonal and past Q."""
    i = torch.arange(i0, min(i0 + KT, Q))
    j = torch.arange(j0, min(j0 + KT, Q))
    seg = cs[..., i, None] - cs[..., None, j]
    return torch.exp(seg.masked_fill(~(j[None, :] <= i[:, None]), float("-inf"))), i, j


def emulated(C, B, cs, x, dy, round_scores=True, round_dcb=True):
    """The three kernels' float32 sums, tile by tile: (y, dC, dcs_i, dB,
    dxdt, dcs_j) before y, dC, dB and dxdt are rounded to bfloat16."""
    rs = _bf16 if round_scores else (lambda t: t)  # noqa: E731
    rd = _bf16 if round_dcb else (lambda t: t)  # noqa: E731
    C, B, x, dy = (t.float() for t in (C, B, x, dy))
    BG, Hg, Q, P = x.shape
    y, dx = torch.zeros(BG, Hg, Q, P), torch.zeros(BG, Hg, Q, P)
    dC, dB = torch.zeros(C.shape), torch.zeros(B.shape)
    dcs_i, dcs_j = torch.zeros(BG, Hg, Q), torch.zeros(BG, Hg, Q)
    for i0 in range(0, Q, KT):
        for j0 in range(0, i0 + 1, KT):
            decay, i, j = _decay(cs, i0, j0, Q)
            cb = _mm16(C[:, i], B[:, j].transpose(1, 2))[:, None]  # (BG, 1, Ti, Tj)
            ds = _mm16(dy[:, :, i], x[:, :, j].transpose(2, 3))   # (BG, Hg, Ti, Tj)
            s = rs(cb * decay)
            dh = ds * decay
            dcb = dh[:, 0]
            for h in range(1, Hg):  # the heads in order, as the kernels add them
                dcb = dcb + dh[:, h]
            dcb = rd(dcb)
            y[:, :, i] += _mm16(s, x[:, :, j])
            dx[:, :, j] += _mm16(s.transpose(2, 3), dy[:, :, i])
            dC[:, i] += _mm16(dcb, B[:, j])
            dB[:, j] += _mm16(dcb.transpose(1, 2), C[:, i])
            dcs_i[:, :, i] += (dh * cb).sum(-1)
            dcs_j[:, :, j] -= (dh * cb).sum(-2)
    return y, dC, dcs_i, dB, dx, dcs_j


def reference(C, B, cs, x, dy):
    """The same algebra in float64, the scores and dCB rounded to bfloat16
    (from float64), the outputs left unrounded."""
    C, B, x, dy = (t.double() for t in (C, B, x, dy))
    Q = cs.shape[-1]
    seg = cs.double()[..., :, None] - cs.double()[..., None, :]
    decay = torch.exp(seg.masked_fill(~torch.ones(Q, Q, dtype=torch.bool).tril(), float("-inf")))
    cb = (C @ B.transpose(1, 2))[:, None]
    s = (cb * decay).to(torch.bfloat16).double()
    dh = (dy @ x.transpose(2, 3)) * decay
    dcb = dh.sum(1).to(torch.bfloat16).double()
    return (s @ x, dcb @ B, (dh * cb).sum(-1), dcb.transpose(1, 2) @ C,
            s.transpose(2, 3) @ dy, -(dh * cb).sum(-2))


def _inputs(BG, Q, N, Hg, P, seed):
    rng = np.random.default_rng(seed)

    def bf(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()

    C, B = bf(BG, Q, N), bf(BG, Q, N)
    dt = rng.uniform(0.0, 0.1, (BG, Hg, Q))
    A = -rng.uniform(1.0, 16.0, (1, Hg, 1))
    cs = torch.from_numpy(np.cumsum(dt * A, axis=-1).astype(np.float32))
    return C, B, cs, bf(BG, Hg, Q, P), bf(BG, Hg, Q, P)


SHAPES = {"ragged_q200_n40_hg3_p33": (2, 200, 40, 3, 33),
          "q128_n128_hg2_p64": (1, 128, 128, 2, 64)}
NAMES = ("y", "dC", "dcs_i", "dB", "dxdt", "dcs_j")


def _worst(BG, Q, N, Hg, P, **kw):
    """Each output's worst |emulated − reference| over its tolerance."""
    C, B, cs, x, dy = _inputs(BG, Q, N, Hg, P, seed=Q + N)
    got = emulated(C, B, cs, x, dy, **kw)
    want = reference(C, B, cs, x, dy)
    scales = da.term_scales(C, B, cs, x, dy)
    return {n: ((g.double() - w).abs() / (SSD_RTOL * sc.double() + 1e-30)).max().item()
            for n, g, w, sc in zip(NAMES, got, want, scales)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_one_bf16_product_in_fresh_sums_holds_the_float32_tolerance(shape):
    worst = _worst(*SHAPES[shape])
    assert all(v <= 1.0 for v in worst.values()), worst


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_unrounded_scores_or_dcb_fail_it(shape):
    """With the scores unrounded, y and dxdt leave the tolerance; with dCB
    unrounded, dC and dB do."""
    no_s = _worst(*SHAPES[shape], round_scores=False)
    no_d = _worst(*SHAPES[shape], round_dcb=False)
    assert no_s["y"] > 1.0 and no_s["dxdt"] > 1.0
    assert no_d["dC"] > 1.0 and no_d["dB"] > 1.0


def test_the_plain_version_is_the_rounded_emulation():
    """The port's plain bfloat16 version (the kernels' CPU path and their
    card reference) against the emulated kernels rounded to bfloat16: over
    97 % of the bfloat16 outputs equal, the rest one bfloat16 step apart at
    most (a float32 sum in another order near a rounding midpoint)."""
    C, B, cs, x, dy = _inputs(*SHAPES["ragged_q200_n40_hg3_p33"], seed=3)
    em = emulated(C, B, cs, x, dy)
    plain = (da.decay_attention_plain(C, B, cs, x),) + da.decay_attention_bwd_plain(
        C, B, cs, x, dy)
    for n, e, p in zip(NAMES, em, plain):
        if p.dtype != torch.bfloat16:
            continue
        e = e.to(torch.bfloat16).float()
        p = p.float()
        assert (e == p).float().mean() > 0.97, n
        assert bool(((e - p).abs() <= 2.0 ** -7 * p.abs() + 1e-30).all()), n
