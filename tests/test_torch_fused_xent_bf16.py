"""The fused decoder + softmax cross-entropy on bfloat16 operands
(``model.compute_dtype: bfloat16`` with ``train.fused_xent: true``): the
port's plain bfloat16 version against ``tlie_tpu``'s Pallas kernels in
interpret mode on the same bfloat16 inputs, the rounding point of t, an
emulation of the bfloat16 kernels' tiles and sums
(``tlie_tpu_torch/ops/csrc/fused_xent_bf16.cu``) against float64, one
training step of a tiny bf16 Mamba-2 through the fused head against
``tlie_tpu``'s ``make_train_block(fused_head=True,
fused_head_dtype=bfloat16)``, ``launch`` on a cut of
``configs/wikitext-mamba2-short-bf16-fused.yaml``, and ``chip_smoke``'s path
11 rehearsed on the CPU.

Inputs are made with numpy from a seed and rounded to bfloat16 once, so both
packages see the same values.  Tolerances are stated where they are used.
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.ops import fused_xent as jax_fx
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state_adamw
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import derive_runtime_fields, load_yaml
from tlie_tpu_torch.data import WikiText
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.ops import LAUNCHES
from tlie_tpu_torch.ops import fused_xent as fx
from tlie_tpu_torch.training import schedules, train, train_step
from tlie_tpu_torch.training.state import make_family_optimizer
from tlie_tpu_torch.training.steps import fused_head_loss
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FUSED_YAML = ROOT / "configs" / "wikitext-mamba2-short-bf16-fused.yaml"
SOURCE = (Path(fx.__file__).resolve().parent / "csrc" / "fused_xent_bf16.cu").read_text()
LOSS_RTOL = 1e-5       # float32 sums of D exact products, exp and log, in other orders
XENT_RTOL = 1e-5       # of a gradient element's sum of term magnitudes (float32 sums)
BF16_STEP = 2.0 ** -7  # the widest spacing of bfloat16 values, relative to the value
EQUAL_SHARE = 0.99     # bfloat16 gradient elements equal bit for bit, at least


def _inputs(M, D, V, seed, ignore_every=5):
    """bfloat16 h (M, D), w (D, V), b (V,) as numpy float32 holding bfloat16
    values, and int32 labels with every ``ignore_every``-th row ignored."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    h = bf(rng.standard_normal((M, D)))
    w = bf(rng.standard_normal((D, V)) / np.sqrt(D))
    b = bf(0.1 * rng.standard_normal(V))
    y = rng.integers(0, V, M).astype(np.int32)
    y[::ignore_every] = -100
    return h, w, b, y


def _port(h, w, b, y):
    """bfloat16 leaves in the port's layout: the weight as nn.Linear keeps
    it, (V, D), handed over as its transpose."""
    th = torch.from_numpy(h).bfloat16().requires_grad_()
    weight = torch.from_numpy(np.ascontiguousarray(w.T)).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).bfloat16().requires_grad_()
    return th, weight, tb, torch.from_numpy(y).long()


@jax.jit
def _jax_value_and_grads(h, w, b, y):
    return jax.value_and_grad(jax_fx.fused_softmax_xent, argnums=(0, 1, 2))(h, w, b, y)


def _jax(h, w, b, y):
    """tlie_tpu's loss and (dh, dW, db) on bfloat16 operands, its Pallas
    kernels in interpret mode; the gradients as float32 numpy arrays."""
    args = [jnp.asarray(a, jnp.bfloat16) for a in (h, w, b)] + [jnp.asarray(y)]
    with pltpu.force_tpu_interpret_mode():
        loss, grads = _jax_value_and_grads(*args)
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    return float(loss), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _bf16_band(want: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A bfloat16 gradient element's tolerance: XENT_RTOL of its term sums
    for the float32 sum in another order, plus one bfloat16 step of (|value|
    + term sums), since a sum near a rounding midpoint (or a t near one)
    may round one step apart."""
    return XENT_RTOL * scale + BF16_STEP * (want.abs() + scale) + 1e-30


CASES = {"m128_v700": (128, 64, 700, 5), "m256_v700": (256, 64, 700, 3),
         "m256_v100_below_a_tile": (256, 32, 100, 4)}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_bf16_matches_the_pallas_kernels(case):
    """The loss within 1e-5 relative; dh, dW and db bfloat16, each element
    within the band above, and at least 99 % of each equal bit for bit."""
    M, D, V, every = CASES[case]
    h, w, b, y = _inputs(M, D, V, seed=M + V, ignore_every=every)
    jloss, jgrads = _jax(h, w, b, y)
    th, weight, tb, ty = _port(h, w, b, y)
    loss = fx.fused_softmax_xent(th, weight.t(), tb, ty)
    assert loss.dtype == torch.float32
    loss.backward()
    assert loss.item() == pytest.approx(jloss, rel=LOSS_RTOL)
    got = (th.grad, weight.grad.t(), tb.grad)
    assert all(g.dtype == torch.bfloat16 for g in got)
    with torch.no_grad():
        _, lse = fx.fused_xent_fwd_plain(th, weight.t(), tb, ty)
        gscale = torch.tensor([1.0 / int((ty != -100).sum())])
        scales = fx.grad_term_scales(th, weight.t(), tb, ty, lse, gscale)
    for name, g, want, sc in zip(("dh", "dW", "db"), got, jgrads, scales):
        g, want = g.float(), torch.tensor(want)
        assert bool(((g - want).abs() <= _bf16_band(want, sc)).all()), name
        assert (g == want).float().mean().item() >= EQUAL_SHARE, name


def test_forward_rows_and_lse_match_the_reference_forward():
    """Per-row loss (0 on ignored rows) and lse of the plain forward on
    bfloat16 operands against the reference's own ``_fwd`` in interpret
    mode: float32 both, within 1e-6 relative or 1e-5 absolute."""
    h, w, b, y = _inputs(256, 64, 700, seed=9)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (h, w, b)] + [jnp.asarray(y)]
    with pltpu.force_tpu_interpret_mode():
        jrows, jlse = jax.jit(jax_fx._fwd)(*args)
    th, weight, tb, ty = _port(h, w, b, y)
    with torch.no_grad():
        rows, lse = fx.fused_xent_fwd_plain(th, weight.t(), tb, ty)
    assert rows.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6, atol=1e-5)
    assert bool((rows[ty == -100] == 0).all())


def _unrounded_bwd(h, w, b, labels, lse, gscale):
    """The plain backward with t left unrounded before the two products."""
    hf, wf, bf = (t.float() for t in (h, w, b))
    t = fx._dlogits_plain(hf, wf, bf, labels, lse, gscale)
    return ((t @ wf.t()).bfloat16(), (t.t() @ hf).bfloat16().t(), t.sum(0).bfloat16())


@pytest.mark.parametrize("case", ["m256_v700", "m256_v100_below_a_tile"])
def test_unrounded_t_falls_below_the_equal_share(case):
    """Without the rounding of t before its products, dh and dW fall below
    the 99 % bit-equal floor against tlie_tpu, so the check above sees the
    rounding point; db, summed from the unrounded t, stays equal."""
    M, D, V, every = CASES[case]
    h, w, b, y = _inputs(M, D, V, seed=M + V, ignore_every=every)
    _, (jdh, jdw, jdb) = _jax(h, w, b, y)
    th, weight, tb, ty = _port(h, w, b, y)
    with torch.no_grad():
        _, lse = fx.fused_xent_fwd_plain(th, weight.t(), tb, ty)
        gscale = torch.tensor([1.0 / int((ty != -100).sum())])
        dh, dw, db = _unrounded_bwd(th, weight.t(), tb, ty, lse, gscale)
    for got, want in ((dh, jdh), (dw, jdw)):
        assert (got.float() == torch.tensor(want)).float().mean().item() < EQUAL_SHARE
    assert (db.float() == torch.tensor(jdb)).float().mean().item() >= EQUAL_SHARE


def test_refuses_mixed_dtypes_and_routes_bf16_to_its_kernels():
    """h, w and b must share float32 or bfloat16; the bfloat16 kernels'
    launches count under their own names."""
    h, w, b, y = _inputs(128, 16, 300, seed=1)
    th, weight, tb, ty = _port(h, w, b, y)
    for args in ((th.float(), weight.t(), tb), (th, weight.t(), tb.float()),
                 (th.half(), weight.t().half(), tb.half())):
        with pytest.raises(TypeError, match="all float32 or all bfloat16"):
            fx.fused_softmax_xent(*args, ty)
    assert [fx.launch_name(k, torch.bfloat16) for k in ("fwd", "dh", "dw")] == [
        "fused_xent_fwd_bf16", "fused_xent_dh_bf16", "fused_xent_dw_bf16"]
    assert fx.launch_name("dh", torch.float32) == "fused_xent_dh"
    assert all(LAUNCHES.get(n) is not None for n in
               ("fused_xent_fwd_bf16", "fused_xent_dh_bf16", "fused_xent_dw_bf16"))
    assert set(fx.FUSED_XENT_BF16.signatures) == {
        "tlie_fused_xent_fwd_bf16", "tlie_fused_xent_dh_bf16", "tlie_fused_xent_dw_bf16"}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fx.fused_xent_dh_cuda(th, weight.t(), tb, ty, torch.zeros(128), torch.ones(1))


# -- the kernels' tiles and sums, emulated --------------------------------------------


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


KBK, KFWD_SLOTS = _constant("kBK"), _constant("kFwdSlots")


def _bwd_tile(D: int) -> int:
    """Rows of a streamed tile of the dh and the dW/db kernels (``BwdPlan``'s
    kHQ, equal to their resident rows a block): vocabulary rows for dh, rows
    of h for dW; 64 where D rounded up to kBK is at most 512, 32 above.  The
    tile's product with bf16(t) is one fresh sum."""
    return 64 if -(-D // KBK) * KBK <= 512 else 32


def test_the_source_is_what_the_emulation_follows():
    """One m16n8k16 bfloat16 product with float32 accumulators; the logits
    summed kBK deep into fresh sums; dh and dW/db one walk (``BwdPlan``,
    ``bwd_walk_bf16``) with the roles of h and W swapped: dh's second
    product over a tile of kHQ vocabulary rows, dW's over a tile of kHQ rows
    of h (64 at D <= 512, 32 above), each one fresh sum; t rounded to
    bfloat16 once, the pair packed into an A fragment, db summed from the
    float32 t, the outputs rounded once from their float32 sums; the
    forward's tiles (``FwdPlan``: 128 rows of h a block and 32 vocabulary
    rows a tile where D <= 512, 64 and 16 above) that forward_splits_bf16
    and the emulation assume, a tile's boxes summed in order before its
    statistics."""
    assert (KBK, KFWD_SLOTS) == (64, 3)
    assert SOURCE.count("static constexpr int kVT = kHRows / 4;") == 1
    assert SOURCE.count("static constexpr int kMaxD = 512 * 128 / kHRows;") == 1
    assert SOURCE.count("? launch_fwd_rows<128>(") == 1 and SOURCE.count(": launch_fwd_rows<64>(") == 1
    assert [fx.forward_tiles_bf16(d) for d in (96, 512, 513, 1024)] == [
        (128, 32), (128, 32), (64, 16), (64, 16)]
    assert SOURCE.count("fwd_products<kHRows>(c, ha, ws + i % kFwdSlots * kVT * Dpad") == 1
    assert SOURCE.count("    fwd_logits<kHRows>(x, c, n_box);\n") == 1
    assert SOURCE.count("for (int r = 0; r < PL::kNF * 4; ++r) x[r] += c[k][r];") == 1
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in SOURCE
    assert "mma.sync.aligned.m16n8k8" not in SOURCE  # no TF32 product
    # the backward walk's plan, for both kernels, and its rounding points
    assert SOURCE.count("static constexpr int kHQ = kRows;") == 1
    assert SOURCE.count("static constexpr int kMaxD = 512 * (64 / kRows);") == 1
    for kernel in ("true", "false"):  # dh, dW/db
        assert SOURCE.count(f"? launch_bwd_rows<64, {kernel}>(") == 1
        assert SOURCE.count(f": launch_bwd_rows<32, {kernel}>(") == 1
    assert SOURCE.count("bwd_walk_bf16<kPRows, true>(&w_map, h, w,") == 1
    assert SOURCE.count("bwd_walk_bf16<kVRows, false>(&h_map, h, w,") == 1
    assert [_bwd_tile(d) for d in (96, 512, 513, 1024)] == [64, 64, 32, 32]
    assert SOURCE.count("ta[m / 2][2 * (m % 2)] = pack_bf16(t[0][0], t[0][1]);") == 1
    assert SOURCE.count("pack_bf16(") == 3  # t's two halves, and the helper itself
    # t's two forms: dh matches each row's label against the tile's
    # vocabulary rows, dW each vocabulary row against the tile's labels
    assert SOURCE.count("t[hh][e] = (pv[2 * hh + e] - (v == r_lab[hh] ? 1.f : 0.f)) * g_scale;") == 1
    assert SOURCE.count("t[hh][e] = (pv[2 * hh + e] - (v32[hh] == lab ? 1.f : 0.f)) * g_scale;") == 1
    assert SOURCE.count("if (split == 0) db_acc[hh] += t[hh][e];") == 1
    assert SOURCE.count("for (int kk = 0; kk < kHQ / 16; ++kk) {") == 1
    assert SOURCE.count("for (int r = 0; r < 4; ++r) acc[2 * j0 + u][r] += c[u][r];") == 1
    assert SOURCE.count("for (int r = 0; r < 4; ++r) acc[kBox / 8 * j + n][r] += c[4 * n + r];") == 1
    # the walk's logits: a kBK-deep box a fresh sum (wgmma at 64 rows a
    # block, mma.sync at 32), added in order
    assert SOURCE.count("static_assert(kBK == kBox && PL::kQW % 8 == 0") == 1
    assert SOURCE.count("sw128_desc(hb + 16 * kk), kk > 0);") == 1
    assert SOURCE.count("for (int r = 0; r < 4; ++r) s[n][r] += c[4 * n + r];") == 1
    assert SOURCE.count("__floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1])") == 1
    assert SOURCE.count("db[r0 + 16 * band + g + 8 * hh] = __float2bfloat16_rn(v)") == 1
    for entry in ("tlie_fused_xent_fwd_bf16", "tlie_fused_xent_dh_bf16",
                  "tlie_fused_xent_dw_bf16"):
        assert f'extern "C" int {entry}(' in SOURCE
    # no library call computes the products (cuda.h and cudaTypedefs.h for
    # cuTensorMapEncodeTiled, which only describes h to the tensor memory
    # accelerator)
    assert not re.search(
        r"cublas|cutlass|#include <(?!cuda_bf16|cuda_runtime|cstdint|cuda\.h|cudaTypedefs\.h)",
        SOURCE)


def _holds_bfloat16_tensor_core_ops(kernel):
    """chip_smoke's rule for the two instantiations of ``kernel`` (dw, dh)
    in the bfloat16 library: the 32-row one must hold
    ``HMMA.16816.F32.BF16`` (mma.sync), the 64-row one may hold a bfloat16
    ``HGMMA`` (wgmma) in its place, and a kernel with neither fails."""
    cs = load_chip_smoke()
    rows = "v" if kernel == "dw" else "p"
    k64, k32 = f"{kernel}_{rows}64_bf16", f"{kernel}_{rows}32_bf16"
    assert cs.TC_KERNELS[k64] == cs.TC_KERNELS[k32] == "fused_xent_bf16"
    assert "dw_p64_bf16" not in cs.TC_KERNELS
    assert cs.TC_HGMMA == {"dw_v64_bf16", "dh_p64_bf16", "fwd_p128_bf16", "fwd_p64_bf16"}
    good = {name: {op: 4} for name, op in cs.TC_HMMA.items()}
    assert cs.tensor_core_ops_ok(good)
    good[k64] = {"HGMMA.64x64x16.F32.BF16": 16}
    assert cs.tensor_core_ops_ok(good)
    for name, ops in ((k64, {"HGMMA.64x64x16.F32": 16}), (k64, {}), (k32, {}),
                      (k32, {"HGMMA.64x64x16.F32.BF16": 16})):
        bad = dict(good, **{name: ops})
        assert not cs.tensor_core_ops_ok(bad), (name, ops)
    assert not cs.tensor_core_ops_ok({k: v for k, v in good.items() if k != k64})


def test_chip_smoke_holds_the_dw_kernel_to_bfloat16_tensor_core_ops():
    """``chip_smoke.py``'s build phase holds the dW/db kernel's two
    instantiations (``dw_v64_bf16``, ``dw_v32_bf16``) to the rule above;
    ``launch_bwd_rows`` launches the dW/db kernel for dW."""
    assert SOURCE.count(": xent_dw_bf16_kernel<kRows>;") == 1
    _holds_bfloat16_tensor_core_ops("dw")


def test_chip_smoke_holds_the_dh_kernel_to_bfloat16_tensor_core_ops():
    """The same for the dh kernel's (``dh_p64_bf16``, ``dh_p32_bf16``), which
    runs the dW/db kernel's walk with the rows of h resident: its 64-row
    instantiation on wgmma too."""
    assert SOURCE.count("kDh ? xent_dh_bf16_kernel<kRows> :") == 1
    _holds_bfloat16_tensor_core_ops("dh")


def test_chip_smoke_holds_the_forward_kernel_to_bfloat16_tensor_core_ops():
    """The forward kernel's two instantiations (128 rows of h a block where D
    <= 512, 64 above) run their products on wgmma alone: each must hold a
    bfloat16 ``HGMMA``, and one with neither that nor a bfloat16 HMMA fails."""
    cs = load_chip_smoke()
    assert SOURCE.count("mma_bf16(") == 4  # the helper and the 32-row dh and dW/db's
    good = {name: {op: 4} for name, op in cs.TC_HMMA.items()}
    for name in ("fwd_p128_bf16", "fwd_p64_bf16"):
        assert cs.TC_KERNELS[name] == "fused_xent_bf16" and name in cs.TC_HGMMA
        good[name] = {"HGMMA.64x32x16.F32.BF16": 32} if name == "fwd_p128_bf16" else {
            "HGMMA.64x8x16.F32.BF16": 64}
    assert cs.tensor_core_ops_ok(good)
    for name in ("fwd_p128_bf16", "fwd_p64_bf16"):
        for ops in ({}, {"HGMMA.64x32x16.F32.TF32": 32}):
            assert not cs.tensor_core_ops_ok(dict(good, **{name: ops})), (name, ops)


def test_chip_smoke_names_each_kernels_registers_and_spills():
    """The build phase's ``*_ptxas``: each entry function of a ``nvcc
    -Xptxas -v`` report by its name and template arguments, with its
    registers and spill bytes (stores and loads), which the phase holds to
    0."""
    cs = load_chip_smoke()
    mangled = ("_ZN51_GLOBAL__N__1899cf91_18_fused_xent_bf16_cu_1546ab3319"
               "xent_dh_bf16_kernelILi64EEEv14CUtensorMap_stPK13__nv_bfloat16")
    assert cs.kernel_name(mangled) == "xent_dh_bf16_kernel<64>"
    assert cs.kernel_name("_ZN12_GLOBAL__N_133decay_attention_bwd_j_bf16_kernelILi2ELb1EEEvPKf"
                          ) == "decay_attention_bwd_j_bf16_kernel<2, 1>"
    assert cs.kernel_name("tlie_entry") == "tlie_entry"
    log = (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 241 registers, used 16 barriers\n"
           "ptxas info    : Compiling entry function '_Z16diag_scan_kernelPKf' for 'sm_90a'\n"
           "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 255 registers\n")
    assert cs.ptxas_kernels(log) == {"xent_dh_bf16_kernel<64>": (241, 0),
                                     "diag_scan_kernel": (255, 12)}
    assert cs.ptxas_spills(log) == [0, 12]


def test_bf16_forward_splits_fill_one_wave_and_cover_the_vocabulary():
    """The bfloat16 forward runs one block an SM: its splits give at most
    one wave of blocks where the row blocks alone do not exceed it, every
    split at least one tile of ``forward_tiles_bf16``, and the splits cover
    the vocabulary; the LM's shape takes 64 row blocks x 2 splits."""
    for M, D, V, sms in ((8192, 512, 50257, 132), (128, 512, 100, 132), (384, 100, 2001, 132),
                         (256, 1024, 3000, 132), (40, 97, 50257, 8), (32768, 512, 50257, 132)):
        rows, tile = fx.forward_tiles_bf16(D)
        splits = fx.forward_splits_bf16(M, D, V, sms)
        row_tiles, n_tiles = -(-M // rows), -(-V // tile)
        per = -(-n_tiles // splits)
        assert 1 <= splits <= n_tiles and (splits - 1) * per < n_tiles <= splits * per
        assert row_tiles * splits <= max(sms, row_tiles)
    assert fx.forward_splits_bf16(8192, 512, 50257, 132) == 2


def _logits(hp, wq, bq):
    """The logits of rows hp against vocabulary rows wq in float32, each kBK
    deep step summed into a fresh sum and added in order, plus the bias."""
    s = torch.zeros(hp.shape[0], wq.shape[0])
    for k0 in range(0, hp.shape[1], KBK):
        s += hp[:, k0:k0 + KBK] @ wq[:, k0:k0 + KBK].t()
    return s + bq


def emulated(h, w_rows, b, labels, g, round_t=True, saved_lse=None):
    """The three kernels' float32 results on bfloat16 values held in float32:
    (loss rows, lse, dh, dW rows, db), tile by tile, before dh, dW and db are
    rounded to bfloat16, and the float32 t that the dh and the dW pass each
    formed (M, V).  The forward walks the kernel's vocabulary tiles
    (``forward_tiles_bf16``) with a running (max, sum-exp, picked); each backward recomputes a streamed
    tile's logits, forms t, rounds it where ``round_t``, and adds the tile's
    product (dh: a tile of the vocabulary's rows, dW: a tile of h's rows,
    ``_bwd_tile`` rows each, in one fresh sum) to a float32 accumulator,
    tile by tile.  The backward takes ``saved_lse`` where given (the kernels
    take the forward's lse as an input), else the emulated forward's."""
    M, V = h.shape[0], w_rows.shape[0]
    valid = labels != -100
    m = torch.full((M,), -1e30)
    s = torch.zeros(M)
    pk = torch.zeros(M)
    vt = fx.forward_tiles_bf16(h.shape[1])[1]
    for q0 in range(0, V, vt):
        x = _logits(h, w_rows[q0:q0 + vt], b[q0:q0 + vt])
        mn = torch.maximum(m, x.max(1).values)
        s = s * torch.exp(m - mn) + torch.exp(x - mn[:, None]).sum(1)
        m = mn
        cols = torch.arange(q0, q0 + x.shape[1])
        pk += torch.where(cols[None, :] == labels[:, None], x, torch.zeros_like(x)).sum(1)
    lse = m + torch.log(s)
    loss = torch.where(valid, lse - pk, torch.zeros_like(lse))
    lse_in = lse if saved_lse is None else saved_lse

    def t_of(rows, q0, q1):
        x = _logits(h[rows], w_rows[q0:q1], b[q0:q1])
        cols = torch.arange(q0, q0 + x.shape[1])
        t = torch.exp(x - lse_in[rows, None]) - (cols[None, :] == labels[rows, None]).float()
        return t * g * valid[rows, None].float()

    def rounded(t):
        return t.bfloat16().float() if round_t else t

    dh, dw, db = torch.zeros_like(h), torch.zeros_like(w_rows), torch.zeros(V)
    t_dh, t_dw = torch.zeros(M, V), torch.zeros(M, V)
    hq = _bwd_tile(h.shape[1])
    for q0 in range(0, V, hq):  # dh: the vocabulary's rows are the streamed tiles
        t = t_dh[:, q0:q0 + hq] = t_of(slice(None), q0, q0 + hq)
        dh += rounded(t) @ w_rows[q0:q0 + hq]
    for r0 in range(0, M, hq):  # dW, db: the rows of h are the streamed tiles
        t = t_dw[r0:r0 + hq] = t_of(slice(r0, r0 + hq), 0, V)
        dw += rounded(t).t() @ h[r0:r0 + hq]
        db += t.sum(0)
    return loss, lse, dh, dw, db, t_dh, t_dw


def reference(h, w_rows, b, labels, g):
    """The same algebra in float64 from the float64 logits, t rounded to
    bfloat16 (from float64) before the two products, the outputs left
    unrounded; and that rounded t."""
    h, w_rows, b = h.double(), w_rows.double(), b.double()
    x = h @ w_rows.t() + b
    lse = torch.logsumexp(x, 1)
    valid = labels != -100
    picked = x.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    t = torch.exp(x - lse[:, None])
    t[valid, labels[valid]] -= 1.0
    t = t * g * valid[:, None].double()
    tr = t.bfloat16().double()
    return (torch.where(valid, lse - picked, torch.zeros_like(lse)), lse, tr @ w_rows,
            tr.t() @ h, t.sum(0)), tr


EMULATED = {"m256_d96_v700": (256, 96, 700), "m128_d200_v300": (128, 200, 300)}


def _emulation_worst(M, D, V, round_t=True):
    """Each output's worst |emulated − reference| over its tolerance: the
    loss rows and lse within 1e-5 of |lse| + |picked| and of |lse|, each
    gradient element within XENT_RTOL of its term sums (|bf16(t)||w|, and so
    on; |t| for db), plus, for dh and dW, the terms whose t the float32
    pass rounded to the other bfloat16 neighbour than the float64 t (a t
    within float32 rounding of a midpoint): |bf16(t32) − bf16(t64)| times
    the other factor's magnitude, zero for every other term."""
    h, w, b, y = _inputs(M, D, V, seed=D + V)
    hb, wb, bb = (torch.from_numpy(a) for a in (h, np.ascontiguousarray(w.T), b))
    labels = torch.from_numpy(y).long()
    g = 1.0 / int((labels != -100).sum())
    *got, t_dh, t_dw = emulated(hb, wb, bb, labels, g, round_t=round_t)
    want, tr64 = reference(hb, wb, bb, labels, g)
    lse64 = want[1]
    gs = torch.tensor([g], dtype=torch.float64)
    s_dh, s_dw, s_db = fx.grad_term_scales(hb.double(), wb.double().t(), bb.double(), labels,
                                           lse64, gs)
    s_loss = fx.loss_term_scales(want[0], lse64)
    flip_dh = (t_dh.bfloat16().double() - tr64).abs() @ wb.double().abs()
    flip_dw = (t_dw.bfloat16().double() - tr64).abs().t() @ hb.double().abs()
    tols = (XENT_RTOL * s_loss, XENT_RTOL * lse64.abs(), XENT_RTOL * s_dh + flip_dh,
            XENT_RTOL * s_dw.t() + flip_dw, XENT_RTOL * s_db)
    return {n: ((a.double() - r).abs() / (tol + 1e-300)).max().item()
            for n, a, r, tol in zip(("loss", "lse", "dh", "dW", "db"), got, want, tols)}


@pytest.mark.parametrize("shape", sorted(EMULATED))
def test_the_kernels_tiles_and_fresh_sums_hold_the_float32_tolerance(shape):
    worst = _emulation_worst(*EMULATED[shape])
    assert all(v <= 1.0 for v in worst.values()), worst


@pytest.mark.parametrize("shape", sorted(EMULATED))
def test_leaving_t_unrounded_fails_it(shape):
    """With t unrounded before its products, dh and dW leave the tolerance:
    the emulation sees the rounding point; db does not move."""
    worst = _emulation_worst(*EMULATED[shape], round_t=False)
    assert worst["dh"] > 1.0 and worst["dW"] > 1.0 and worst["db"] <= 1.0


def test_the_plain_version_is_the_rounded_emulation():
    """The port's plain bfloat16 forward and backward (the kernels' CPU path
    and their card reference) against the emulated kernels rounded to
    bfloat16, the backward given the same lse (as the kernels are held to
    the plain version on the card): at least 99 % of the bfloat16 outputs
    equal, the rest one bfloat16 step apart at most (a float32 sum in
    another order near a rounding midpoint)."""
    h, w, b, y = _inputs(256, 96, 700, seed=11)
    th, weight, tb, ty = _port(h, w, b, y)
    g = 1.0 / int((ty != -100).sum())
    with torch.no_grad():
        rows, lse = fx.fused_xent_fwd_plain(th, weight.t(), tb, ty)
        plain = fx.fused_xent_bwd_plain(th, weight.t(), tb, ty, lse, torch.tensor([g]))
    em = emulated(th.detach().float(), weight.detach().float(), tb.detach().float(), ty, g,
                  saved_lse=lse)[:5]
    torch.testing.assert_close(rows, em[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, em[1], rtol=1e-6, atol=0)
    for name, e, p in (("dh", em[2], plain[0]), ("dW", em[3], plain[1].t()),
                       ("db", em[4], plain[2])):
        e, p = e.bfloat16().float(), p.float()
        assert (e == p).float().mean() >= EQUAL_SHARE, name
        assert bool(((e - p).abs() <= BF16_STEP * p.abs() + 1e-30).all()), name


# -- one training step of a bf16 Mamba-2 through the fused head -----------------------

V_STEP = 300  # a ragged vocabulary: two full 128-wide tiles and 44 columns
MAMBA_BF16_FUSED = dict(
    layer="mamba", version="mamba2", num_layers=2, num_heads=2, input_dim=1,
    output_dim=V_STEP, hidden_dim=128, state_dim=128, conv_dim=4, expansion=1, dropout=0.0,
    glu=True, norm="layer", dual=False, prenorm=True, pooling="none", embedding=True,
    token_embedding=True, vocab_size=V_STEP, max_pos_embed=128, mixer="none",
    mixer_dim=128, classifier=False, compute_dtype="bfloat16", seq_len=128)


def _jax_fused_loss(jmodel):
    """tlie_tpu's ``_fused_loss`` (``scan_loop.py:252-269``) at dropout 0
    with ``fused_head_dtype`` bfloat16: the features, the decoder kernel and
    its bias cast to bfloat16 before the Pallas head."""
    def loss(params, x, y):
        feats = jmodel.apply({"params": params}, x, method=type(jmodel).features)
        dec = params["decoder"]
        return jax_fx.fused_softmax_xent(
            feats.astype(jnp.bfloat16).reshape(-1, feats.shape[-1]),
            dec["kernel"].astype(jnp.bfloat16), dec["bias"].astype(jnp.bfloat16), y.reshape(-1))
    return loss


@pytest.fixture(scope="module")
def bf16_step():
    """The bf16 Mamba-2 above on ``tlie_tpu``'s init weights, a batch of 2 ×
    128 tokens (B·L = 256 rows, some labels ignored), and ``tlie_tpu``'s
    loss and float32 gradients through its fused head, its Pallas kernels
    (the head's and the SSD's intra-chunk arm, ``TLIE_SSD_INTRA=pallas``) in
    interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TLIE_SSD_INTRA", "pallas")
    rng = np.random.default_rng(0)
    x = rng.integers(0, V_STEP, (2, 128)).astype(np.int32)
    y = rng.integers(0, V_STEP, (2, 128)).astype(np.int32)
    y[:, -1] = -100
    y[0, :5] = -100
    jmodel, jeval, _ = jax_build_models(MAMBA_BF16_FUSED, padded=False)
    params = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), x)["params"])
    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.jit(jax.value_and_grad(_jax_fused_loss(jmodel)))(params, x, y)
    yield jmodel, params, x, y, float(jloss), to_numpy(jgrads)
    mp.undo()


def _port_model(params, cfg=MAMBA_BF16_FUSED):
    model, _, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def test_fused_bf16_loss_and_gradients_match_tlie_tpu(bf16_step):
    """The loss within 1e-4 relative (both models round their activations to
    bfloat16 at every layer, in other orders; the float32 model's loss sits
    2e-5 away); every float32 parameter gradient within 0.04 of its leaf's
    max|g|, about ten bfloat16 steps (2^-8) of rounding noise carried
    through two layers, as far as either package's bf16 gradients sit from
    the float32 model's (up to 0.023 here).  The decoder's dW and db are
    bfloat16 values widened to float32 in both packages (the cast's VJP),
    and 95 % of db's elements are equal bit for bit (the head on the same
    features gives 99 %, above; here the features differ by bf16 noise)."""
    _, params, x, y, jloss, jgrads = bf16_step
    model = _port_model(params)
    seen = []
    real = fx.FusedXentFn.apply

    def spy(h, w, b, labels):
        seen.append((h.dtype, w.dtype, b.dtype, w.stride()))
        return real(h, w, b, labels)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fx.FusedXentFn, "apply", spy)
        loss = fused_head_loss(model, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    # the weight cast to bfloat16 and transposed: its (V, D) rows read in place
    assert seen == [(torch.bfloat16,) * 3 + ((1, 128),)]
    loss.backward()
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(jloss, rel=1e-4)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.04 * np.abs(w).max(), err_msg=str(path))
    for leaf in ("kernel", "bias"):
        g, w = got["decoder"][leaf], jgrads["decoder"][leaf]
        for a in (g, w):
            assert np.array_equal(a, torch.tensor(a).bfloat16().float().numpy()), leaf
    assert np.mean(got["decoder"]["bias"] == jgrads["decoder"]["bias"]) >= 0.95


def test_fused_bf16_adamw_clip_step_matches_make_train_block(bf16_step):
    """One step of AdamW behind optax's global-norm clip at the config's
    peak rate (the step after warmup) against ``make_train_block(...,
    fused_head=True, fused_head_dtype=bfloat16)``: the loss within 1e-4
    relative; the parameters within 1e-6 where both packages' |g| are at
    least 0.05 of their leaf's max (above the bf16 noise of the gradients,
    so the signs agree and Adam's first step, lr·g/(|g| + eps), is the same
    up to float32 rounding), and within the movement bound 2·lr + 1e-6
    everywhere; those elements cover at least 30 % of the weights."""
    jmodel, params, x, y, jloss, jgrads = bf16_step
    tc = load_yaml(FUSED_YAML)["train"]
    step0 = tc["warmup_steps"]
    rate = schedules.lr_for_step(step0, tc["lr"], step0, tc["total_steps"], tc["cosine_anneal"],
                                 1e-6)
    state, _ = create_train_state_adamw(
        jmodel, jax.random.PRNGKey(0), in_dim=1, batch_size=2, seq_len=128,
        weight_decay=tc["wd"], lr=tc["lr"], betas=tuple(tc["betas"]), integer_inputs=True,
        param_group=None)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    block = jax_scan_loop.make_train_block(
        jmodel, "layer", tuple(sorted(state.opt_state.inner_states)), tc["warmup_steps"],
        tc["total_steps"], tc["cosine_anneal"], 1e-6, fused_head=True,
        fused_head_dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jstate, jstep_loss = block(state, jax.random.PRNGKey(1),
                                   jax_scan_loop.put_dataset(x, y), np.arange(2)[None], step0,
                                   tc["lr"], tc["lr"])
    model = _port_model(params)
    f = {"lr": tc["lr"], "ssm_lr": tc["lr"], "wd": tc["wd"], "betas": tuple(tc["betas"])}
    opt, clip = make_family_optimizer(model, "mamba", MAMBA_BF16_FUSED, tc, f)
    loss = train_step(model, opt, torch.from_numpy(x).long(), torch.from_numpy(y).long(),
                      {"regular": rate}, fused_head=True, clip_norm=clip)
    assert float(loss) == pytest.approx(float(jstep_loss), rel=1e-4)
    assert float(jstep_loss) == pytest.approx(jloss, rel=1e-6)
    got, _ = params_to_jax(model.state_dict())
    port_grads, _ = params_to_jax(_grads_of(params, x, y))
    n_det = n_all = 0
    for (path, a), b, g1, g2 in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree_util.tree_leaves(to_numpy(jstate.params)),
                                    jax.tree_util.tree_leaves(port_grads),
                                    jax.tree_util.tree_leaves(jgrads)):
        err = np.abs(a - b)
        det = ((np.abs(g1) >= 0.05 * np.abs(g1).max()) & (np.abs(g2) >= 0.05 * np.abs(g2).max()))
        assert err[det].max(initial=0.0) <= 1e-6, path
        assert err.max() <= 2 * rate + 1e-6, path
        n_det, n_all = n_det + det.sum(), n_all + det.size
    assert n_det >= 0.3 * n_all


def _grads_of(params, x, y):
    """The port's raw gradients (before the clip) through the fused head."""
    model = _port_model(params)
    fused_head_loss(model, torch.from_numpy(x).long(), torch.from_numpy(y).long()).backward()
    return {n: p.grad for n, p in model.named_parameters()}


# -- training and launch on a cut of the config ----------------------------------------


def _tiny_fused(tmp_path):
    """``configs/wikitext-mamba2-short-bf16-fused.yaml`` cut to 2 layers,
    d_model 32, two heads, block 64, batch 2 (B·L = 128 rows, the fused
    head's smallest row tile), 4 steps; the vocabulary stays 50,257."""
    cfg = load_yaml(FUSED_YAML)
    cfg["model"].update(num_layers=2, hidden_dim=32, state_dim=16, num_heads=2)
    cfg["dataset"].update(block_size=64, synthetic_train_tokens=64 * 12,
                          synthetic_test_tokens=64 * 4)
    cfg["train"].update(batch_size=2, total_steps=4, eval_every=2)
    cfg["save"] = str(tmp_path / "checkpoint" / "wikitext-mamba2-short-bf16-fused")
    return cfg


def test_bf16_fused_training_goes_through_the_head_and_moves_float32_weights(tmp_path):
    """Four steps of the cut config through ``train``: each step's loss goes
    through ``fused_softmax_xent`` on bfloat16 operands, the losses and
    perplexities are finite, and every parameter stays float32 and moves."""
    cfg = _tiny_fused(tmp_path)
    data = WikiText(**cfg["dataset"])
    tr, te = data.split("train"), data.split("test")
    cfg = derive_runtime_fields(cfg, data.l_max, len(tr[0]))
    seen = []
    real = fx.FusedXentFn.apply

    def spy(h, w, b, labels):
        seen.append((h.dtype, w.dtype, b.dtype, tuple(h.shape)))
        return real(h, w, b, labels)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fx.FusedXentFn, "apply", spy)
        result = train(cfg, tr, te, device="cpu")
    assert seen == [(torch.bfloat16,) * 3 + ((128, 32),)] * 4
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    init = build_models(cfg["model"], generator=torch.Generator().manual_seed(cfg["seed"]),
                        device="cpu")[0].state_dict()
    for name, p in result.model.state_dict().items():
        assert p.dtype == torch.float32, name
        assert not torch.equal(p, init[name]), name


def test_launch_trains_and_analyses_the_bf16_fused_config_on_the_cpu(tmp_path, monkeypatch,
                                                                     capsys):
    cfg = _tiny_fused(tmp_path)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    analysis = load_yaml(ROOT / "configs/analysis/wikitext.yaml")
    analysis["save_path"] = str(tmp_path / "analysis")
    (tmp_path / "analysis.yaml").write_text(yaml.safe_dump(analysis))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(tmp_path / "tiny.yaml"), "--analysis_config",
                        str(tmp_path / "analysis.yaml"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fused decoder+softmax-CE head enabled" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("wikitext-mamba2-short-bf16-fused-seed-1919-layers-2")
    (run,) = os.listdir(tmp_path / "analysis")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    assert np.load(tmp_path / "analysis" / run / "eig.npy").dtype == np.float32


# -- the card run's path 11, rehearsed --------------------------------------------------


def test_chip_smoke_path_11_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.wikitext_mamba2_path`` on a tiny cut of
    ``configs/wikitext-mamba2-short-bf16-fused.yaml`` on the CPU (2 layers,
    d_model 32, two heads, block 64, batch 2, 12 training blocks), 2 steps,
    with counting plain kernels: every check of the path runs as on the
    card, the fused head's bfloat16 kernels once each per step, none of the
    float32 ones, no training step through the dense head, the float32
    analysis's forwards, the step timing with the head's share."""
    from tlie_tpu_torch import config as config_mod

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True, head_kernels=True)
    real_load = config_mod.load_yaml

    def tiny_load(path):
        cfg = real_load(path)
        if os.path.basename(str(path)).startswith("wikitext-mamba2"):
            cfg["model"].update(num_layers=2, hidden_dim=32, state_dim=16, num_heads=2)
            cfg["dataset"].update(block_size=64, synthetic_train_tokens=64 * 12,
                                  synthetic_test_tokens=64 * 4)
            cfg["train"]["batch_size"] = 2
        return cfg

    monkeypatch.setattr(config_mod, "load_yaml", tiny_load)
    monkeypatch.setattr(cs, "WT_STEPS", 2)
    splits = cs.wikitext_splits()
    launches = cs.wikitext_mamba2_path(torch.device("cpu"), splits,
                                       "wikitext-mamba2-short-bf16-fused.yaml", "wt_fused",
                                       ARTIFACT_FILES)
    # training's 2 steps and 2 eval batches of 2 layers, the head's kernels
    # once a step, and the float32 analysis's forwards of the init and
    # trained models
    assert {k: v for k, v in launches.items() if v} == {
        "decay_attention_fwd_bf16": 2 * (2 + 2), "decay_attention_bwd_i_bf16": 4,
        "decay_attention_bwd_j_bf16": 4, "decay_attention_fwd": 2 * 2,
        "fused_xent_fwd_bf16": 2, "fused_xent_dh_bf16": 2, "fused_xent_dw_bf16": 2}
