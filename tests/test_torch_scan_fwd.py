"""The scan forward kernel's chunk-and-carry fold (``csrc/diag_scan.cu``),
emulated on the CPU.

``emulated_scan_fwd`` computes h in float32 as the kernel does: logical
time (flipped under ``reverse``) in rounds of KCHUNKS chunks of KSPAN steps;
each chunk folded from a zero state into (A, H); the round's aggregates
folded in chunk order from the state the round before handed on; each
chunk rescanned from the state entering it; steps past L the identity (a 1,
b 0).  KSPAN and KCHUNKS are pinned to the kernel's source, and the source
is checked for the fold order the emulation follows.

It is held to the float64 plain scan and to ``tlie_tpu``'s associative scan
at L 77 (one partial round) and L 600 (two whole rounds and a partial one),
real and complex, forward and reverse, with an (N,) decay and with a (B, L,
N) decay that varies in time.  Tolerance: 1e-5 of max|h|, as in
tests/test_torch_scan.py (f32 accumulation over L steps with |a| < 1, in
another order).
"""

import math
import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.ops.scan import diag_linear_scan as jax_scan
from tlie_tpu_torch.ops import scan
from tlie_tpu_torch.ops.scan import diag_scan_plain

torch.set_num_threads(1)

SCAN_SOURCE = Path(scan.__file__).resolve().parent / "csrc" / "diag_scan.cu"


def _source_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SCAN_SOURCE.read_text()).group(1))


KSPAN, KCHUNKS = 16, 16  # steps of a chunk, chunks of a round (diag_scan.cu)
KROUND = KSPAN * KCHUNKS
RTOL_OF_MAX = 1e-5
B, N = 3, 24
A_SHAPES = {"per_channel": lambda L: (N,), "per_example": lambda L: (B, L, N)}


def _planes(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def emulated_scan_fwd(a, b, reverse=False):
    """h as ``diag_scan.cu`` computes it, in float32, from (re, im) planes or
    real tensors of shape (..., L, N), ``a`` broadcasting to ``b``."""
    pair = isinstance(b, tuple)
    shape = _planes(b)[0].shape
    Bt, L, Nn = math.prod(shape[:-2]), shape[-2], shape[-1]
    T = L + (-L % KROUND)  # whole rounds; the steps past L are the identity
    flip = (lambda x: x.flip(-2)) if reverse else (lambda x: x)

    def logical(x, fill):  # (Bt, rounds, chunks, steps, N) in logical time
        x = flip(torch.broadcast_to(x, shape).reshape(Bt, L, Nn))
        x = torch.cat([x, torch.full((Bt, T - L, Nn), fill)], 1)
        return x.reshape(Bt, T // KROUND, KCHUNKS, KSPAN, Nn)

    zero = torch.zeros(shape)
    a_re, a_im = logical(_planes(a)[0], 1.0), logical(a[1] if pair else zero, 0.0)
    b_re, b_im = logical(_planes(b)[0], 0.0), logical(b[1] if pair else zero, 0.0)
    R = T // KROUND

    # pass 1: each chunk from a zero state into (A, H)
    A_re, A_im = torch.ones(Bt, R, KCHUNKS, Nn), torch.zeros(Bt, R, KCHUNKS, Nn)
    H_re, H_im = torch.zeros_like(A_re), torch.zeros_like(A_re)
    for s in range(KSPAN):
        ar, ai = a_re[:, :, :, s], a_im[:, :, :, s]
        H_re, H_im = (ar * H_re - ai * H_im + b_re[:, :, :, s],
                      ar * H_im + ai * H_re + b_im[:, :, :, s])
        A_re, A_im = ar * A_re - ai * A_im, ar * A_im + ai * A_re
    # carry: each round's chunks in order, from the state the round before handed on
    e_re, e_im = torch.zeros_like(A_re), torch.zeros_like(A_re)
    c_re, c_im = torch.zeros(Bt, Nn), torch.zeros(Bt, Nn)
    for r in range(R):
        for j in range(KCHUNKS):
            e_re[:, r, j], e_im[:, r, j] = c_re, c_im
            pr, pi = A_re[:, r, j], A_im[:, r, j]
            c_re, c_im = pr * c_re - pi * c_im + H_re[:, r, j], pr * c_im + pi * c_re + H_im[:, r, j]
    # pass 2: each chunk rescanned from the state entering it
    h_re, h_im = torch.zeros_like(b_re), torch.zeros_like(b_re)
    for s in range(KSPAN):
        ar, ai = a_re[:, :, :, s], a_im[:, :, :, s]
        e_re, e_im = ar * e_re - ai * e_im + b_re[:, :, :, s], ar * e_im + ai * e_re + b_im[:, :, :, s]
        h_re[:, :, :, s], h_im[:, :, :, s] = e_re, e_im

    def physical(x):  # back to (..., L, N) in physical time
        return flip(x.reshape(Bt, T, Nn)[:, :L]).reshape(shape)

    return (physical(h_re), physical(h_im)) if pair else physical(h_re)


def _inputs(complex_mode, a_shape, L, seed):
    """a on the LRU's ring (|a| in [0.9, 0.99]), b standard normal (B, L, N)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.9, 0.99, a_shape)
    draw = lambda: rng.standard_normal((B, L, N)).astype(np.float32)  # noqa: E731
    if complex_mode:
        th = rng.uniform(0.0, 6.28, a_shape)
        return ((r * np.cos(th)).astype(np.float32), (r * np.sin(th)).astype(np.float32)), \
            (draw(), draw())
    return r.astype(np.float32), draw()


def _t(x, dtype=torch.float32):
    return tuple(torch.tensor(p, dtype=dtype) for p in x) if isinstance(x, tuple) \
        else torch.tensor(x, dtype=dtype)


def _jax_full(x, L):
    """x as JAX arrays broadcast to (B, L, N): every case of one L then shares
    one compiled scan (the (N,) decay is still read as one value per channel)."""
    full = lambda p: jnp.asarray(np.broadcast_to(p, (B, L, N)))  # noqa: E731
    return tuple(full(p) for p in x) if isinstance(x, tuple) else full(x)


_jax_assoc = jax.jit(partial(jax_scan, impl="assoc"), static_argnames="reverse")


@pytest.mark.parametrize("L", [77, 600])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("a_kind", list(A_SHAPES))
@pytest.mark.parametrize("complex_mode", [True, False], ids=["complex", "real"])
def test_kernel_fold_matches_float64_and_jax(complex_mode, a_kind, reverse, L):
    a, b = _inputs(complex_mode, A_SHAPES[a_kind](L), L, seed=L + 3 * reverse + len(a_kind))
    h = emulated_scan_fwd(_t(a), _t(b), reverse=reverse)
    want64 = diag_scan_plain(_t(a, torch.float64), _t(b, torch.float64), reverse=reverse)
    want_jax = _jax_assoc(_jax_full(a, L), _jax_full(b, L), reverse=reverse)
    for want in (_planes(want64), _planes(want_jax)):
        want = [np.asarray(w, dtype=np.float64) for w in want]
        scale = max(np.abs(w).max() for w in want)
        for got, w in zip(_planes(h), want):
            assert got.dtype == torch.float32 and got.shape == w.shape == (B, L, N)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=RTOL_OF_MAX * scale)


def test_fold_emulation_follows_the_kernel_source():
    src = SCAN_SOURCE.read_text()
    assert (_source_const("kSpan"), _source_const("kChunks")) == (KSPAN, KCHUNKS)
    assert _source_const("kLanes") == scan._LANES
    assert "constexpr int kRound = kChunks * kSpan;" in src
    # rounds from the left; the loads and each chunk's two passes first step
    # first; the carry over the round's chunks in order
    assert "for (int64_t r = 0; r < rounds; ++r) {" in src
    assert src.count("for (int s = 0; s < kSpan; ++s) {") == 3
    assert "for (int j = 0; j < kChunks; ++j) {" in src
    # b is loaded once, in the loop that fills the chunk's registers; steps
    # past L load as the identity
    assert src.count("b_re[") == 1 and src.count("b_im[") == 1
    assert "br[s] = in ? b_re[x0 + s * step] : 0.f;" in src
    assert "ar[s] = in ? a_re[q0 + s * a_step] : 1.f;" in src
    assert "xr = s < n_in ? car : 1.f;" in src
    # a constant in time is loaded once, before the first round
    assert src.index("car = a_re[a_off];") < src.index("for (int64_t r = 0; r < rounds; ++r) {")


def test_chip_smoke_reads_each_functions_spills_from_ptxas():
    """The build phase's ``*_spill_bytes``: spill stores and loads of each
    function in a ``-Xptxas -v`` report, in its order."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    log = """ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'
ptxas info    : Function properties for _Z1fv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8192 bytes smem
ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'
ptxas info    : Function properties for _Z1gv
    328 bytes stack frame, 324 bytes spill stores, 240 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8192 bytes smem
"""
    assert cs.ptxas_spills(log) == [0, 564]
    assert cs.ptxas_spills("") == []
