"""The scan's gradient in the port against tlie_tpu's, and the two repaired
routing faults.

``diag_scan_bwd_plain`` and autograd through ``DiagScanFn`` (the CPU route)
must equal ``jax.grad`` of ``tlie_tpu.ops.scan.diag_linear_scan`` through the
associative scan and through the Pallas TPU kernel's custom VJP run in
interpret mode.  Tolerances: ``db`` within 1e-5 of max|db| (f32
accumulation over L steps in another order, as for the forward); ``da``
within 1e-5 of Σ (max|d|·|h_{t-1}| + |d_t|·max|h|) over the axes it is
summed along: each term d_t·h_{t-1} carries the errors of d and of h, each
within 1e-5 of its max.

The fault tests route CPU tensors as if they lay on the card (no card
here) with the launchers replaced by counting wrappers around the plain
versions: the forward and the backward must both reach their launcher, the
reverse scan included, and the gradients must equal plain autograd.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tlie_tpu.ops.scan import diag_linear_scan as jax_scan
from tlie_tpu_torch.models import LRU, build_models
from tlie_tpu_torch.models import lru as lru_module
from tlie_tpu_torch.ops import scan
from tlie_tpu_torch.ops.scan import (
    _shift, _sum_to, diag_linear_scan, diag_scan_bwd_plain, diag_scan_plain,
)
from torch_parity import small_config, tokens

torch.set_num_threads(1)

B, L, N = 2, 64, 128
RTOL = 1e-5
A_SHAPES = {"per_channel": (N,), "per_step": (L, N), "per_example": (B, L, N)}


def _inputs(complex_mode, a_shape, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.9, 0.99, a_shape)
    if complex_mode:
        th = rng.uniform(0.0, 6.28, a_shape)
        a = ((r * np.cos(th)).astype(np.float32), (r * np.sin(th)).astype(np.float32))
        b = tuple(rng.standard_normal((B, L, N)).astype(np.float32) for _ in range(2))
        w = tuple(rng.standard_normal((B, L, N)).astype(np.float32) for _ in range(2))
        return a, b, w
    a = r.astype(np.float32)
    return a, rng.standard_normal((B, L, N)).astype(np.float32), \
        rng.standard_normal((B, L, N)).astype(np.float32)


def _planes(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def _t(x, grad=False):
    return tuple(torch.tensor(p, requires_grad=grad) for p in x) if isinstance(x, tuple) \
        else torch.tensor(x, requires_grad=grad)


def _jax_grads(a, b, w, impl, reverse):
    """jax.grad of Σ w·h with respect to (a, b), as numpy planes."""
    def loss(a, b):
        h = jax_scan(a, b, impl=impl, reverse=reverse)
        return sum(jnp.sum(x * y) for x, y in zip(_planes(h), _planes(w)))

    jj = lambda x: tuple(jnp.asarray(p) for p in x) if isinstance(x, tuple) else jnp.asarray(x)
    fn = jax.jit(jax.grad(loss, argnums=(0, 1)))
    if impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            ga, gb = fn(jj(a), jj(b))
    else:
        ga, gb = fn(jj(a), jj(b))
    return [np.asarray(x) for x in _planes(ga)], [np.asarray(x) for x in _planes(gb)]


def _da_scale(a_shape, d, h, reverse):
    """Σ (max|d|·|h_{t-1}| + |d_t|·max|h|) over the axes da is summed along."""
    h_prev = sum(_shift(x, 1 if reverse else -1).abs() for x in _planes(h))
    d_abs = sum(x.abs() for x in _planes(d))
    hmax = max(x.abs().max() for x in _planes(h))
    return _sum_to(d_abs.max() * h_prev + d_abs * hmax, torch.Size(a_shape)).numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("a_kind", list(A_SHAPES))
@pytest.mark.parametrize("complex_mode", [True, False], ids=["complex", "real"])
@pytest.mark.parametrize("impl", ["assoc", "pallas"])
def test_backward_matches_jax_grad(impl, complex_mode, a_kind, reverse):
    a_shape = A_SHAPES[a_kind]
    a, b, w = _inputs(complex_mode, a_shape, seed=len(a_shape) + 3 * reverse)
    want_da, want_db = _jax_grads(a, b, w, impl, reverse)

    h = diag_scan_plain(_t(a), _t(b), reverse=reverse)
    da, db = diag_scan_bwd_plain(_t(a), h, _t(w), reverse=reverse)
    ta, tb = _t(a, grad=True), _t(b, grad=True)
    out = diag_linear_scan(ta, tb, reverse=reverse)
    loss = sum((x * y).sum() for x, y in zip(_planes(out), _planes(_t(w))))
    auto = torch.autograd.grad(loss, _planes(ta) + _planes(tb))
    k = len(_planes(ta))

    da_tol = RTOL * _da_scale(a_shape, db, h, reverse)
    for got in (_planes(da), auto[:k]):
        for g, want in zip(got, want_da):
            assert g.shape == want.shape == a_shape
            assert np.all(np.abs(g.detach().numpy() - want) <= da_tol)
    db_tol = RTOL * max(np.abs(x).max() for x in want_db)
    for got in (_planes(db), auto[k:]):
        for g, want in zip(got, want_db):
            np.testing.assert_allclose(g.detach().numpy(), want, rtol=0, atol=db_tol)


@pytest.mark.parametrize("a_kind", list(A_SHAPES))
def test_plain_reverse_forward_matches_jax(a_kind):
    a, b, _ = _inputs(True, A_SHAPES[a_kind], seed=9)
    h = diag_linear_scan(_t(a), _t(b), reverse=True)
    ref = jax_scan(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), impl="assoc",
                   reverse=True)
    scale = max(np.abs(np.asarray(x)).max() for x in ref)
    for g, w in zip(h, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=RTOL * scale)


class _CountingLaunchers:
    """Stand-ins for the CUDA launchers: the plain versions, counted, with
    the reverse flag each call got."""

    def __init__(self):
        self.fwd, self.bwd = [], []

    def diag_scan_cuda(self, a, b, reverse=False):
        self.fwd.append(reverse)
        return diag_scan_plain(a, b, reverse=reverse)

    def diag_scan_bwd_cuda(self, a, h, g, reverse=False):
        self.bwd.append(reverse)
        return diag_scan_bwd_plain(a, h, g, reverse=reverse)


@pytest.fixture
def on_card(monkeypatch):
    """Route every scan to the (counting) CUDA launchers."""
    launchers = _CountingLaunchers()
    monkeypatch.setattr(scan, "_on_cuda", lambda t: True)
    monkeypatch.setattr(scan, "diag_scan_cuda", launchers.diag_scan_cuda)
    monkeypatch.setattr(scan, "diag_scan_bwd_cuda", launchers.diag_scan_bwd_cuda)
    return launchers


def _plain_autograd(monkeypatch):
    """Make the LRU call the plain loop directly, differentiated by autograd."""
    monkeypatch.setattr(lru_module, "diag_linear_scan", lambda a, b: diag_scan_plain(a, b))


def _grads(module, loss_fn):
    module.zero_grad(set_to_none=True)
    loss_fn().backward()
    return {n: None if p.grad is None else p.grad.clone() for n, p in module.named_parameters()}


def test_lru_gradients_reach_every_parameter_through_the_card_route(on_card, monkeypatch):
    """Fault 1: the card's scan used to fill buffers outside autograd, so
    nothing before the scan got a gradient."""
    lru = LRU(16, 8, torch.Generator().manual_seed(0), r_min=0.9, r_max=0.99)
    rng = np.random.default_rng(0)
    u = torch.tensor(rng.standard_normal((3, 20, 8)).astype(np.float32))
    w = [torch.tensor(rng.standard_normal((3, 20, 16)).astype(np.float32)) for _ in range(2)]

    def loss():
        h = lru.scan(u)
        return (h[0] * w[0]).sum() + (h[1] * w[1]).sum()

    got = _grads(lru, loss)
    assert on_card.fwd == [False] and on_card.bwd == [False]
    _plain_autograd(monkeypatch)
    want = _grads(lru, loss)
    for name in ("nu_log", "theta_log", "gamma_log", "B_re", "B_im"):
        assert got[name] is not None, name
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6)


def test_model_gradients_reach_the_encoder_through_the_card_route(on_card, monkeypatch):
    cfg = dict(small_config()["model"], input_dim=32, output_dim=32, hidden_dim=8,
               state_dim=8, seq_len=16, dropout=0.0)
    model, _, _ = build_models(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    x = torch.from_numpy(tokens(cfg, batch=3, seed=4)).long()
    w = torch.tensor(np.random.default_rng(1).standard_normal((3, 16, 32)).astype(np.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}

    got = _grads(model, lambda: (model(x) * w).sum())
    n_layers = cfg["num_layers"]
    assert len(on_card.fwd) == n_layers and len(on_card.bwd) == n_layers
    model.load_state_dict(state)  # undo the BatchNorm statistics update
    _plain_autograd(monkeypatch)
    want = _grads(model, lambda: (model(x) * w).sum())
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        torch.testing.assert_close(g, want[name], rtol=1e-5, atol=1e-6)


def test_reverse_scan_reaches_the_kernel_with_its_flag(on_card):
    """Fault 2: the reverse scan used to raise on the card; it goes to the
    forward kernel's reverse mode, and its gradient to the backward's."""
    a, b, w = _inputs(True, (N,), seed=5)
    ta, tb = _t(a, grad=True), _t(b, grad=True)
    h = diag_linear_scan(ta, tb, reverse=True)
    loss = sum((x * y).sum() for x, y in zip(h, _t(w)))
    got = torch.autograd.grad(loss, ta + tb)
    assert on_card.fwd == [True] and on_card.bwd == [True]
    ra, rb = _t(a, grad=True), _t(b, grad=True)
    ref = diag_scan_plain(ra, rb, reverse=True)
    want = torch.autograd.grad(sum((x * y).sum() for x, y in zip(ref, _t(w))), ra + rb)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-4)


def test_bwd_wrapper_rejects_cpu_tensors_and_counts_nothing():
    a, b, w = (_t(x) for x in _inputs(False, (N,), seed=6))
    before = scan.LAUNCHES["diag_scan_bwd"]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        scan.diag_scan_bwd_cuda(a, b, w)
    assert scan.LAUNCHES["diag_scan_bwd"] == before


# -- the backward kernel's chunk-and-carry fold, emulated ------------------------

SCAN_BWD_SOURCE = Path(scan.__file__).resolve().parent / "csrc" / "diag_scan_bwd.cu"
KSPAN, KCHUNKS = 16, 16  # steps of a chunk, chunks of a round (diag_scan_bwd.cu)
KROUND = KSPAN * KCHUNKS


def _butterfly_rows(x):
    """Σ over dim 0 as the kernels' second launch adds it: lane l of a warp
    adds rows l, l + 32, ... in order, then the 32 sums meet in the xor
    butterfly (16, 8, 4, 2, 1)."""
    lanes = [torch.zeros_like(x[0]) for _ in range(32)]
    for r in range(x.shape[0]):
        lanes[r % 32] = lanes[r % 32] + x[r]
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[l] + lanes[l ^ o] for l in range(32)]
    return lanes[0]


def emulated_scan_bwd(a, h, g, reverse=False):
    """(da, db) as ``diag_scan_bwd.cu`` computes them, in float32, from (re,
    im) planes or real tensors: logical time (flipped where ``reverse``) in
    rounds of KROUND steps taken from the right, each cut into KCHUNKS chunks
    of KSPAN steps; each chunk folded from a zero state into (A, D), last
    step first; the round's chunks folded right to left from the carry of
    the round to its right; each chunk rescanned from the state entering it.
    Steps past L fold as the identity.  da sums each chunk's steps in the
    order they are walked, round after round, then the chunks in order, then
    the batch rows as ``_butterfly_rows`` does; where a varies in time it is
    written per step (and summed over the batch the same way where a is
    shared across it)."""
    pair = isinstance(g, tuple)
    gp = _planes(g)
    shape = gp[0].shape
    B, L, N = math.prod(shape[:-2]), shape[-2], shape[-1]
    flip = (lambda x: x.flip(-2)) if reverse else (lambda x: x)

    def logical(x):  # (B, L, N), logical time order, padded to whole rounds
        x = flip(torch.broadcast_to(x, shape).reshape(B, L, N))
        pad = -L % KROUND
        return torch.cat([x, torch.zeros(B, pad, N)], 1) if pad else x

    a_re, a_im = (logical(p) for p in (_planes(a) if pair else (a, torch.zeros_like(a))))
    g_re, g_im = (logical(p) for p in (gp if pair else (g, torch.zeros_like(g))))
    h_re, h_im = (logical(p) for p in (_planes(h) if pair else (h, torch.zeros_like(h))))
    T = g_re.shape[1]
    t = torch.arange(T)[None, :, None]
    # conj(a_{t+1}); 0 at L - 1; the identity past L
    al_re = torch.where(t + 1 < L, torch.roll(a_re, -1, 1), torch.where(t < L, 0.0, 1.0))
    al_im = torch.where(t + 1 < L, -torch.roll(a_im, -1, 1), torch.zeros(()))
    hp_re, hp_im = (torch.where(t > 0, torch.roll(x, 1, 1), torch.zeros(())) for x in (h_re, h_im))
    R = T // KROUND
    blocks = [x.reshape(B, R, KCHUNKS, KSPAN, N)
              for x in (al_re, al_im, g_re, g_im, hp_re, hp_im)]
    al_re, al_im, g_re, g_im, hp_re, hp_im = blocks

    # pass 1
    A_re, A_im = torch.ones(B, R, KCHUNKS, N), torch.zeros(B, R, KCHUNKS, N)
    D_re, D_im = torch.zeros_like(A_re), torch.zeros_like(A_re)
    for s in range(KSPAN - 1, -1, -1):
        ar, ai = al_re[:, :, :, s], al_im[:, :, :, s]
        D_re, D_im = ar * D_re - ai * D_im + g_re[:, :, :, s], ar * D_im + ai * D_re + g_im[:, :, :, s]
        A_re, A_im = ar * A_re - ai * A_im, ar * A_im + ai * A_re
    # carry
    e_re, e_im = torch.zeros_like(A_re), torch.zeros_like(A_re)
    c_re, c_im = torch.zeros(B, N), torch.zeros(B, N)
    for r in range(R - 1, -1, -1):
        for j in range(KCHUNKS - 1, -1, -1):
            e_re[:, r, j], e_im[:, r, j] = c_re, c_im
            pr, pi = A_re[:, r, j], A_im[:, r, j]
            c_re, c_im = pr * c_re - pi * c_im + D_re[:, r, j], pr * c_im + pi * c_re + D_im[:, r, j]
    # pass 2
    d_re, d_im = torch.zeros_like(g_re), torch.zeros_like(g_re)
    da_re, da_im = torch.zeros_like(g_re), torch.zeros_like(g_re)
    for s in range(KSPAN - 1, -1, -1):
        ar, ai = al_re[:, :, :, s], al_im[:, :, :, s]
        e_re, e_im = ar * e_re - ai * e_im + g_re[:, :, :, s], ar * e_im + ai * e_re + g_im[:, :, :, s]
        d_re[:, :, :, s], d_im[:, :, :, s] = e_re, e_im
        hr, hi = hp_re[:, :, :, s], hp_im[:, :, :, s]
        da_re[:, :, :, s], da_im[:, :, :, s] = e_re * hr + e_im * hi, e_im * hr - e_re * hi

    def physical(x):  # back to (..., L, N) in physical time
        return flip(x.reshape(B, T, N)[:, :L]).reshape(shape)

    db = tuple(physical(x) for x in (d_re, d_im))
    a_shape = _planes(a)[0].shape
    a_full = torch.broadcast_to(_planes(a)[0], shape)
    time_varies = L > 1 and a_full.stride(-2) != 0
    batch_shared = all(s == 1 for s in a_shape[:-2])
    if time_varies:
        das = [flip(x.reshape(B, T, N)[:, :L]) for x in (da_re, da_im)]
    else:  # each chunk's running sum over its rounds and steps, then the chunks in order
        das = []
        for x in (da_re, da_im):
            run = torch.zeros(B, KCHUNKS, N)
            for r in range(R - 1, -1, -1):
                for s in range(KSPAN - 1, -1, -1):
                    run = run + x[:, r, :, s]
            tot = torch.zeros(B, N)
            for j in range(KCHUNKS):
                tot = tot + run[:, j]
            das.append(tot[:, None])
    if batch_shared:
        das = [_butterfly_rows(x) for x in das]
    da = tuple(x.reshape(a_shape) for x in das)
    if pair:
        return da, db
    return da[0], db[0]


def _fold_inputs(complex_mode, a_kind, Lr, seed):
    """B 3, N 24 and L ``Lr`` (not a multiple of the kernel's round), a drawn
    as in ``_inputs`` at the A_SHAPES kind's shape for that L."""
    Br, Nr = 3, 24
    a_shape = {"per_channel": (Nr,), "per_step": (Lr, Nr), "per_example": (Br, Lr, Nr)}[a_kind]
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.9, 0.99, a_shape)
    draw = lambda: rng.standard_normal((Br, Lr, Nr)).astype(np.float32)  # noqa: E731
    if complex_mode:
        th = rng.uniform(0.0, 6.28, a_shape)
        a = ((r * np.cos(th)).astype(np.float32), (r * np.sin(th)).astype(np.float32))
        return a, (draw(), draw()), (draw(), draw())
    return r.astype(np.float32), draw(), draw()


@pytest.mark.parametrize("Lr", [77, 600])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("a_kind", list(A_SHAPES))
@pytest.mark.parametrize("complex_mode", [True, False], ids=["complex", "real"])
def test_kernel_fold_matches_float64_and_jax_grad(complex_mode, a_kind, reverse, Lr):
    """The emulated fold against the float64 plain version and against
    ``jax.grad`` of ``tlie_tpu``'s scan (associative), under the tolerances
    of ``test_backward_matches_jax_grad``: L 77 is one partial round, L 600
    two whole rounds and a partial one."""
    a, b, w = _fold_inputs(complex_mode, a_kind, Lr, seed=Lr + 7 * len(A_SHAPES[a_kind]) + reverse)
    a_shape = _planes(a)[0].shape
    h = diag_scan_plain(_t(a), _t(b), reverse=reverse)
    da, db = emulated_scan_bwd(_t(a), h, _t(w), reverse=reverse)

    as64 = lambda x: tuple(p.double() for p in x) if isinstance(x, tuple) else x.double()  # noqa: E731
    h64 = diag_scan_plain(as64(_t(a)), as64(_t(b)), reverse=reverse)
    da64, db64 = diag_scan_bwd_plain(as64(_t(a)), h64, as64(_t(w)), reverse=reverse)
    want_da, want_db = _jax_grads(a, b, w, "assoc", reverse)

    da_tol = RTOL * _da_scale(a_shape, db, h, reverse)
    for want in (_planes(da64), want_da):
        for g, x in zip(_planes(da), want):
            x = np.asarray(x)
            assert g.shape == x.shape == a_shape
            assert np.all(np.abs(g.numpy() - x) <= da_tol)
    for want in (_planes(db64), want_db):
        db_tol = RTOL * max(np.abs(np.asarray(x)).max() for x in want)
        for g, x in zip(_planes(db), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0, atol=db_tol)


def test_fold_emulation_follows_the_kernel_source():
    src = SCAN_BWD_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSpan") == KSPAN and const("kChunks") == KCHUNKS
    assert "constexpr int kRound = kChunks * kSpan;" in src
    # rounds from the right; each chunk's two passes last step first; the
    # carry right to left over the round's chunks; the chunks' sums in
    # order; the batch rows lane-strided, then the butterfly
    assert "for (int64_t r = rounds - 1; r >= 0; --r) {" in src
    assert src.count("for (int s = kSpan - 1; s >= 0; --s) {") == 2
    assert "for (int j = kChunks - 1; j >= 0; --j) {" in src
    assert "for (int j = 0; j < kChunks; ++j) {" in src
    assert "for (int64_t r = lane; r < rows; r += 32) {" in src
    assert "for (int o = 16; o > 0; o /= 2) {" in src
    # g is loaded once, in the loop that fills the chunk's registers
    assert src.count("g_re[") == 1 and src.count("g_im[") == 1
