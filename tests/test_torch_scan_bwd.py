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
