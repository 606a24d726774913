"""The ``vmap`` rules of the kernels' ``autograd.Function``\\ s
(``DiagScanFn``, ``DecayAttentionFn``, ``FlashAttentionFn`` and their
backward Functions), through the plain versions on the CPU: G = 3 points
with their own operands under ``vmap(grad_and_value(...))``, as a stacked
sweep runs them, against each point's own call, the output and every
gradient, in float64 and float32.  The decay of the scan is a per-point
parameter (the LRU's and S5's (N,) Λ, stacked (G, N)), so its gradient must
come back summed over each point's own batch and never across points.  Each
rule calls its Function once for the grid: the plain versions are counted
as the kernels' wrappers count launches on the card.

Tolerances: float64 within 1e-12 relative to each tensor's max (the same
products, batched, summed in another order at most); float32 within 1e-5 of
each tensor's max (the plain versions' float32 sums over up to Q or L terms
in another order).
"""

import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from tlie_tpu_torch.ops import attention as attn_mod
from tlie_tpu_torch.ops import decay_attention as decay_mod
from tlie_tpu_torch.ops import scan as scan_mod
from tlie_tpu_torch.ops.attention import causal_softmax_attention
from tlie_tpu_torch.ops.decay_attention import decay_attention
from tlie_tpu_torch.ops.scan import diag_linear_scan

torch.set_num_threads(1)

G = 3
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = [torch.float64, torch.float32]
IDS = ["float64", "float32"]


def _count(monkeypatch, module, names):
    """Wrap ``module``'s plain versions ``names`` to count their calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


def _close(got, want, dtype, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= RTOL[dtype] * scale, f"{what}: {err:.3e} of max {scale:.3e}"


def _per_point(loss, args):
    """Each point's loss and gradients of ``loss`` in all ``args`` (lists of
    (G, ...) tensors), by autograd on the point's own slices."""
    out = []
    for i in range(G):
        leaves = [[t[i].clone().requires_grad_() for t in group] for group in args]
        value = loss(*leaves)
        value.backward()
        out.append((value.detach(), [[t.grad for t in group] for group in leaves]))
    return out


def _check_grid(loss, args, dtype):
    (grads, values) = vmap(grad_and_value(loss, argnums=tuple(range(len(args)))))(*args)
    for i, (value, point_grads) in enumerate(_per_point(loss, args)):
        _close(values[i], value, dtype, f"loss of point {i}")
        for group, want_group in zip(grads, point_grads):
            for got, want in zip(group, want_group):
                _close(got[i], want, dtype, f"gradient of point {i}")


# -- the scan -----------------------------------------------------------------------

@pytest.mark.parametrize("decay", ["per_point_N", "per_example_B1N", "full_BLN"])
@pytest.mark.parametrize("pair", [False, True], ids=["real", "pair"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_scan_rule_matches_each_point(monkeypatch, dtype, pair, decay):
    """The scan forward and reverse, real and (re, im) pairs, with a decay
    of each point's own: (N,) as the LRU and S5 hold it, (B, 1, N) and
    Mamba-1's (B, L, N).  The grid takes one forward and one backward call
    per direction."""
    calls = _count(monkeypatch, scan_mod, ["diag_scan_plain", "diag_scan_bwd_plain"])
    B, L, N = 2, 9, 5
    shape = {"per_point_N": (N,), "per_example_B1N": (B, 1, N), "full_BLN": (B, L, N)}[decay]
    rng = np.random.default_rng(7)
    planes = 2 if pair else 1
    a = [torch.from_numpy(rng.uniform(-0.95, 0.95, (G,) + shape)).to(dtype) for _ in range(planes)]
    b = [torch.from_numpy(rng.standard_normal((G, B, L, N))).to(dtype) for _ in range(planes)]
    w = torch.from_numpy(rng.standard_normal((B, L, N))).to(dtype)

    def loss(a, b):
        aa, bb = (tuple(a), tuple(b)) if pair else (a[0], b[0])
        total = 0.0
        for reverse in (False, True):
            h = diag_linear_scan(aa, bb, reverse=reverse)
            h = h[0] * 1.25 - h[1] * 0.5 if pair else h
            total = total + (h * h * w).sum()
        return total

    (ga, gb), _ = vmap(grad_and_value(loss, argnums=(0, 1)))(a, b)
    # the plain backward runs the plain scan once inside
    assert calls == {"diag_scan_plain": 2 + 2, "diag_scan_bwd_plain": 2}
    assert ga[0].shape == (G,) + shape  # summed per point, never across points
    _check_grid(loss, [a, b], dtype)


def test_scan_rule_takes_an_operand_the_grid_shares():
    """A decay that no point owns (unbatched under vmap) is expanded over
    the grid: each point's gradient is its own sum, and the per-point
    inputs' gradients are those of separate calls."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(-0.9, 0.9, (4,)))
    b = torch.from_numpy(rng.standard_normal((G, 2, 6, 4)))

    def loss(a, b):
        return (diag_linear_scan(a, b) ** 2).sum()

    ga, _ = vmap(grad_and_value(loss), in_dims=(None, 0))(a, b)
    for i in range(G):
        ai = a.clone().requires_grad_()
        loss(ai, b[i]).backward()
        torch.testing.assert_close(ga[i], ai.grad, rtol=1e-12, atol=0)


# -- the decay attention ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_decay_attention_rule_matches_each_point(monkeypatch, dtype):
    """C and B as strided views of one projection (as the SSD slices them),
    cs and xdt contiguous, each point its own: y and all four gradients;
    one forward, one bwd_i and one bwd_j call for the grid."""
    calls = _count(monkeypatch, decay_mod, ["decay_attention_plain", "decay_attention_bwd_i_plain",
                                            "decay_attention_bwd_j_plain"])
    BG, Q, N, Hg, P = 2, 11, 6, 2, 5
    rng = np.random.default_rng(9)
    cb = torch.from_numpy(rng.standard_normal((G, BG, Q, 2 * N + 3))).to(dtype)
    cs = torch.from_numpy(np.cumsum(-rng.uniform(0, 0.3, (G, BG, Hg, Q)), -1)).to(dtype)
    xdt = torch.from_numpy(rng.standard_normal((G, BG, Hg, Q, P))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((BG, Hg, Q, P))).to(dtype)

    def loss(cb, cs, xdt):
        (cb,), (cs,), (xdt,) = cb, cs, xdt
        y = decay_attention(cb[..., :N], cb[..., N + 3:], cs, xdt)
        return (y * y * w).sum()

    vmap(grad_and_value(loss, argnums=(0, 1, 2)))([cb], [cs], [xdt])
    assert calls == dict.fromkeys(calls, 1)
    _check_grid(loss, [[cb], [cs], [xdt]], dtype)


def test_decay_attention_rule_on_bfloat16_operands():
    """The bfloat16 plain version under the rule (the card's bf16 kernels
    take the same Function): y and the gradients equal each point's own
    call bit for bit (the same rounding points on the same values)."""
    BG, Q, N, Hg, P = 2, 8, 4, 2, 3
    rng = np.random.default_rng(10)
    C, Bm = (torch.from_numpy(rng.standard_normal((G, BG, Q, N))).bfloat16() for _ in range(2))
    cs = torch.from_numpy(np.cumsum(-rng.uniform(0, 0.3, (G, BG, Hg, Q)), -1)).float()
    xdt = torch.from_numpy(rng.standard_normal((G, BG, Hg, Q, P))).bfloat16()

    def loss(C, Bm, cs, xdt):
        return decay_attention(C, Bm, cs, xdt).float().pow(2).sum()

    grads, values = vmap(grad_and_value(loss, argnums=(0, 1, 2, 3)))(C, Bm, cs, xdt)
    for i in range(G):
        leaves = [t[i].clone().requires_grad_() for t in (C, Bm, cs, xdt)]
        value = loss(*leaves)
        value.backward()
        assert torch.equal(values[i], value)
        for got, leaf in zip(grads, leaves):
            assert torch.equal(got[i], leaf.grad)


# -- the flash attention ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_flash_attention_rule_matches_each_point(monkeypatch, dtype):
    """q, k, v as strided views of one projection (as ``MHA`` splits them),
    each point its own: o and dq, dk, dv; one forward, one dK/dV and one dQ
    call for the grid."""
    calls = _count(monkeypatch, attn_mod, ["flash_attention_plain", "flash_attention_bwd_dkv_plain",
                                           "flash_attention_bwd_dq_plain"])
    B, L, H, D = 2, 13, 2, 4
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((G, B, L, 3, H, D))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((B, L, H, D))).to(dtype)

    def loss(qkv):
        (qkv,) = qkv
        o = causal_softmax_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return (o * o * w).sum()

    vmap(grad_and_value(loss))([qkv])
    assert calls == dict.fromkeys(calls, 1)
    _check_grid(loss, [[qkv]], dtype)


def test_rules_leave_the_unstacked_call_as_it_was(monkeypatch):
    """Outside ``vmap`` each Function calls its plain versions on the
    operands as given, once each, and ``causal_softmax_attention`` returns o
    alone."""
    calls = _count(monkeypatch, attn_mod, ["flash_attention_plain"])
    q, k, v = (torch.randn(1, 5, 1, 4, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    o = causal_softmax_attention(q, k, v)
    assert isinstance(o, torch.Tensor) and o.shape == q.shape and calls["flash_attention_plain"] == 1
    o.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_chip_smoke_vmap_rules_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.vmap_rules_phase`` at tiny shapes on the CPU, with the
    card's timers stubbed and every kernel wrapper counting a plain version:
    each rule's grid against the points' own calls with one launch of each
    kernel for the grid, then each kernel timed at the folded shape."""
    from torch_parity import load_chip_smoke, stub_card

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True, scan_kernels=True, attention_kernels=True)
    for name, value in (("VMAP_SCAN_SHAPE", (2, 9, 5)), ("VMAP_DECAY_SHAPE", (2, 11, 6, 1, 5)),
                        ("VMAP_DECAY_BF16_SHAPE", (2, 8, 4, 2, 3)),
                        ("VMAP_ATTN_SHAPE", (2, 13, 1, 4))):
        monkeypatch.setattr(cs, name, value)
    folded = cs.vmap_rules_phase(torch.device("cpu"), torch.empty(16))
    assert set(folded) == {"diag_scan", "diag_scan_bwd", "decay_attention_fwd",
                           "decay_attention_bwd_i", "decay_attention_bwd_j",
                           "decay_attention_fwd_bf16", "decay_attention_bwd_i_bf16",
                           "decay_attention_bwd_j_bf16", "flash_attention_fwd",
                           "flash_attention_bwd_dkv", "flash_attention_bwd_dq"}
