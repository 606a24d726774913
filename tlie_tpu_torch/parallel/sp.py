"""Sequence parallelism over processes, counterpart of
``tlie_tpu/parallel/sp.py``: the diagonal linear scan and the causal linear
attention with their time axis split over the ranks of a process group, and
the pooling over time of a sequence so split.

Every rank holds its contiguous time steps ``[rank·L/n, (rank+1)·L/n)`` of
each activation (:meth:`~tlie_tpu_torch.parallel.mesh.Shard.steps`); the
functions here take and give this rank's steps.  Where ``tlie_tpu`` runs
them inside ``shard_map`` over a ``seq`` mesh of one program, the port runs
one process a device and the cross-shard traffic is the collectives of
:mod:`.mesh`, each with autograd.

The scan (:func:`sp_diag_linear_scan`) takes ``tlie_tpu``'s fix-up
(``sp.py:71-81``): each rank scans its steps from a zero state, giving the
states H, and the running products A of its decays; the ranks' last (H, A)
are all-gathered, each rank folds those of the ranks before it into its
incoming state h_in, and its states are ``H + A·h_in``.  H and A come from
one scan of the rank's inputs stacked over the batch with an impulse
(A_t = Π_{s≤t} a_s is the scan of a over an input that is a_0 at the first
step and 0 after it), so on the card each rank launches the forward and the backward scan
kernels once a call, as the one-process run does.  ``reverse=True`` runs
the kernels' reverse mode and takes the carry from the later ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.scan import TensorOrPair, _is_pair, _planes, diag_linear_scan, sequence_parallel


def _cmul(x, y):
    """x·y for (re, im) pairs, or real tensors."""
    if _is_pair(x):
        return x[0] * y[0] - x[1] * y[1], x[0] * y[1] + x[1] * y[0]
    return x * y


def _add(x, y):
    return (x[0] + y[0], x[1] + y[1]) if _is_pair(x) else x + y


def _map(f, x):
    return (f(x[0]), f(x[1])) if _is_pair(x) else f(x)


def _time_last_but_one(a, b, axis: int):
    """(a, b, restore): the operands with their time axis moved to -2 by
    flattening the axes after it into one (a broadcast to b's trailing
    shape first), and the function that gives an output b's layout back."""
    ref = b[0] if _is_pair(b) else b
    ndim = ref.dim()
    axis = axis + ndim if axis < 0 else axis
    if axis == ndim - 2:
        return a, b, lambda h: h
    shape = ref.shape
    flat = (*shape[:axis], shape[axis], math.prod(shape[axis + 1:]))

    def fold(x):
        lead = (1,) * (ndim - x.dim()) + tuple(x.shape)
        x = x.reshape(lead).expand(*lead[:axis + 1], *shape[axis + 1:])
        return x.reshape(*x.shape[:axis + 1], -1)

    def unfold(h):
        return _map(lambda t: t.reshape(shape), h)

    return _map(fold, a), _map(lambda t: t.reshape(flat), b), unfold


def sp_diag_linear_scan(a: TensorOrPair, b: TensorOrPair, shard, *, axis: int = -2,
                        reverse: bool = False) -> TensorOrPair:
    """``diag_linear_scan`` of this rank's time steps, the recurrence running
    across the group of ``shard`` (``sp_diag_linear_scan``,
    ``tlie_tpu/parallel/sp.py:84``): real tensors, (re, im) pairs or complex
    tensors (given back as they came), ``a`` broadcasting to ``b`` (the
    LRU's (N,), Mamba-1's full (B, L, D·N)), time at ``axis``;
    ``reverse=True`` takes the carry from the later ranks (the
    bidirectional S5).  Differentiable in a and b.  The local scan is
    :func:`tlie_tpu_torch.ops.scan.diag_linear_scan` outside the context:
    the kernels on CUDA tensors.  Every rank's time length is L/n."""
    complex_out = not (_is_pair(a) or _is_pair(b)) and (a.is_complex() or b.is_complex())
    pair = complex_out or _is_pair(a) or _is_pair(b)
    if pair:
        a, b = (_split(x) for x in (a, b))
    a, b, restore = _time_last_but_one(a, b, axis)
    h = _fixed_up_scan(a, b, shard, reverse, pair)
    h = restore(h)
    return torch.complex(*h) if complex_out else h


def _split(x):
    """A pair, a real tensor or a complex tensor as a (re, im) pair."""
    if _is_pair(x):
        return x
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def _fixed_up_scan(a, b, shard, reverse: bool, pair: bool):
    planes = b if pair else (b,)
    a_planes = a if pair else (a,)
    shape = planes[0].shape
    Ls, N = shape[-2], shape[-1]
    lead = shape[:-2]
    P = math.prod(lead)
    # a at b's rank; shared over the batch (leading dims all 1) or not
    a_planes = tuple(x.reshape((1,) * (len(shape) - x.dim()) + tuple(x.shape)) for x in a_planes)
    shared = all(s == 1 for s in a_planes[0].shape[:-2])
    Ta = a_planes[0].shape[-2]
    if shared:
        a_q = tuple(x.reshape(1, Ta, x.shape[-1]) for x in a_planes)
        Q = 1
    else:
        a_q = tuple(x.expand(*lead, Ta, x.shape[-1]).reshape(P, Ta, x.shape[-1])
                    for x in a_planes)
        Q = P
    a_rows = a_q if shared else tuple(torch.cat([x, x]) for x in a_q)
    # the A rows' input: the first step's decay a_0 at the first step (the
    # last at the last, reversed), zeros elsewhere, so that A_t = Π_{s≤t} a_s
    end = 0 if reverse else -1
    first = -1 if reverse else 0
    ref = planes[0]
    zeros = torch.zeros(Q, Ls - 1, N, dtype=ref.dtype, device=ref.device)
    b_rows = []
    for x, b_plane in zip(a_q, planes):
        a0 = x[:, first if Ta > 1 else 0].expand(Q, N)[:, None].to(ref.dtype)
        impulse = torch.cat([zeros, a0] if reverse else [a0, zeros], dim=1)
        b_rows.append(torch.cat([b_plane.reshape(P, Ls, N), impulse]))
    b_rows = tuple(b_rows)
    # the local scan: outside the context, so the kernels on CUDA tensors
    with sequence_parallel(None):
        hs = diag_linear_scan(a_rows if pair else a_rows[0], b_rows if pair else b_rows[0],
                              reverse=reverse)
    hs = hs if pair else (hs,)
    H = tuple(x[:P] for x in hs)  # states from a zero carry, (P, Ls, N)
    A = tuple(x[P:] for x in hs)  # running products of a, (Q, Ls, N)
    summary = [x[:, end] for x in A + H]
    sizes = [x.numel() for x in summary]
    gathered = shard.all_gather(torch.cat([x.reshape(-1) for x in summary]))  # (n, Σ sizes)
    parts = [p.reshape(shard.world, *x.shape)
             for p, x in zip(gathered.split(sizes, dim=1), summary)]
    k = len(A)
    A_end, H_end = tuple(parts[:k]), tuple(parts[k:])
    # this rank's incoming state: the carries of the ranks before it (after
    # it, reversed), folded in their order; every rank folds every slot,
    # masked, so that each rank's graph holds the whole gathered tensor
    ranks = torch.arange(shard.world, device=ref.device)
    takes = ranks > shard.rank if reverse else ranks < shard.rank
    order = range(shard.world - 1, -1, -1) if reverse else range(shard.world)
    carry = tuple(torch.zeros_like(x[0]) for x in H_end)
    for s in order:
        step = _add(_cmul(_pick(A_end, s), _unpair(carry)), _pick(H_end, s))
        carry = tuple(torch.where(takes[s], n, c) for n, c in zip(_planes(step), carry))
    h_in = tuple(c[:, None] for c in carry)  # (P, 1, N)
    h = _add(_unpair(H), _cmul(_unpair(A), _unpair(h_in)))
    return _map(lambda t: t.reshape(shape), h) if pair else h.reshape(shape)


def _unpair(planes: tuple):
    return planes if len(planes) == 2 else planes[0]


def _pick(planes: tuple, s: int):
    return _unpair(tuple(x[s] for x in planes))


def sp_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shard, *,
                        scale: float = 1.0, return_normalizer: bool = False,
                        eps: Optional[float] = None):
    """Causal linear attention of this rank's time steps (q, k (B, L/n, H,
    Dk), v (B, L/n, H, Dv)) across the group (``sp_linear_attention``,
    ``tlie_tpu/parallel/sp.py:196``): the chunked form on the rank's steps,
    plus its queries against the KV state Σ scale·k vᵀ of the ranks before
    it, accumulated in float32 and all-gathered once; with
    ``return_normalizer`` the normaliser n_t = q_t · Σ_{s≤t} scale·k_s
    takes the key sums of the earlier ranks the same way, and ``eps``
    replaces an exact-zero n_t.  Differentiable in q, k and v."""
    from ..ops.linear_attention import chunked_linear_attention

    f32 = torch.promote_types(k.dtype, torch.float32)
    # the local chunked form, outside the context (it routes back here)
    with sequence_parallel(None):
        local = chunked_linear_attention(q, k, v, scale=scale,
                                         return_normalizer=return_normalizer)
    y_local, n_local = local if return_normalizer else (local, None)
    S = torch.einsum("blhd,blhe->bhde", (k * scale).float(), v.float())  # (B, H, Dk, Dv)
    parts = [S]
    if return_normalizer:
        parts.append((k.to(f32) * scale).sum(dim=1))  # (B, H, Dk)
    sizes = [x.numel() for x in parts]
    gathered = shard.all_gather(torch.cat([x.reshape(-1).to(torch.float32) for x in parts]))
    earlier = (torch.arange(shard.world, device=q.device) < shard.rank).to(gathered.dtype)
    summed = earlier @ gathered  # the sum over the ranks before this one
    pieces = summed.split(sizes)
    S_in = pieces[0].reshape(S.shape).to(q.dtype)
    y = y_local + torch.einsum("blhd,bhde->blhe", q, S_in)
    if not return_normalizer:
        return y
    k_in = pieces[1].reshape(parts[1].shape).to(f32)
    n = n_local + torch.einsum("blhd,bhd->blh", q.to(f32), k_in)
    if eps is not None:
        n = torch.where(n == 0, torch.full((), eps, dtype=n.dtype, device=n.device), n)
    return y, n


def sp_inputs(x, shard):
    """This rank's time steps of a model's input batch: integer tokens (B,
    L) or a dual model's pairs (B, 2, L) along their last axis, float
    features (B, L, ...) along axis 1, and of a padded batch ``(tokens,
    lengths)`` the tokens (the lengths are the whole sequence's)."""
    if isinstance(x, tuple):
        return (sp_inputs(x[0], shard), *x[1:])
    pairs = x.dim() == 3 and not torch.is_floating_point(x)
    return shard.steps(x, 2 if pairs else 1)


def sp_pool(x: torch.Tensor, how: str, shard, lengths: Optional[torch.Tensor] = None):
    """x (..., L/n, d), this rank's steps, pooled over the whole sequence the
    group holds (time at -2), the same (..., d) on every rank, differentiable
    through the group's sums: ``mean`` (over each row's first ``lengths``
    positions where lengths are given, the padded SSM backbone's masked
    mean), ``sum``, ``max``, ``last`` (the last rank's last step) or ``cls``
    (the first rank's first step)."""
    Ls = x.shape[-2]
    if how == "mean" and lengths is not None:
        pos = shard.rank * Ls + torch.arange(Ls, device=x.device)
        mask = pos[None, :] < lengths[:, None]
        return shard.sum_with_grad((mask[..., None] * x).sum(-2)) / lengths[:, None]
    if how == "mean":
        return shard.sum_with_grad(x.sum(dim=-2)) / (Ls * shard.world)
    if how == "sum":
        return shard.sum_with_grad(x.sum(dim=-2))
    if how == "max":
        return shard.all_gather(x.amax(dim=-2)).amax(dim=0)
    if how in ("last", "cls"):
        mine = torch.tensor(shard.rank == (shard.world - 1 if how == "last" else 0),
                            device=x.device)
        step = x[..., -1 if how == "last" else 0, :]
        return shard.sum_with_grad(torch.where(mine, step, torch.zeros_like(step)))
    raise ValueError(f"unknown pooling {how!r}")


def sp_causal_conv(x: torch.Tensor, conv, k: int, shard) -> torch.Tensor:
    """A causal convolution of width k + 1 over this rank's steps x (B,
    L/n, C) as the whole sequence would give it: ``conv`` (the
    one-process convolution, zero history) applied to the previous ranks'
    last k steps (:meth:`~tlie_tpu_torch.parallel.mesh.Shard.halo`)
    followed by x, and the halo's outputs dropped."""
    if k == 0:
        return conv(x)
    y = conv(torch.cat([shard.halo(x, k), x], dim=1))
    return y[:, k:]
