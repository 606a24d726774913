"""Causal linear attention, counterpart of ``tlie_tpu/ops/linear_attention.py``:
an undecayed running KV state S_t = S_{t-1} + scale·k_t v_tᵀ read by each
query, o_t = S_tᵀ q_t (the current step included).

:func:`recurrent_linear_attention` is the step-by-step form: the oracle, and
the algebra of one decode step.  :func:`chunked_linear_attention` is the
form the models run, the reference's chunk algebra in PyTorch matmuls: a
masked (Q × Q) score product within each chunk, and the exclusive prefix sum
of the per-chunk KV summaries, accumulated in at least float32, contracted
with the queries.  On the TPU this op is XLA einsums outside any Pallas
kernel, so the port computes it with PyTorch's own products on either
device.

Conventions: q, k are (B, L, H, Dk); v is (B, L, H, Dv); outputs (B, L, H,
Dv).  Under the ``sequence_parallel`` context of :mod:`.scan`,
:func:`chunked_linear_attention` runs
:func:`tlie_tpu_torch.parallel.sp.sp_linear_attention` on this rank's time
steps instead (``linear_attention.py:74-84``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .scan import sp_shard

_DEFAULT_CHUNK = 128


def recurrent_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float = 1.0) -> torch.Tensor:
    """Sequential oracle and decode algebra (``recurrent_linear_attention``):
    S_t = S_{t-1} + scale·k_t v_tᵀ, o_t = S_tᵀ q_t, S in v's dtype."""
    k = k * scale
    B, L, H, Dk = q.shape
    S = torch.zeros(B, H, Dk, v.shape[-1], dtype=v.dtype, device=v.device)
    out = []
    for t in range(L):
        S = S + k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhd,bhde->bhe", q[:, t], S))
    return torch.stack(out, dim=1)


def _f32(dtype: torch.dtype) -> torch.dtype:
    """``jnp.promote_types(dtype, float32)``: float32 or wider."""
    return torch.promote_types(dtype, torch.float32)


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float = 1.0, chunk: int = _DEFAULT_CHUNK,
                             return_normalizer: bool = False, eps: Optional[float] = None):
    """Chunked causal linear attention (``chunked_linear_attention``).

    With ``return_normalizer`` it also returns n_t = q_t · Σ_{s≤t} k_s (B, L,
    H) in at least float32, from the same chunked quantities: for float32
    inputs the row sums of the masked scores and the prefix of the per-chunk
    key totals; for narrower inputs from q and a cumulative sum of k upcast
    to float32, so the denominator keeps full precision.  ``eps`` replaces
    an exact-zero n_t.  Under an active ``sequence_parallel`` context (of
    :mod:`.scan`) q, k and v are this rank's time steps and the attention
    spans the group (:func:`~tlie_tpu_torch.parallel.sp.sp_linear_attention`,
    which gives the same numbers up to float reassociation)."""
    shard = sp_shard()
    if shard is not None:
        from ..parallel.sp import sp_linear_attention

        return sp_linear_attention(q, k, v, shard, scale=scale,
                                   return_normalizer=return_normalizer, eps=eps)
    B, L, H, Dk = q.shape
    Dv = v.shape[-1]
    if L % chunk != 0:
        chunk = _pick_chunk(L, chunk)
    C = L // chunk

    k = k * scale
    qc = q.reshape(B, C, chunk, H, Dk)
    kc = k.reshape(B, C, chunk, H, Dk)
    vc = v.reshape(B, C, chunk, H, Dv)

    # intra-chunk: causal masked scores within each chunk
    att = torch.einsum("bcihd,bcjhd->bchij", qc, kc)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    att = torch.where(causal, att, torch.zeros((), dtype=att.dtype, device=att.device))
    y_intra = torch.einsum("bchij,bcjhe->bcihe", att, vc)

    # inter-chunk: the exclusive prefix sum of the per-chunk KV summaries,
    # accumulated in at least float32, contracted in the inputs' dtype
    S = torch.einsum("bcjhd,bcjhe->bchde", kc, vc)
    S = S.to(_f32(S.dtype))
    S_prefix = (torch.cumsum(S, dim=1) - S).to(q.dtype)
    y_inter = torch.einsum("bcihd,bchde->bcihe", qc, S_prefix)

    y = (y_intra + y_inter).reshape(B, L, H, Dv)
    if not return_normalizer:
        return y

    f32 = _f32(k.dtype)
    if f32 == k.dtype:
        # full-precision inputs: the masked scores already hold q_i·k_j
        n_intra = att.sum(dim=-1)  # (B, C, H, Q)
        k_sum = kc.sum(dim=2)  # (B, C, H, Dk) per-chunk key totals
    else:
        # narrow inputs: Σ_{j≤i} q_i·k_j from q and an inclusive cumsum of k
        # in float32, not from the rounded scores
        k_incl = torch.cumsum(kc.to(f32), dim=2)
        n_intra = torch.einsum("bcihd,bcihd->bchi", qc.to(f32), k_incl)
        k_sum = k_incl[:, :, -1]
    k_prefix = torch.cumsum(k_sum, dim=1) - k_sum  # exclusive
    n_inter = torch.einsum("bcihd,bchd->bchi", qc.to(f32), k_prefix)
    n = torch.movedim(n_intra + n_inter, -1, 2).reshape(B, L, H)
    if eps is not None:
        n = torch.where(n == 0, torch.full((), eps, dtype=n.dtype, device=n.device), n)
    return y, n


def cumulative_key_normalizer(q: torch.Tensor, k: torch.Tensor,
                              eps: Optional[float] = None) -> torch.Tensor:
    """n_t = q_t · Σ_{s≤t} k_s (``cumulative_key_normalizer``), (B, L, H) in
    at least float32 whatever the inputs' dtype."""
    f32 = _f32(k.dtype)
    k_cum = torch.cumsum(k.to(f32), dim=1)
    n = torch.einsum("blhd,blhd->blh", q.to(f32), k_cum)
    if eps is not None:
        n = torch.where(n == 0, torch.full((), eps, dtype=n.dtype, device=n.device), n)
    return n


def _pick_chunk(L: int, preferred: int) -> int:
    """The chunk the reference picks for an L its preferred chunk does not
    divide: the first of (preferred, 64, 32, ..., 1) that does."""
    for c in (preferred, 64, 32, 16, 8, 4, 2, 1):
        if c <= L and L % c == 0:
            return c
    return 1
