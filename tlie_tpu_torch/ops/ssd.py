"""Chunked selective-state-space scan (Mamba-2 / SSD), counterpart of
``tlie_tpu/ops/ssd.py``.  Per head h with state size N and head dim P::

    h_t = exp(dt_t · A_h) · h_{t-1} + dt_t · B_t x_tᵀ        (state: N × P)
    y_t = C_tᵀ h_t + D_h · x_t

with B_t, C_t shared by the heads of a group (ngroups G | H).  Inputs follow
the reference kernel's layout: x (B, L, H, P); dt (B, L, H), already
softplus'd; A (H,) negative; B_mat, C_mat (B, L, G, N); D optional (H,).

The sequence splits into chunks of Q steps.  Inside a chunk the scan is the
causally masked decay attention of :mod:`tlie_tpu_torch.ops.decay_attention`,
which on CUDA tensors always runs the hand-written kernels; across chunks a
short recurrence over the L/Q chunk summaries carries the state, in PyTorch
matmuls and a loop over chunks, as ``tlie_tpu`` computes it outside Pallas.

The decay math (the cumsum of dt·A, its exps, the carried chunk state)
computes in float32 (float64 inputs stay float64, for references on the
CPU).  The products' operands follow ``tlie_tpu``'s ``mm_dtype`` rule: where
x is bfloat16 (``model.compute_dtype: bfloat16``) C, B, xdt and the chunk
summaries' operands are bfloat16 and the decay attention runs its bfloat16
kernels; y comes back in x's dtype.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .decay_attention import decay_attention

# tlie_tpu's operating point: a 75e6-element ceiling for the intra-chunk
# decay tensor on a 16 GB device, scaled by the device's memory
_BUDGET_PER_HBM_BYTE = 75_000_000 / 16e9


def _budget_elements(device="cpu") -> int:
    """Element budget for the intra-chunk decay tensor: ``TLIE_SSD_BUDGET``
    (a count of elements, read as ``tlie_tpu`` reads it) where it is set, on
    every device; else the card's total memory times tlie_tpu's ratio
    (deterministic per device, so the chunk and with it the numerics do not
    depend on what else is allocated); on the CPU, tlie_tpu's default of
    75e6."""
    env = os.environ.get("TLIE_SSD_BUDGET")
    if env:
        return int(float(env))
    dev = torch.device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        return max(1_000_000, int(total * _BUDGET_PER_HBM_BYTE))
    return 75_000_000


def _auto_chunk(B: int, L: int, H: int, device="cpu") -> int:
    """The largest chunk Q ≤ 1024 that divides L and keeps the (B, L, Q, H)
    decay tensor within the budget (``_auto_chunk``)."""
    budget = _budget_elements(device)
    for q in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if q <= L and L % q == 0 and B * L * q * H <= budget:
            return q
    return 1


def _expand_groups(m: torch.Tensor, H: int) -> torch.Tensor:
    """(B, L, G, N) → (B, L, H, N) by repeating each group over its heads."""
    G = m.shape[2]
    return m if G == H else torch.repeat_interleave(m, H // G, dim=2)


def _clamp_dt(dt: torch.Tensor, dt_limit) -> torch.Tensor:
    """Clamp the post-softplus dt to ``dt_limit``; (0, inf), the value of
    every reference config, is a no-op and stays out of the graph."""
    if dt_limit is None or tuple(dt_limit) == (0.0, float("inf")):
        return dt
    return torch.clamp(dt, dt_limit[0], dt_limit[1])


def ssd_recurrent_scan(x, dt, A, B_mat, C_mat, D=None, initial_states=None,
                       dt_limit=None) -> torch.Tensor:
    """Sequential oracle, one time step at a time.  ``initial_states`` is
    (B, H, P, N), the reference's layout."""
    dt = _clamp_dt(dt, dt_limit)
    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    dtype = torch.promote_types(x.dtype, torch.float32)
    Bh = _expand_groups(B_mat, H).to(dtype)
    Ch = _expand_groups(C_mat, H).to(dtype)
    xf, dtf = x.to(dtype), dt.to(dtype)
    if initial_states is None:
        h = torch.zeros(Bsz, H, N, P, device=x.device, dtype=dtype)
    else:
        h = initial_states.transpose(-1, -2).to(dtype)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * A)[..., None, None]
        h = decay * h + (dtf[:, t, :, None, None] * Bh[:, t, :, :, None]) * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, 1).to(x.dtype)
    if D is not None:
        y = y + D[None, None, :, None] * x
    return y


def ssd_chunked_scan(x, dt, A, B_mat, C_mat, chunk_size: Optional[int] = None, D=None,
                     initial_states=None, return_final_state: bool = False, dt_limit=None):
    """Parallel chunked SSD scan (``ssd_chunked_scan``).  ``chunk_size=None``
    picks the chunk by :func:`_auto_chunk` on x's device; ``dt_limit=(lo,
    hi)`` clamps the post-softplus dt; ``initial_states`` (B, H, P, N) enters
    the first chunk; with ``return_final_state`` the state after the last
    step comes back too, as (B, H, P, N).

    B and C stay at group granularity: the scores C·B are computed once per
    group and shared by its H/G heads."""
    dt = _clamp_dt(dt, dt_limit)
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[-1]
    Hg = H // G  # heads per group; head h = g·Hg + hg
    Q = _auto_chunk(Bsz, L, H, x.device) if chunk_size is None else chunk_size
    if L % Q != 0:
        Q = _largest_divisor_chunk(L, Q)
    C = L // Q

    # the decay math in float32 (or wider); the products' operands in
    # bfloat16 where x is (tlie_tpu's mm_dtype)
    dtype = torch.promote_types(x.dtype, torch.float32)
    mm_dtype = x.dtype if x.dtype == torch.bfloat16 else dtype
    xf = x.to(mm_dtype)
    xc = xf.reshape(Bsz, C, Q, G, Hg, P)
    dtc = dt.to(dtype).reshape(Bsz, C, Q, G, Hg)
    Bc = B_mat.to(mm_dtype).reshape(Bsz, C, Q, G, N)
    Cc = C_mat.to(mm_dtype).reshape(Bsz, C, Q, G, N)

    cs = torch.cumsum(dtc * A.reshape(G, Hg), dim=2)  # inclusive within-chunk cumsum
    # dt rides the value side: y(i) = Σ_j C_i·B_j · decay(i, j) · dt_j x_j
    xdt = xc * dtc.to(mm_dtype)[..., None]  # (B, C, Q, G, Hg, P)

    # intra-chunk: the decay attention on (B·C·G, ...) operands.  C and B are
    # views wherever the layout allows (the kernels read their strides); cs
    # and xdt are copied where G or Hg exceed 1 (a no-op at G = Hg = 1)
    Cm = Cc.permute(0, 1, 3, 2, 4).reshape(Bsz * C * G, Q, N)
    Bm = Bc.permute(0, 1, 3, 2, 4).reshape(Bsz * C * G, Q, N)
    cs_t = cs.permute(0, 1, 3, 4, 2).reshape(Bsz * C * G, Hg, Q).contiguous()
    xdt_t = xdt.permute(0, 1, 3, 4, 2, 5).reshape(Bsz * C * G, Hg, Q, P).contiguous()
    yk = decay_attention(Cm, Bm, cs_t, xdt_t)
    y_diag = yk.reshape(Bsz, C, G, Hg, Q, P).permute(0, 1, 4, 2, 3, 5)  # (B, C, Q, G, Hg, P)

    if C == 1 and initial_states is None and not return_final_state:
        # one chunk and a zero entering state: the inter-chunk arm is zero
        y = y_diag.reshape(Bsz, L, H, P)
        if D is not None:
            y = y + D[None, None, :, None] * xf
        return y.to(x.dtype)

    # chunk summaries: the state each chunk contributes at its end, carried
    # in float32 across chunks
    decay_to_end = torch.exp(cs[:, :, -1:] - cs)  # (B, C, Q, G, Hg)
    xw = xdt * decay_to_end.to(mm_dtype)[..., None]
    S = torch.einsum("bcjgn,bcjghp->bcghnp", Bc, xw).to(dtype)

    # the recurrence over the C chunk summaries
    chunk_decay = torch.exp(cs[:, :, -1])  # (B, C, G, Hg)
    if initial_states is None:
        h = torch.zeros(Bsz, G, Hg, N, P, device=x.device, dtype=dtype)
    else:
        h = initial_states.transpose(-1, -2).to(dtype).reshape(Bsz, G, Hg, N, P)
    prev = []
    for c in range(C):
        prev.append(h)
        h = chunk_decay[:, c, :, :, None, None] * h + S[:, c]
    R_prev = torch.stack(prev, 1)  # (B, C, G, Hg, N, P): the state entering each chunk

    # inter-chunk output: the queries against the carried-in state
    y0 = torch.einsum("bcign,bcghnp->bcighp", Cc, R_prev.to(mm_dtype))
    y_off = y0 * torch.exp(cs).to(mm_dtype)[..., None]

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    y = y.to(x.dtype)
    if return_final_state:
        return y, h.reshape(Bsz, H, N, P).transpose(-1, -2)
    return y


def _largest_divisor_chunk(L: int, preferred: int) -> int:
    for c in (preferred, 128, 64, 32, 16, 8, 4, 2, 1):
        if c <= L and L % c == 0:
            return c
    return 1
