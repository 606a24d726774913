"""Ring attention: causal softmax attention with the time axis split over
the ranks of a process group, counterpart of ``tlie_tpu/parallel/ring.py``.

Each rank keeps its query block (its time steps) and the key/value blocks
travel round the ring, one hop a step (:meth:`~tlie_tpu_torch.parallel.mesh.Shard.ring_shift`,
``lax.ppermute`` to rank + 1 in ``ring.py:79-80``), while an online softmax
in float32 (running row max m, normaliser l, output accumulator) folds each
arriving block in.  The block arriving at step s on rank i is block
j = (i − s) mod n: the diagonal block (j = i, step 0) is masked causally,
earlier blocks (j < i) are taken whole, later ones (j > i) are masked
entirely and contribute exp(−inf) = 0, as in ``tlie_tpu``.  The products are
``torch.einsum``: ``tlie_tpu`` computes them with XLA einsums outside any
Pallas kernel.  The gradient is autograd's through the online softmax and the
ring's shifts, whose backward sends the gradients back the other way; every
rank computes every block, masked, so every rank's graph holds every shift.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shard, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causal softmax attention (``ring_causal_attention``,
    ``tlie_tpu/parallel/ring.py:88``) of this rank's time steps, q and k
    (B, L/n, H, Dk), v (B, L/n, H, Dv), against the keys and values of the
    whole sequence the group holds; (B, L/n, H, Dv) in v's dtype,
    differentiable in q, k and v.  ``scale`` defaults to 1/√Dk."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n, idx = shard.world, shard.rank
    B, Lb, H, Dv = v.shape
    Dk = k.shape[-1]
    qf = q.float()
    m = torch.full((B, Lb, H), -math.inf, device=q.device)
    l = torch.zeros(B, Lb, H, device=q.device)
    acc = torch.zeros(B, Lb, H, Dv, device=q.device)
    causal = torch.ones(Lb, Lb, dtype=torch.bool, device=q.device).tril()
    kv = torch.cat([k, v], dim=-1)  # one message a hop
    for s in range(n):
        if s:
            kv = shard.ring_shift(kv)
        j = (idx - s) % n
        k_cur, v_cur = kv[..., :Dk], kv[..., Dk:]
        scores = torch.einsum("bthd,bshd->bths", qf, k_cur.float() * scale)  # (B, Lb, H, Lb)
        allowed = causal if j == idx else torch.full_like(causal, j < idx)
        scores = torch.where(allowed[None, :, None, :], scores,
                             torch.full((), -math.inf, device=q.device))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # a row with nothing allowed yet keeps m = -inf: guard the exp
        # against inf − inf (ring.py:71-74)
        safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(torch.where(torch.isfinite(scores), scores - safe_m[..., None],
                                  torch.full((), -math.inf, device=q.device)))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bths,bshd->bthd", p, v_cur.float())
        m = m_new
    # every query row attends at least to itself (the diagonal block): l > 0
    return (acc / l[..., None]).to(v.dtype)
