"""One training step and the per-batch pieces around it, counterparts of
``tlie_tpu/training/steps.py`` (``cross_entropy_loss``, ``compute_accuracy``,
``prep_batch``, ``train_step``) and of the sparse and fused decoder heads of
``tlie_tpu/training/scan_loop.py`` (:222-269)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.base import masked_accuracy as compute_accuracy
from ..ops.fused_xent import fused_softmax_xent
from .state import clip_by_global_norm_, set_group_learning_rates

IGNORE_IDX = -100


# rows of bfloat16 logits widened to float32 at a time by RowNLLWide
WIDE_ROWS = 1024


class RowNLLWide(torch.autograd.Function):
    """lse − logit[label] of each row of bfloat16 (M, V) logits, reduced in
    float32 as ``tlie_tpu`` reduces them (``steps.py:41-44``, where XLA fuses
    the cast into the reduction): WIDE_ROWS rows are widened at a time, so no
    float32 copy of the whole logits cube is made or kept.  The backward
    recomputes softmax − onehot from the saved bfloat16 logits and the float32
    lse, in float32, and rounds it to bfloat16 once, as the cast's VJP does."""

    @staticmethod
    def forward(ctx, logits, safe):
        lse = torch.cat([torch.logsumexp(logits[r:r + WIDE_ROWS].float(), -1)
                         for r in range(0, logits.shape[0], WIDE_ROWS)])
        picked = torch.gather(logits, -1, safe[:, None])[:, 0].float()
        ctx.save_for_backward(logits, safe, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, safe, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for r in range(0, logits.shape[0], WIDE_ROWS):
            rows = slice(r, r + WIDE_ROWS)
            t = torch.exp(logits[rows].float() - lse[rows, None]) * g[rows, None]
            t.scatter_add_(-1, safe[rows, None], -g[rows, None])
            grad[rows] = t
        return grad, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_idx: int = IGNORE_IDX) -> torch.Tensor:
    """Mean CE over the positions whose label is not ``ignore_idx``:
    logsumexp minus the gathered logit, summed over valid positions and
    divided by their count (at least 1).  bfloat16 logits reduce in float32
    (:class:`RowNLLWide`)."""
    safe = labels.clamp_min(0)
    mask = labels != ignore_idx
    if logits.dtype == torch.bfloat16:
        nll = RowNLLWide.apply(logits.reshape(-1, logits.shape[-1]), safe.reshape(-1))
        ll = -nll.reshape(labels.shape)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
        ll = picked - lse
    ll = torch.where(mask, ll, torch.zeros_like(ll))
    return -ll.sum() / mask.sum().clamp_min(1)


def sparse_positions(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) positions of the valid (non-ignored) labels of each row, in
    index order, then leading invalid positions if a row has fewer than k.
    ``lax.top_k`` on the 0/1 mask breaks ties toward the lower index; a
    stable descending sort gives the same positions (``torch.topk`` promises
    no order among ties)."""
    valid = (labels != IGNORE_IDX).to(torch.int32)
    return torch.sort(valid, dim=1, descending=True, stable=True).indices[:, :k]


def head_logits(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                sparse_k: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, labels) of the decoder head.  With ``sparse_k`` the k valid
    positions of each row are gathered from the backbone features *before*
    the decoder matmul; ignored positions have zero gradient through the
    logits, so the loss and gradients are those of the dense head."""
    if sparse_k is None:
        return model(x), y
    feats = model.features(x)
    pos = sparse_positions(y, sparse_k)
    feats = torch.gather(feats, 1, pos[..., None].expand(-1, -1, feats.shape[-1]))
    return model.decoder(feats), torch.gather(y, 1, pos)


def fused_head_loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The loss through the fused decoder + CE head (``_fused_loss``,
    ``scan_loop.py:252-269``): the backbone features on (B·L, d) rows,
    then ``fused_softmax_xent`` with the decoder's weight read in place
    (``weight.t()``, no copy) and its bias, or zeros where it has none.  The
    features run in the model's own mode, so a training-mode BatchNorm
    updates its running statistics here as in the dense and sparse heads
    (the reference's fused head fails on BatchNorm models; this one does
    not)."""
    feats = model.features(x)
    d = feats.shape[-1]
    dec = model.decoder
    w = dec.weight.t()
    b = dec.bias if dec.bias is not None else torch.zeros(w.shape[1], device=w.device)
    return fused_softmax_xent(feats.reshape(-1, d), w, b, y.reshape(-1))


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, lrs: Dict[str, float],
               sparse_k: Optional[int] = None, fused_head: bool = False,
               clip_norm: Optional[float] = None) -> torch.Tensor:
    """One optimisation step of ``model`` (in training mode) on the batch:
    the group learning rates are set, the gradients zeroed, the loss taken
    (its forward updates the BatchNorm running statistics, as flax's
    ``mutable=["batch_stats"]`` apply does), back-propagated, clipped to
    the global norm ``clip_norm`` where one is given (the Mamba family's
    optax chain), and the optimiser stepped.  The loss goes through the dense head, the sparse
    head (``sparse_k``) or the fused head (``fused_head``), which exclude
    each other.  Returns the loss, detached, on the device."""
    if fused_head and sparse_k is not None:
        raise ValueError("the sparse head is mutually exclusive with the fused head")
    set_group_learning_rates(optimizer, lrs)
    optimizer.zero_grad(set_to_none=True)
    if fused_head:
        loss = fused_head_loss(model, x, y)
    else:
        loss = cross_entropy_loss(*head_logits(model, x, y, sparse_k))
    loss.backward()
    if clip_norm is not None:
        clip_by_global_norm_(model.parameters(), clip_norm)
    optimizer.step()
    return loss.detach()


def prep_batch(batch, seq_len: int, in_dim: int, lang_model: bool = False,
               device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardise a loader batch to (inputs, labels) tensors on ``device``.

    Inputs are right-padded to ``seq_len``.  Integer tokens pass through (the
    encoder gathers their rows); float inputs of width != ``in_dim`` are
    one-hot expanded, as in ``tlie_tpu``.  Padded sequences with per-example
    lengths belong to the pooled classifier, which is not ported yet."""
    if len(batch) == 2:
        inputs, targets = batch
        aux: Dict[str, Any] = {}
    else:
        inputs, targets, aux = batch
    inputs = torch.as_tensor(np.asarray(inputs), device=device)
    targets = torch.as_tensor(np.asarray(targets), device=device)
    lengths = aux.get("lengths") if isinstance(aux, dict) else None
    if lengths is not None and not lang_model and not np.isscalar(lengths):
        raise NotImplementedError("padded classification batches are not ported yet")

    num_pad = seq_len - inputs.shape[1]
    if num_pad > 0:
        pad = [0, 0] * (inputs.dim() - 2) + [0, num_pad]
        inputs = F.pad(inputs, pad)

    if inputs.dim() < 3 and inputs.shape[-1] != in_dim and torch.is_floating_point(inputs):
        inputs = F.one_hot(inputs.long(), in_dim).float()
    return inputs, targets
