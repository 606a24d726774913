"""One training step and the per-batch pieces around it, counterparts of
``tlie_tpu/training/steps.py`` (``cross_entropy_loss``, ``compute_accuracy``,
``prep_batch``, ``train_step``) and of the sparse decoder head of
``tlie_tpu/training/scan_loop.py`` (:222-250)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.mqar import masked_accuracy as compute_accuracy
from .state import set_group_learning_rates

IGNORE_IDX = -100


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_idx: int = IGNORE_IDX) -> torch.Tensor:
    """Mean CE over the positions whose label is not ``ignore_idx``:
    logsumexp minus the gathered logit, summed over valid positions and
    divided by their count (at least 1)."""
    logits = logits.float()
    safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    mask = labels != ignore_idx
    ll = torch.where(mask, picked - lse, torch.zeros_like(lse))
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


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, lrs: Dict[str, float],
               sparse_k: Optional[int] = None) -> torch.Tensor:
    """One optimisation step of ``model`` (in training mode) on the batch:
    the group learning rates are set, the gradients zeroed, the loss taken
    (its forward updates the BatchNorm running statistics, as flax's
    ``mutable=["batch_stats"]`` apply does), back-propagated, and the
    optimiser stepped.  Returns the loss, detached, on the device."""
    set_group_learning_rates(optimizer, lrs)
    optimizer.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(*head_logits(model, x, y, sparse_k))
    loss.backward()
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
