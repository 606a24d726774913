"""Batch preparation and accuracy for evaluation, counterparts of
``tlie_tpu/training/steps.py::prep_batch`` and ``compute_accuracy``.  The
optimiser and the train step come with the training slice."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.mqar import masked_accuracy as compute_accuracy

IGNORE_IDX = -100


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
