"""The pieces of ``tlie_tpu/training/scan_loop.py`` the training loop uses,
without its ``lax.scan`` blocks: PyTorch runs one step at a time, so a block
of steps is a Python loop (``loop.py``).

Both splits live on the device as integer tensors (:func:`put_dataset`) and
each step gathers its batch by index, from the (steps, batch) index matrix
that :func:`batch_indices` draws on the host exactly as ``tlie_tpu`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .steps import compute_accuracy, cross_entropy_loss, head_logits


class DeviceData(NamedTuple):
    inputs: torch.Tensor  # (n, L) tokens
    labels: torch.Tensor  # (n, L) labels, -100 where ignored


def put_dataset(inputs: np.ndarray, labels: np.ndarray, device) -> DeviceData:
    """Move a whole split of integer tokens and labels to ``device`` (once)."""
    if not (np.issubdtype(inputs.dtype, np.integer) and np.issubdtype(labels.dtype, np.integer)):
        raise NotImplementedError("only integer-token splits are ported yet")
    return DeviceData(torch.as_tensor(inputs, dtype=torch.long, device=device),
                      torch.as_tensor(labels, dtype=torch.long, device=device))


def sparse_head_k_for(model_cfg, train_labels, test_labels=None) -> Optional[int]:
    """K for the sparse decoder head, or None where it does not apply
    (copied from ``tlie_tpu``): per-position decoders with 2-D (B, L)
    labels at least 4× sparse in valid (non −100) entries.  K is the most
    valid labels of any row over both splits, so no valid label is dropped
    from the loss or the metric."""
    per_pos = (
        not model_cfg.get("classifier", False)
        and not model_cfg.get("dual", False)
        and (
            model_cfg.get("layer") == "transformer"
            or model_cfg.get("pooling") == "none"
        )
    )
    if not per_pos:
        return None
    tr = np.asarray(train_labels)
    if tr.ndim != 2:
        return None
    kmax = int((tr != -100).sum(axis=1).max())
    if test_labels is not None:
        te = np.asarray(test_labels)
        if te.ndim == 2:
            if te.shape[1] != tr.shape[1]:
                return None
            kmax = max(kmax, int((te != -100).sum(axis=1).max()))
    return kmax if 0 < kmax * 4 <= tr.shape[1] else None


def batch_indices(rng: np.random.Generator, n: int, batch_size: int, k_steps: int) -> np.ndarray:
    """(k_steps, batch_size) sample indices: epoch-shuffled without
    replacement, re-permuted across epoch boundaries (copied from
    ``tlie_tpu``, so the same generator gives the same batches)."""
    out = np.empty((k_steps, batch_size), dtype=np.int32)
    produced = 0
    while produced < k_steps:
        order = rng.permutation(n)
        n_batches = n // batch_size
        take = min(n_batches, k_steps - produced)
        out[produced : produced + take] = order[: take * batch_size].reshape(
            take, batch_size
        )
        produced += take
    return out


def eval_indices(n: int, batch_size: int) -> np.ndarray:
    """The test split in ``n // batch_size`` full batches (at least one);
    the remainder is not evaluated, as in ``tlie_tpu``."""
    n_batches = max(1, n // batch_size)
    return np.arange(n_batches * batch_size, dtype=np.int32).reshape(
        n_batches, batch_size
    )


@torch.no_grad()
def evaluate(eval_model: nn.Module, data: DeviceData, idx: torch.Tensor,
             sparse_k: Optional[int]) -> Tuple[float, float]:
    """(mean loss, mean masked accuracy) over the batches of ``idx``: the
    means of the per-batch values, as ``make_eval_block`` takes them."""
    losses, metrics = [], []
    for idx_t in idx:
        logits, y = head_logits(eval_model, data.inputs[idx_t], data.labels[idx_t], sparse_k)
        losses.append(cross_entropy_loss(logits, y))
        metrics.append(compute_accuracy(logits, y))
    return float(torch.stack(losses).mean()), float(torch.stack(metrics).mean())
