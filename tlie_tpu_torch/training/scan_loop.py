"""The pieces of ``tlie_tpu/training/scan_loop.py`` the training loop uses,
without its ``lax.scan`` blocks: PyTorch runs one step at a time, so a block
of steps is a Python loop (``loop.py``).

Both splits live on the device (:func:`put_dataset`): integer tokens as
int64, float features (CIFAR's pixels) as float32, as ``tlie_tpu`` puts
them.  Each step gathers its batch by index (:func:`gather_batch`), from
the (steps, batch) index matrix that :func:`batch_indices` draws on the
host exactly as ``tlie_tpu`` does.  A padded split (ListOps, IMDB) carries
its per-example lengths, gathered with each batch into the ``(inputs,
lengths)`` input of the padded model (``scan_loop.py:143-149``): the SSM
backbone's masked pool reads them, the Mamba and transformer families drop
them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .steps import compute_accuracy, cross_entropy_loss, head_logits, seq_head_logits


class DeviceData(NamedTuple):
    inputs: torch.Tensor  # (n, L) int64 tokens or (n, L, d) float32 features
    labels: torch.Tensor  # (n, L) labels, -100 where ignored, or (n,) classes
    lengths: Optional[torch.Tensor] = None  # (n,) float32 for a padded split


def put_dataset(inputs: np.ndarray, labels: np.ndarray, device,
                lengths: Optional[np.ndarray] = None) -> DeviceData:
    """Move a whole split to ``device`` (once): integer inputs as int64
    tokens, float inputs as float32 (``tlie_tpu/training/scan_loop.py:56-62``,
    int32 there), the labels as int64, and the lengths of a padded split as
    float32 (exact below 2^24).  Labels that are not integers raise."""
    if not np.issubdtype(labels.dtype, np.integer):
        raise TypeError(f"labels must be integers, not {labels.dtype}")
    in_dtype = torch.long if np.issubdtype(inputs.dtype, np.integer) else torch.float32
    return DeviceData(
        torch.as_tensor(inputs, dtype=in_dtype, device=device),
        torch.as_tensor(labels, dtype=torch.long, device=device),
        None if lengths is None else torch.as_tensor(lengths, dtype=torch.float32,
                                                     device=device))


def gather_batch(data: DeviceData, idx: torch.Tensor):
    """(x, y) of the examples ``idx``: x is the inputs, or ``(tokens,
    lengths)`` where the split is padded (``_gather_batch``)."""
    x = data.inputs[idx]
    if data.lengths is not None:
        x = (x, data.lengths[idx])
    return x, data.labels[idx]


def per_position(model_cfg) -> bool:
    """A decoder on every position: no classifier, not dual, and the
    transformer or ``pooling: none`` (``tlie_tpu/training/loop.py:292-300``,
    the gate the sparse and fused heads share)."""
    return (
        not model_cfg.get("classifier", False)
        and not model_cfg.get("dual", False)
        and (model_cfg.get("layer") == "transformer" or model_cfg.get("pooling") == "none")
    )


def sparse_head_k_for(model_cfg, train_labels, test_labels=None) -> Optional[int]:
    """K for the sparse decoder head, or None where it does not apply
    (copied from ``tlie_tpu``): per-position decoders with 2-D (B, L)
    labels at least 4× sparse in valid (non −100) entries.  K is the most
    valid labels of any row over both splits, so no valid label is dropped
    from the loss or the metric."""
    if not per_position(model_cfg):
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
             sparse_k: Optional[int], metric: Callable = compute_accuracy,
             seq=None) -> Tuple[float, float]:
    """(mean loss, mean metric) over the batches of ``idx``: the means of
    the per-batch values, as ``make_eval_block`` takes them.  ``metric`` is
    the dataset's (masked accuracy for MQAR, perplexity for WikiText, the
    argmax accuracy for ListOps).  The
    eval runs the dense head, or the sparse one with ``sparse_k``, never the
    fused head, as in ``tlie_tpu``.  With ``seq`` (the sequence-parallel
    route's shard, inside its context) each rank runs its time steps and
    takes the whole batch's numbers (:func:`~.steps.seq_head_logits`).
    Where the model's logits are split over a model group
    (``eval_model.logit_shard``, tensor parallelism) the loss and the
    metric take their vocab-parallel forms, and every rank of the group
    evaluates together."""
    vocab = getattr(eval_model, "logit_shard", None)
    if vocab is not None:
        from ..parallel.tp import vocab_parallel_metric

        metric = vocab_parallel_metric(metric, vocab)
    losses, metrics = [], []
    for idx_t in idx:
        x, y = gather_batch(data, idx_t)
        if seq is None:
            logits, y = head_logits(eval_model, x, y, sparse_k)
        else:
            logits, y = seq_head_logits(eval_model, seq, x, y, sparse_k)
        losses.append(cross_entropy_loss(logits, y, vocab=vocab))
        metrics.append(metric(logits, y))
    return float(torch.stack(losses).mean()), float(torch.stack(metrics).mean())
