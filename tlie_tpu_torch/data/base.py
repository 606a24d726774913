"""The metrics of ``tlie_tpu/data/base.py`` on torch tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, ignore_idx: int = -100):
    """Accuracy over positions whose label != ignore_idx (MQAR metric,
    ref dataloaders/mqar.py:171)."""
    pred = torch.argmax(logits, dim=-1)
    mask = labels != ignore_idx
    correct = (mask & (pred == labels)).sum()
    return correct / mask.sum().clamp_min(1)


def perplexity(logits: torch.Tensor, labels: torch.Tensor, ignore_idx: int = -100):
    """exp(mean CE) over non-ignored positions (ref dataloaders/wikitext.py:51-55)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp_min(0)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = labels != ignore_idx
    ce = -torch.where(mask, ll, torch.zeros_like(ll)).sum() / mask.sum().clamp_min(1)
    return torch.exp(ce)
