"""Checkpoints in the reference's tree layout,
``{"model": ..., "config": {"model", "train", "data"}}``
(``tlie_tpu/training/checkpoint.py``), written with ``torch.save`` to one
``.pth`` file instead of an orbax directory.  ``"model"`` is the model's
``state_dict`` (no optimiser state: the port has no resume yet), and the file
loads with ``weights_only=True``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn


def save_checkpoint(stem: str, model: nn.Module, config: Dict[str, Any]) -> str:
    """Write ``stem + ".pth"`` (replacing it, as the reference replaces its
    directory) and return that path.  The file is written under a temporary
    name and renamed into place."""
    path = os.path.abspath(stem + ".pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state, "config": config}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The ``{"model": state_dict, "config": ...}`` tree of a checkpoint
    file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
