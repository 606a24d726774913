"""Checkpoints in the reference's tree layout,
``{"model": ..., "config": {"model", "train", "data"}}``
(``tlie_tpu/training/checkpoint.py``), written with ``torch.save`` to one
``.pth`` file instead of an orbax directory.  ``"model"`` is the model's
``state_dict`` (no optimiser state), and the file loads with
``weights_only=True``.

A mid-training resume snapshot (:func:`save_resume`, ``save_resume`` in
``tlie_tpu``) is another such file: the model's ``state_dict`` (BatchNorm
statistics included), the optimiser's, and the loop's ``meta`` (the step,
the plateau state, the best result, the history, and the generators'
states).
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


def save_resume(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
                meta: Dict[str, Any]) -> str:
    """Write the resume snapshot ``{"model", "optimizer", "meta"}`` to
    ``path`` under a temporary name and rename it into place, so a run
    stopped mid-save leaves the previous snapshot whole.  Returns the
    absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state, "optimizer": optimizer.state_dict(), "meta": meta}, tmp)
    os.replace(tmp, path)
    return path


def restore_resume(path: str, model: nn.Module,
                   optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """Load a snapshot of :func:`save_resume` into ``model`` and
    ``optimizer`` (onto their devices) and return its ``meta``."""
    snap = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(snap["model"])
    optimizer.load_state_dict(snap["optimizer"])
    return snap["meta"]
