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
from typing import Any, Dict, Optional

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
                meta: Dict[str, Any], state: Optional[Dict[str, torch.Tensor]] = None,
                optimizer_state: Optional[Dict[str, Any]] = None) -> str:
    """Write the resume snapshot ``{"model", "optimizer", "meta"}`` to
    ``path`` under a temporary name and rename it into place, so a run
    stopped mid-save leaves the previous snapshot whole.  ``state`` and
    ``optimizer_state``, where given, are written in place of the model's
    and the optimiser's own (the tensor-parallel route's, gathered into the
    one-process layout).  Returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in (state or model.state_dict()).items()}
    optimizer_state = optimizer.state_dict() if optimizer_state is None else optimizer_state
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state, "optimizer": optimizer_state, "meta": meta}, tmp)
    os.replace(tmp, path)
    return path


def restore_resume(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
                   vocab=None) -> Dict[str, Any]:
    """Load a snapshot of :func:`save_resume` into ``model`` and
    ``optimizer`` (onto their devices) and return its ``meta``.  With
    ``vocab`` (the tensor-parallel route's model shard) the split leaves
    and their moments are cut to this rank's rows first."""
    snap = torch.load(path, map_location="cpu", weights_only=True)
    state, opt_state = snap["model"], snap["optimizer"]
    if vocab is not None:
        from ..parallel.tp import slice_vocab_parallel

        state, opt_state = slice_vocab_parallel(model, vocab, state, optimizer, opt_state)
    model.load_state_dict(state)
    optimizer.load_state_dict(opt_state)
    return snap["meta"]
