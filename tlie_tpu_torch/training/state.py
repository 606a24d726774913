"""Optimiser construction: the ``{ssm, regular}`` groups of
``tlie_tpu/training/state.py::_grouped_tx``.

A parameter is in ``ssm`` when its flax leaf name is in the config's
``ssm_lr_vars``: Adam at ``ssm_lr`` with no weight decay.  Everything else is
``regular``: AdamW at ``lr`` with weight decay ``wd`` (optax's ``adamw``
decays every leaf of its group, biases and norm scales included).  Both
groups live in one ``torch.optim.AdamW``, the ``ssm`` group with weight decay
0, which is Adam.  The learning rates are written into the groups before
every step (:func:`set_group_learning_rates`), as ``tlie_tpu`` writes them
into ``inject_hyperparams``.

The MQAR LRU configs list ``Lambda_re, Lambda_im, P, B, log_step``, none of
which is an LRU leaf name, so there every parameter is ``regular``, as it is
in ``tlie_tpu``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn

from ..compat import flax_path


def param_groups(model: nn.Module, ssm_vars: Iterable[str]) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """``{"ssm": [...], "regular": [...]}`` of (name, parameter), chosen by
    the flax leaf name of each parameter."""
    ssm_set = set(ssm_vars or ())
    groups: Dict[str, List[Tuple[str, nn.Parameter]]] = {"ssm": [], "regular": []}
    for name, p in model.named_parameters():
        groups["ssm" if flax_path(name)[-1] in ssm_set else "regular"].append((name, p))
    return groups


def make_optimizer(model: nn.Module, ssm_vars: Sequence[str], lr: float, ssm_lr: float,
                   wd: float, betas: Tuple[float, float]) -> torch.optim.AdamW:
    """One AdamW over the non-empty groups, each tagged with its ``name``."""
    settings = {"ssm": (ssm_lr, 0.0), "regular": (lr, wd)}
    groups = [
        {"params": [p for _, p in members], "name": name,
         "lr": settings[name][0], "weight_decay": settings[name][1]}
        for name, members in param_groups(model, ssm_vars).items() if members
    ]
    return torch.optim.AdamW(groups, betas=tuple(betas), eps=1e-8)


def set_group_learning_rates(optimizer: torch.optim.Optimizer, lrs: Dict[str, float]) -> None:
    """Write each group's learning rate for the coming step."""
    for group in optimizer.param_groups:
        group["lr"] = lrs[group["name"]]
