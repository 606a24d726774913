"""Optimiser construction: the ``{ssm, regular}`` groups of
``tlie_tpu/training/state.py::_grouped_tx`` for the SSM families, and
``create_train_state_adamw``'s AdamW behind a global-norm clip for the Mamba
and transformer families (:func:`make_family_optimizer` chooses, as
``loop.py::_make_state``).

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
in ``tlie_tpu``.  S4 takes these groups as they are, with ``train.betas``.

S5 takes ``create_train_state_s5``'s layout instead: the ``ssm`` set is
fixed to :data:`S5_SSM_VARS` whatever the config's ``ssm_lr_vars`` says (the
MQAR S5 configs list ``B``, which is decayed in ``regular`` all the same),
and both groups take optax's default betas (0.9, 0.999), not
``train.betas``.  (``norm`` names no leaf: BatchNorm's are ``scale`` and
``bias``, so the norms are ``regular``, as in ``tlie_tpu``.)
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn

from ..compat import flax_path

# create_train_state_s5's hardcoded SSM group (tlie_tpu/training/state.py:126)
S5_SSM_VARS = ("Lambda_re", "Lambda_im", "log_step", "norm")
OPTAX_BETAS = (0.9, 0.999)


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


def make_family_optimizer(model: nn.Module, family: str, model_cfg: Dict[str, Any],
                          train_cfg: Dict[str, Any], f: Dict[str, Any]):
    """``(optimizer, clip_norm)`` for the family (``loop.py::_make_state``):
    the SSM families take the ``{ssm, regular}`` groups and no clip (S5 with
    its fixed ``ssm`` set and optax's default betas); the
    Mamba and transformer families ``create_train_state_adamw``'s one AdamW group,
    ``regular``, decaying every parameter (optax's ``adamw``, eps 1e-8),
    behind a clip at global norm 1.0 (:func:`clip_by_global_norm_`, applied
    by ``train_step``).  A non-null ``train.param_group`` raises: its extra
    group is not ported yet."""
    if family in ("mamba", "transformer"):
        if train_cfg.get("param_group") is not None:
            raise NotImplementedError("train.param_group is not ported yet")
        group = {"params": list(model.parameters()), "name": "regular", "lr": f["lr"],
                 "weight_decay": f["wd"]}
        return torch.optim.AdamW([group], betas=tuple(f["betas"]), eps=1e-8), 1.0
    if family == "s5":
        return make_optimizer(model, S5_SSM_VARS, f["lr"], f["ssm_lr"], f["wd"], OPTAX_BETAS), None
    return make_optimizer(model, model_cfg.get("ssm_lr_vars", []), f["lr"], f["ssm_lr"],
                          f["wd"], f["betas"]), None


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place on the gradients: with
    norm = sqrt(Σ g²) over every gradient, each g becomes g / norm · max_norm
    where norm ≥ max_norm and stays as it is otherwise.  (Not
    ``torch.nn.utils.clip_grad_norm_``, which scales by max_norm / (norm +
    1e-6) and so moves gradients whose norm is just below max_norm.)
    Returns the norm, on the device, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
