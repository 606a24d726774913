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

The Mamba and transformer families may add ``train.param_group``
(``create_train_state_adamw``, ``tlie_tpu/training/state.py:143-170``): the
parameters whose flax leaf name contains that substring (``A_log``,
``kernel``, ... as ``map_nested_fn`` passes the last key; matched through
:func:`tlie_tpu_torch.compat.flax_path`, never on torch's ``weight``) form a
group ``group`` of optax's ``adamw`` with its defaults (betas 0.9, 0.999,
eps 1e-8, weight decay 1e-4) at ``train.group_lr`` (default 1e-3), no
schedule and no clip, inside ``optax.MultiSteps(every_k_schedule=
train.update_step)``: its gradients are averaged over ``update_step`` steps
(``acc += (g - acc) / (n + 1)``) and applied on the last of them, with its
own step count; in between the group stays put.  :class:`MultiStepsAdamW`
is that optimiser; the regular chain's clip covers the ``regular`` group
alone (:func:`clipped_parameters`), as ``multi_transform`` masks the group
out of it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn

from ..compat import flax_path

# create_train_state_s5's hardcoded SSM group (tlie_tpu/training/state.py:126)
S5_SSM_VARS = ("Lambda_re", "Lambda_im", "log_step", "norm")
OPTAX_BETAS = (0.9, 0.999)
# optax.adamw's default weight decay, the param_group's (state.py:166)
OPTAX_WEIGHT_DECAY = 1e-4
# the name of train.param_group's optimiser group (the reference's label)
GROUP = "group"


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
    Mamba and transformer families ``create_train_state_adamw``'s AdamW group
    ``regular``, decaying every parameter (optax's ``adamw``, eps 1e-8),
    behind a clip at global norm 1.0 (:func:`clip_by_global_norm_` over
    :func:`clipped_parameters`, applied by ``train_step``), and, with
    ``train.param_group``, the group of :class:`MultiStepsAdamW` beside it
    (see the module docstring)."""
    if family in ("mamba", "transformer"):
        substring = train_cfg.get("param_group")
        named = list(model.named_parameters())
        in_group = [substring is not None and substring in flax_path(n)[-1] for n, _ in named]
        groups = [{"params": [p for (_, p), g in zip(named, in_group) if not g],
                   "name": "regular", "lr": f["lr"], "weight_decay": f["wd"]}]
        members = [p for (_, p), g in zip(named, in_group) if g]
        if not members:
            return torch.optim.AdamW(groups, betas=tuple(f["betas"]), eps=1e-8), 1.0
        groups.append({"params": members, "name": GROUP, "lr": train_cfg.get("group_lr", 1e-3),
                       "weight_decay": OPTAX_WEIGHT_DECAY, "betas": OPTAX_BETAS,
                       "every_k": int(train_cfg.get("update_step", 1)), "mini_step": 0,
                       "acc": [torch.zeros_like(p) for p in members]})
        return MultiStepsAdamW(groups, betas=tuple(f["betas"]), eps=1e-8), 1.0
    if family == "s5":
        return make_optimizer(model, S5_SSM_VARS, f["lr"], f["ssm_lr"], f["wd"], OPTAX_BETAS), None
    return make_optimizer(model, model_cfg.get("ssm_lr_vars", []), f["lr"], f["ssm_lr"],
                          f["wd"], f["betas"]), None


class MultiStepsAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` in which a param group with ``every_k`` is
    ``optax.MultiSteps(adamw, every_k_schedule=every_k)``: each step adds the
    gradients to the group's running mean ``acc`` (optax's Welford form, at
    the group's ``mini_step``); on the ``every_k``-th the mean is the
    gradient of an AdamW step (whose state counts those steps alone) and
    ``acc`` is zeroed, on the others the group takes no step at all.  The
    accumulator and ``mini_step`` live in the param group, so
    ``state_dict`` carries them into a resume snapshot."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            if "every_k" not in group:
                continue
            n = group["mini_step"]
            for p, acc in zip(group["params"], group["acc"]):
                g = torch.zeros_like(p) if p.grad is None else p.grad
                acc.add_((g - acc) / (n + 1))
            emit = n == group["every_k"] - 1
            for p, acc in zip(group["params"], group["acc"]):
                p.grad = acc.clone() if emit else None  # AdamW passes over a None grad
                if emit:
                    acc.zero_()
            group["mini_step"] = 0 if emit else n + 1
        return super().step(closure)

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            if "acc" in group:  # a snapshot holds them on the CPU
                group["acc"] = [a.to(p.device, p.dtype) for a, p in zip(group["acc"],
                                                                        group["params"])]


def clipped_parameters(optimizer: torch.optim.Optimizer) -> List[nn.Parameter]:
    """The parameters the Mamba and transformer families' global-norm clip
    covers: the ``regular`` group's, in model order (every parameter but
    ``train.param_group``'s)."""
    return [p for g in optimizer.param_groups if g["name"] == "regular" for p in g["params"]]


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place on the gradients: with
    norm = sqrt(Σ g²) over every gradient, each g becomes g / norm · max_norm
    where norm ≥ max_norm and stays as it is otherwise.  (Not
    ``torch.nn.utils.clip_grad_norm_``, which scales by max_norm / (norm +
    1e-6) and so moves gradients whose norm is just below max_norm.)
    Under tensor parallelism a parameter split over the model group
    (``p.vocab_shard``) adds its squares summed over that group, so the
    norm is the one over the whole arrays.  Returns the norm, on the
    device, without a host sync."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    split = [getattr(p, "vocab_shard", None) is not None for p in params]
    if any(split):
        vocab = next(p.vocab_shard for p, s in zip(params, split) if s)
        split = torch.tensor(split, device=norms.device)
        sq = norms * norms
        norm = torch.sqrt(sq[~split].sum() + vocab.sum(sq[split].sum()))
    else:
        norm = torch.linalg.vector_norm(norms)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
