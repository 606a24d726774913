"""Carry weights between ``tlie_tpu`` and the port: flax parameter trees ↔
the port's ``state_dict``.

The flax tree of the SSM backbone (``encoder/encoder``,
``encoder/layers_i/{seq,out1,out2,normalize}``, ``decoder``) maps name for
name onto the port's modules.  Dense kernels (in, out) become ``nn.Linear``
weights (out, in); the token encoder keeps flax's (in, out) layout, since it
is a gather table.  ``batch_stats`` {mean, var} are the BatchNorm running
statistics.  One table of rules serves both directions, so
``params_to_jax`` is the exact inverse of ``params_from_jax``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

LRU_PARAMS = ("nu_log", "theta_log", "gamma_log", "B_re", "B_im", "C_re", "C_im", "D")

_LAYER = r"encoder\.layers\.(?P<i>\d+)"
_FLAX_LAYER = r"encoder/layers_(?P<i>\d+)"
_LRU = "(?P<p>" + "|".join(LRU_PARAMS) + ")"
# (state_dict key, flax "collection/path", transposed), as regexes with the
# same named groups on both sides
_RULES = (
    (r"encoder\.encoder\.weight", r"params/encoder/encoder/kernel", False),
    (r"encoder\.encoder\.bias", r"params/encoder/encoder/bias", False),
    (_LAYER + r"\.seq\." + _LRU, r"params/" + _FLAX_LAYER + r"/seq/" + _LRU, False),
    (_LAYER + r"\.(?P<o>out[12])\.weight", r"params/" + _FLAX_LAYER + r"/(?P<o>out[12])/kernel", True),
    (_LAYER + r"\.(?P<o>out[12])\.bias", r"params/" + _FLAX_LAYER + r"/(?P<o>out[12])/bias", False),
    (_LAYER + r"\.normalize\.weight", r"params/" + _FLAX_LAYER + r"/normalize/scale", False),
    (_LAYER + r"\.normalize\.bias", r"params/" + _FLAX_LAYER + r"/normalize/bias", False),
    (_LAYER + r"\.normalize\.running_mean", r"batch_stats/" + _FLAX_LAYER + r"/normalize/mean", False),
    (_LAYER + r"\.normalize\.running_var", r"batch_stats/" + _FLAX_LAYER + r"/normalize/var", False),
    (r"decoder\.weight", r"params/decoder/kernel", True),
    (r"decoder\.bias", r"params/decoder/bias", False),
)


def _fill(pattern: str, groups: Mapping[str, str]) -> str:
    """The string a rule's other side names for the captured ``groups``."""
    out = re.sub(r"\(\?P<(\w+)>[^)]*\)", lambda m: groups[m.group(1)], pattern)
    return out.replace("\\", "")


def _translate(name: str, src: int) -> Optional[Tuple[str, bool]]:
    """Map ``name`` from side ``src`` (0: state_dict, 1: flax) to the other
    side; None when no rule takes it."""
    for rule in _RULES:
        m = re.fullmatch(rule[src], name)
        if m:
            return _fill(rule[1 - src], m.groupdict()), rule[2]
    return None


def _to_flax(key: str) -> Tuple[Tuple[str, ...], bool]:
    found = _translate(key, 0)
    if found is None:
        raise ValueError(f"state_dict key {key!r} has no place in the flax tree")
    return tuple(found[0].split("/")), found[1]


def flax_path(key: str) -> Tuple[str, ...]:
    """The flax ``(collection, *path)`` of a port ``state_dict`` key."""
    return _to_flax(key)[0]


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for an LRU ``ClassificationModel`` from the
    flax ``params`` (and ``batch_stats`` for ``norm: batch``) as numpy
    arrays.  Raises if a flax leaf has no place in the port."""
    out: Dict[str, torch.Tensor] = {}
    left = []
    trees = {"params": params, "batch_stats": batch_stats or {}}
    for collection, tree in trees.items():
        for path, value in _leaves(tree):
            found = _translate("/".join((collection,) + path), 1)
            if found is None:
                left.append((collection,) + path)
                continue
            key, transposed = found
            arr = np.asarray(value, dtype=np.float32)
            out[key] = torch.tensor(arr.T if transposed else arr)
    if left:
        raise ValueError(f"flax leaves with no place in the port: {left}")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]):
    """The inverse of :func:`params_from_jax`: ``(params, batch_stats)`` as
    nested dicts of float32 numpy arrays (``batch_stats`` is None without
    BatchNorm), the trees ``tlie_tpu``'s model and extractors take."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        (collection, *path), transposed = _to_flax(key)
        arr = value.detach().cpu().numpy().astype(np.float32)
        if transposed:
            arr = arr.T
        node = trees[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return trees["params"], (trees["batch_stats"] or None)
