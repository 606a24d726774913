"""Carry weights between ``tlie_tpu`` and the port: flax parameter trees ↔
the port's ``state_dict``.

The flax tree of the SSM backbone (``encoder/encoder``,
``encoder/layers_i/{seq,out1,out2,normalize}``, ``decoder``) maps name for
name onto the port's modules, the LRU's, S5's and S4's cores (``seq``) leaf
for leaf at the same shapes; complex S4 ``P`` and ``B`` arrays, as the
reference's checkpoints store them, load with a trailing (re, im) axis.  The Mamba family keeps the reference's torch
names (``encoder.word_embeddings`` or the dense ``encoder``,
``blocks.{i}.mamba.*`` with Mamba-1's ``x_proj`` and ``dt_proj`` and
``SSD_LTI``'s ``A``, ``blocks.{i}.glu.linear``, ``blocks.{i}.norm``), which
map onto ``encoder/word_embeddings/embedding``, ``encoder/{kernel,bias}``,
``blocks_i/mamba/*``,
``blocks_i/glu_layer/linear`` and ``blocks_i/norm_layer`` as
``tlie_tpu/analysis/compat.py`` maps them (it has no rule for ``x_proj``
and ``dt_proj``); so does the transformer family
(``encoder.position_embeddings``,
``layers.{i}.attention.{Wqkv,Wvqkn,offset,out_proj,conv1d}``, the gate's
``layers.{i}.Wz``, ``layers.{i}.norm``,
``layers.{i}.mixer.{linear,encoder,decoder}``, the hybrid mixer's
``layers.{i}.mixer.alpha`` (shape (1,) on both sides), ``norm``, the classifier's
``classifier.{encoder,decoder}``) onto ``layers_i/attention/*``,
``layers_i/Wz``, ``layers_i/norm``, ``layers_i/mixer/*``, ``norm`` and
``classifier/*``; the dual models' ``match.{encoder,middle,decoder}``
onto ``match/*``.  Dense kernels (in, out) become ``nn.Linear`` weights (out, in);
the SSM token encoder keeps flax's (in,
out) layout, since it is a gather table; the depthwise conv's (K, C) becomes
``nn.Conv1d``'s (C, 1, K).  ``batch_stats`` {mean, var} are the BatchNorm
running statistics.  One table of rules serves both directions, so
``params_to_jax`` is the exact inverse of ``params_from_jax``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

LRU_PARAMS = ("nu_log", "theta_log", "gamma_log", "B_re", "B_im", "C_re", "C_im", "D")
# S5's and S4's leaves (D is the LRU's name too); complex values carry a
# trailing (re, im) axis on both sides
S5_S4_PARAMS = ("Lambda_re", "Lambda_im", "log_step", "B", "C", "C1", "C2", "P")

_LAYER = r"encoder\.layers\.(?P<i>\d+)"
_FLAX_LAYER = r"encoder/layers_(?P<i>\d+)"
_SSM = "(?P<p>" + "|".join(LRU_PARAMS + S5_S4_PARAMS) + ")"
_BLOCK = r"blocks\.(?P<i>\d+)"
_FLAX_BLOCK = r"params/blocks_(?P<i>\d+)"
_PROJ = r"(?P<pr>in_proj|out_proj)"
_TF = r"layers\.(?P<i>\d+)"
_FLAX_TF = r"params/layers_(?P<i>\d+)"
_ATT = r"(?P<a>Wqkv|Wvqkn|out_proj)"
_MLP = r"(?P<m>encoder|decoder)"
_MATCH = r"(?P<mt>encoder|middle|decoder)"
# layout changes between the two sides
T, CONV = "T", "conv"
# (state_dict key, flax "collection/path", layout change), as regexes with
# the same named groups on both sides
_RULES = (
    (r"encoder\.encoder\.weight", r"params/encoder/encoder/kernel", None),
    (r"encoder\.encoder\.bias", r"params/encoder/encoder/bias", None),
    (_LAYER + r"\.seq\." + _SSM, r"params/" + _FLAX_LAYER + r"/seq/" + _SSM, None),
    (_LAYER + r"\.(?P<o>out[12])\.weight", r"params/" + _FLAX_LAYER + r"/(?P<o>out[12])/kernel", T),
    (_LAYER + r"\.(?P<o>out[12])\.bias", r"params/" + _FLAX_LAYER + r"/(?P<o>out[12])/bias", None),
    (_LAYER + r"\.normalize\.weight", r"params/" + _FLAX_LAYER + r"/normalize/scale", None),
    (_LAYER + r"\.normalize\.bias", r"params/" + _FLAX_LAYER + r"/normalize/bias", None),
    (_LAYER + r"\.normalize\.running_mean", r"batch_stats/" + _FLAX_LAYER + r"/normalize/mean", None),
    (_LAYER + r"\.normalize\.running_var", r"batch_stats/" + _FLAX_LAYER + r"/normalize/var", None),
    (r"decoder\.weight", r"params/decoder/kernel", T),
    (r"decoder\.bias", r"params/decoder/bias", None),
    # the Mamba family: the token embedding, or the dense encoder (an
    # nn.Linear; encoder.encoder.* above is the SSM backbone's)
    (r"encoder\.word_embeddings\.weight", r"params/encoder/word_embeddings/embedding", None),
    (r"encoder\.weight", r"params/encoder/kernel", T),
    (r"encoder\.bias", r"params/encoder/bias", None),
    (_BLOCK + r"\.mamba\." + _PROJ + r"\.weight", _FLAX_BLOCK + r"/mamba/" + _PROJ + r"/kernel", T),
    # Mamba-1's x_proj (no bias) and dt_proj
    (_BLOCK + r"\.mamba\.(?P<q>x_proj|dt_proj)\.weight",
     _FLAX_BLOCK + r"/mamba/(?P<q>x_proj|dt_proj)/kernel", T),
    (_BLOCK + r"\.mamba\.dt_proj\.bias", _FLAX_BLOCK + r"/mamba/dt_proj/bias", None),
    (_BLOCK + r"\.mamba\.conv1d\.weight", _FLAX_BLOCK + r"/mamba/conv1d/weight", CONV),
    (_BLOCK + r"\.mamba\.conv1d\.bias", _FLAX_BLOCK + r"/mamba/conv1d/bias", None),
    # SSD's A_log, SSD_LTI's A
    (_BLOCK + r"\.mamba\.(?P<p>dt_bias|A_log|A|D|init_states)",
     _FLAX_BLOCK + r"/mamba/(?P<p>dt_bias|A_log|A|D|init_states)", None),
    (_BLOCK + r"\.glu\.linear\.weight", _FLAX_BLOCK + r"/glu_layer/linear/kernel", T),
    (_BLOCK + r"\.glu\.linear\.bias", _FLAX_BLOCK + r"/glu_layer/linear/bias", None),
    (_BLOCK + r"\.norm\.weight", _FLAX_BLOCK + r"/norm_layer/scale", None),
    (_BLOCK + r"\.norm\.bias", _FLAX_BLOCK + r"/norm_layer/bias", None),
    # the transformer family
    (r"encoder\.position_embeddings\.weight", r"params/encoder/position_embeddings/embedding",
     None),
    (_TF + r"\.attention\." + _ATT + r"\.weight", _FLAX_TF + r"/attention/" + _ATT + r"/kernel", T),
    (_TF + r"\.attention\." + _ATT + r"\.bias", _FLAX_TF + r"/attention/" + _ATT + r"/bias", None),
    (_TF + r"\.attention\.offset", _FLAX_TF + r"/attention/offset", None),
    (_TF + r"\.attention\.conv1d\.weight", _FLAX_TF + r"/attention/conv1d/weight", CONV),
    (_TF + r"\.attention\.conv1d\.bias", _FLAX_TF + r"/attention/conv1d/bias", None),
    # the SiLU gate (use_gate)
    (_TF + r"\.Wz\.weight", _FLAX_TF + r"/Wz/kernel", T),
    (_TF + r"\.Wz\.bias", _FLAX_TF + r"/Wz/bias", None),
    (_TF + r"\.norm\.weight", _FLAX_TF + r"/norm/scale", None),
    (_TF + r"\.norm\.bias", _FLAX_TF + r"/norm/bias", None),
    (_TF + r"\.mixer\.linear\.weight", _FLAX_TF + r"/mixer/linear/kernel", T),
    (_TF + r"\.mixer\.linear\.bias", _FLAX_TF + r"/mixer/linear/bias", None),
    # the MLP mixer
    (_TF + r"\.mixer\." + _MLP + r"\.weight", _FLAX_TF + r"/mixer/" + _MLP + r"/kernel", T),
    (_TF + r"\.mixer\." + _MLP + r"\.bias", _FLAX_TF + r"/mixer/" + _MLP + r"/bias", None),
    # the hybrid mixer's (1,) logit
    (_TF + r"\.mixer\.alpha", _FLAX_TF + r"/mixer/alpha", None),
    (r"norm\.weight", r"params/norm/scale", None),
    (r"norm\.bias", r"params/norm/bias", None),
    # the transformer's classifier head
    (r"classifier\." + _MLP + r"\.weight", r"params/classifier/" + _MLP + r"/kernel", T),
    (r"classifier\." + _MLP + r"\.bias", r"params/classifier/" + _MLP + r"/bias", None),
    # the dual models' retrieval head
    (r"match\." + _MATCH + r"\.weight", r"params/match/" + _MATCH + r"/kernel", T),
    (r"match\." + _MATCH + r"\.bias", r"params/match/" + _MATCH + r"/bias", None),
)


def _fill(pattern: str, groups: Mapping[str, str]) -> str:
    """The string a rule's other side names for the captured ``groups``."""
    out = re.sub(r"\(\?P<(\w+)>[^)]*\)", lambda m: groups[m.group(1)], pattern)
    return out.replace("\\", "")


def _translate(name: str, src: int) -> Optional[Tuple[str, Optional[str]]]:
    """Map ``name`` from side ``src`` (0: state_dict, 1: flax) to the other
    side; None when no rule takes it."""
    for rule in _RULES:
        m = re.fullmatch(rule[src], name)
        if m:
            return _fill(rule[1 - src], m.groupdict()), rule[2]
    return None


def _to_flax(key: str) -> Tuple[Tuple[str, ...], Optional[str]]:
    found = _translate(key, 0)
    if found is None:
        raise ValueError(f"state_dict key {key!r} has no place in the flax tree")
    return tuple(found[0].split("/")), found[1]


def flax_path(key: str) -> Tuple[str, ...]:
    """The flax ``(collection, *path)`` of a port ``state_dict`` key."""
    return _to_flax(key)[0]


def _to_port_layout(arr: np.ndarray, change: Optional[str]) -> np.ndarray:
    if change == T:
        return arr.T
    if change == CONV:  # (K, C) -> (C, 1, K)
        return arr.T[:, None, :]
    return arr


def _to_flax_layout(arr: np.ndarray, change: Optional[str]) -> np.ndarray:
    if change == T:
        return arr.T
    if change == CONV:  # (C, 1, K) -> (K, C)
        return arr[:, 0, :].T
    return arr


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for an LRU, S5 or S4 ``ClassificationModel``, a
    ``Mamba`` or a ``Transformer`` from the flax ``params`` (and
    ``batch_stats`` for ``norm: batch``) as numpy arrays.  Raises if a flax leaf has no place in the
    port."""
    out: Dict[str, torch.Tensor] = {}
    left = []
    trees = {"params": params, "batch_stats": batch_stats or {}}
    for collection, tree in trees.items():
        for path, value in _leaves(tree):
            found = _translate("/".join((collection,) + path), 1)
            if found is None:
                left.append((collection,) + path)
                continue
            key, change = found
            arr = np.asarray(value)
            if np.iscomplexobj(arr):  # a reference checkpoint's complex S4 P or B
                arr = np.stack([arr.real, arr.imag], axis=-1)
            arr = arr.astype(np.float32)
            out[key] = torch.tensor(np.ascontiguousarray(_to_port_layout(arr, change)))
    if left:
        raise ValueError(f"flax leaves with no place in the port: {left}")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]):
    """The inverse of :func:`params_from_jax`: ``(params, batch_stats)`` as
    nested dicts of float32 numpy arrays (``batch_stats`` is None without
    BatchNorm), the trees ``tlie_tpu``'s model and extractors take."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        (collection, *path), change = _to_flax(key)
        arr = _to_flax_layout(value.detach().cpu().numpy().astype(np.float32), change)
        node = trees[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return trees["params"], (trees["batch_stats"] or None)
