"""Carry ``tlie_tpu`` weights into the port: flax parameter trees → the
port's ``state_dict``.

The flax tree of the SSM backbone (``encoder/encoder``,
``encoder/layers_i/{seq,out1,out2,normalize}``, ``decoder``) maps name for
name onto the port's modules.  Dense kernels (in, out) become ``nn.Linear``
weights (out, in); the token encoder keeps flax's (in, out) layout, since it
is a gather table.  ``batch_stats`` {mean, var} become BatchNorm running
statistics.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

LRU_PARAMS = ("nu_log", "theta_log", "gamma_log", "B_re", "B_im", "C_re", "C_im", "D")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def params_from_jax(params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for an LRU ``ClassificationModel`` from the
    flax ``params`` (and ``batch_stats`` for ``norm: batch``) as numpy
    arrays.  Raises if a flax leaf has no place in the port."""
    used = set()

    def get(tree, *path):
        node = tree
        for k in path:
            node = node[k]
        used.add((id(tree),) + path)
        return np.asarray(node, dtype=np.float32)

    enc = params["encoder"]
    sd: Dict[str, np.ndarray] = {
        "encoder.encoder.weight": get(params, "encoder", "encoder", "kernel"),
        "encoder.encoder.bias": get(params, "encoder", "encoder", "bias"),
    }
    layers = sorted((k for k in enc if k.startswith("layers_")), key=lambda k: int(k[7:]))
    for key in layers:
        i = int(key[7:])
        pre = f"encoder.layers.{i}."
        for name in LRU_PARAMS:
            sd[pre + "seq." + name] = get(params, "encoder", key, "seq", name)
        for lin in ("out1", "out2"):
            if lin in enc[key]:
                sd[pre + lin + ".weight"] = get(params, "encoder", key, lin, "kernel").T
                sd[pre + lin + ".bias"] = get(params, "encoder", key, lin, "bias")
        sd[pre + "normalize.weight"] = get(params, "encoder", key, "normalize", "scale")
        sd[pre + "normalize.bias"] = get(params, "encoder", key, "normalize", "bias")
        if batch_stats is not None:
            sd[pre + "normalize.running_mean"] = get(batch_stats, "encoder", key, "normalize", "mean")
            sd[pre + "normalize.running_var"] = get(batch_stats, "encoder", key, "normalize", "var")
    sd["decoder.weight"] = get(params, "decoder", "kernel").T
    sd["decoder.bias"] = get(params, "decoder", "bias")

    trees = [params] + ([batch_stats] if batch_stats is not None else [])
    left = [p for t in trees for p in _leaves(t) if (id(t),) + p not in used]
    if left:
        raise ValueError(f"flax leaves with no place in the port: {left}")
    out = {k: torch.tensor(v) for k, v in sd.items()}
    if batch_stats is not None:
        for key in layers:
            out[f"encoder.layers.{int(key[7:])}.normalize.num_batches_tracked"] = torch.tensor(0)
    return out
