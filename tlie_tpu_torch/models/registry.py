"""Model registry: config dict → (train model, eval model, family),
counterpart of ``tlie_tpu/models/registry.py::build_models`` for the ``lru``,
``mamba`` and ``transformer`` families."""

from __future__ import annotations

import copy
import itertools
from functools import partial
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .backbone import ClassificationModel
from .layers import Dropout
from .lru import LRU
from .mamba2 import Mamba
from .transformer import Transformer

MODEL_FAMILIES = ("mamba", "transformer", "lru", "s4", "s5")


def build_models(model_config: Dict[str, Any], *, generator: torch.Generator,
                 device="cuda") -> Tuple[nn.Module, nn.Module, str]:
    """``(train_model, eval_model, family)`` for ``model_config`` on
    ``device``: one module in ``.train()`` and one in ``.eval()`` that share
    every parameter and BatchNorm statistic, so a step on the first shows in
    the second.  Weights are drawn from ``generator`` (a CPU generator, so
    they do not depend on the device); the dropout masks from a device
    generator seeded from it.  Like ``tlie_tpu``'s registry the models return
    logits, not log-probs (argmax, masked CE and perplexity do not change)."""
    layer = model_config["layer"]
    if layer not in ("lru", "mamba", "transformer"):
        if layer in MODEL_FAMILIES:
            raise NotImplementedError(f"model family {layer!r} is not ported yet")
        raise RuntimeError(f"{layer} is not a valid model option")
    compute_dtype = model_config.get("compute_dtype", "float32")
    if compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype {compute_dtype!r} is not ported")
    if compute_dtype == "bfloat16" and layer != "mamba":
        raise NotImplementedError(
            f"compute_dtype: bfloat16 is ported for layer: mamba only, not {layer!r} "
            "(ROADMAP Queue 1 item 7: bf16 for the lru and transformer families)")
    dev = resolve_device(device)
    family = {"lru": _lru_model, "mamba": Mamba, "transformer": Transformer}[layer]
    model = family(model_config, generator).to(dev)
    seed = int(torch.randint(2**62, (1,), generator=generator))
    dropout_gen = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):  # BroadcastDropout too
            m.generator = dropout_gen
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    shared[id(dropout_gen)] = dropout_gen
    eval_model = copy.deepcopy(model, shared)
    return model.train(), eval_model.eval(), layer


def _lru_model(model_config: Dict[str, Any], generator: torch.Generator) -> ClassificationModel:
    ssm = partial(
        LRU, model_config["state_dim"], model_config["hidden_dim"], generator,
        model_config.get("r_min", 0.0), model_config.get("r_max", 1.0),
        model_config.get("max_phase", 6.28),
    )
    return ClassificationModel(
        ssm,
        d_output=model_config["output_dim"],
        d_model=model_config["hidden_dim"],
        n_layers=model_config["num_layers"],
        d_input=model_config["input_dim"],
        generator=generator,
        activation=model_config["activation"],
        pooling=model_config["pooling"],
        prenorm=model_config["prenorm"],
        norm=model_config["norm"],
        logits_output=True,
        dropout=model_config.get("dropout", 0.0),
    )
