"""Model registry: config dict → the evaluation model, counterpart of
``tlie_tpu/models/registry.py::build_models`` for the ``lru`` family."""

from __future__ import annotations

from functools import partial
from typing import Any, Dict

import torch

from ..device import resolve_device
from .backbone import ClassificationModel
from .lru import LRU

MODEL_FAMILIES = ("mamba", "transformer", "lru", "s4", "s5")


def build_models(model_config: Dict[str, Any], *, generator: torch.Generator,
                 device="cuda") -> ClassificationModel:
    """The eval-mode model of ``model_config`` on ``device``, initialised from
    ``generator`` (a CPU generator, so the weights do not depend on the
    device).  Like ``tlie_tpu``'s registry it returns logits, not log-probs
    (argmax, masked CE and perplexity do not change)."""
    layer = model_config["layer"]
    if layer != "lru":
        if layer in MODEL_FAMILIES:
            raise NotImplementedError(f"model family {layer!r} is not ported yet")
        raise RuntimeError(f"{layer} is not a valid model option")
    if model_config.get("compute_dtype", "float32") != "float32":
        raise NotImplementedError("bf16 mixed precision is not ported yet")
    dev = resolve_device(device)
    ssm = partial(
        LRU, model_config["state_dim"], model_config["hidden_dim"], generator,
        model_config.get("r_min", 0.0), model_config.get("r_max", 1.0),
        model_config.get("max_phase", 6.28),
    )
    model = ClassificationModel(
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
    )
    return model.to(dev).eval()
