"""Model registry: config dict → (train model, eval model, family),
counterpart of ``tlie_tpu/models/registry.py::build_models`` for all five
families: the SSM backbones (``lru``, ``s4``, ``s5``), ``mamba`` and
``transformer``."""

from __future__ import annotations

import copy
import itertools
from functools import partial
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .backbone import ClassificationModel
from .layers import Dropout, compute_dtype_of
from .lru import LRU
from .mamba2 import Mamba
from .s4 import init_S4
from .s5 import init_S5
from .transformer import Transformer

MODEL_FAMILIES = ("mamba", "transformer", "lru", "s4", "s5")


def build_models(model_config: Dict[str, Any], padded: bool = False, *,
                 generator: torch.Generator, device="cuda",
                 vocab_shard=None) -> Tuple[nn.Module, nn.Module, str]:
    """``(train_model, eval_model, family)`` for ``model_config`` on
    ``device``; ``padded`` (the config's ``train.padded``) makes the SSM
    backbone take ``(inputs, lengths)`` for its masked pool, as in
    ``tlie_tpu``; the Mamba and transformer families take ``(tokens,
    lengths)`` whatever ``padded`` says and drop the lengths, so their pools
    (the Mamba decoder's and the transformer's ``ClassifierHead``) run over
    the padding too, as in ``tlie_tpu`` (``models/mamba2.py:488-493``,
    ``models/transformer.py:181-188``).  One
    module in ``.train()`` and one in ``.eval()`` that share
    every parameter and BatchNorm statistic, so a step on the first shows in
    the second.  Weights are drawn from ``generator`` (a CPU generator, so
    they do not depend on the device); the dropout masks from a device
    generator seeded from it.  Like ``tlie_tpu``'s registry the models return
    logits, not log-probs (argmax, masked CE and perplexity do not change).
    ``model.compute_dtype`` is ``float32`` (the default) or ``bfloat16`` for
    every family, which the models read as flax's ``dtype=`` (the
    parameters stay float32); any other dtype raises.

    ``vocab_shard`` (tensor parallelism, the model group's
    :class:`~tlie_tpu_torch.parallel.mesh.Shard` of
    :func:`~tlie_tpu_torch.parallel.mesh.mesh_2d`): the whole model is
    built first, from ``generator``, then its model-level token table and
    decoder are cut to this rank's rows
    (:func:`~tlie_tpu_torch.parallel.tp.shard_vocab_parallel`), so the
    route starts from the one-process run's weights."""
    layer = model_config["layer"]
    if layer not in MODEL_FAMILIES:
        raise RuntimeError(f"{layer} is not a valid model option")
    compute_dtype = model_config.get("compute_dtype", "float32")
    if compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype {compute_dtype!r} is not ported")
    dev = resolve_device(device)
    if layer in ("lru", "s4", "s5"):
        model = _ssm_model(model_config, generator, padded)
    else:
        model = {"mamba": Mamba, "transformer": Transformer}[layer](model_config, generator)
    model = model.to(dev)
    if vocab_shard is not None:
        from ..parallel.tp import shard_vocab_parallel

        shard_vocab_parallel(model, vocab_shard)
    seed = int(torch.randint(2**62, (1,), generator=generator))
    dropout_gen = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):  # BroadcastDropout too
            m.generator = dropout_gen
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    shared[id(dropout_gen)] = dropout_gen
    if vocab_shard is not None:  # its process group is shared, not copied
        shared[id(vocab_shard)] = vocab_shard
    eval_model = copy.deepcopy(model, shared)
    return model.train(), eval_model.eval(), layer


def _ssm_model(model_config: Dict[str, Any], generator: torch.Generator,
               padded: bool = False) -> ClassificationModel:
    """The SSM backbone around the family's core (``ssm_backbone_partial``),
    computing in bfloat16 where ``compute_dtype`` asks for it (the core
    always in float32)."""
    layer, n, h = model_config["layer"], model_config["state_dim"], model_config["hidden_dim"]
    if layer == "lru":
        ssm = partial(LRU, n, h, generator, model_config.get("r_min", 0.0),
                      model_config.get("r_max", 1.0), model_config.get("max_phase", 6.28))
    else:
        ssm = (init_S5 if layer == "s5" else init_S4)(n, h, generator, **model_config)
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
        padded=padded,
        compute_dtype=compute_dtype_of(model_config),
    )
