"""Shared set-up for the tests that hold tlie_tpu_torch against tlie_tpu:
the small MQAR LRU config, JAX-initialised weights with non-trivial
BatchNorm statistics, and those weights carried into the port.

Inputs are made with numpy from a seed and handed to both packages."""

import jax
import numpy as np
import torch

from tlie_tpu.config import load_experiment
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.models import build_models

SMALL_YAML = "configs/mqar-lru-small.yaml"


def small_config():
    """configs/mqar-lru-small.yaml resolved, with seq_len from its dataset."""
    cfg = load_experiment(SMALL_YAML).raw
    cfg["model"]["seq_len"] = cfg["dataset"]["input_seq_length"]
    return cfg


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def jax_weights(model_cfg, seed=0, stats_seed=1):
    """(eval_model, params, batch_stats) of tlie_tpu's model for
    ``model_cfg``.  With ``stats_seed`` the BatchNorm statistics are drawn
    away from their init (0, 1) so that the eval-mode norm does real work."""
    _, eval_model, _ = jax_build_models(dict(model_cfg), padded=False)
    toks = np.zeros((1, model_cfg["seq_len"]), np.int32)
    variables = jax.jit(eval_model.init)(jax.random.PRNGKey(seed), toks)
    params = to_numpy(variables["params"])
    stats = to_numpy(variables.get("batch_stats", {}))
    rng = np.random.default_rng(stats_seed)
    for layer in stats.get("encoder", {}).values() if stats_seed is not None else ():
        st = layer["normalize"]
        st["mean"] = rng.normal(0.0, 0.3, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    return eval_model, params, (stats or None)


def port_model(model_cfg, params, batch_stats):
    """The port's eval-mode model on the CPU, carrying the JAX weights."""
    _, model, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(params_from_jax(params, batch_stats))
    return model


def tokens(model_cfg, batch=2, seed=0, length=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, model_cfg["input_dim"],
                        size=(batch, length or model_cfg["seq_len"])).astype(np.int32)


def jax_apply(eval_model, params, batch_stats, x):
    """tlie_tpu's forward (jitted: one compile instead of eager dispatch)."""
    variables = {"params": params, **({"batch_stats": batch_stats} if batch_stats else {})}
    return np.asarray(jax.jit(eval_model.apply)(variables, np.asarray(x)))
