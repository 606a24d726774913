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


# -- the transformer family ------------------------------------------------------

def jax_transformer_params(model_cfg, seed=0):
    """(eval_model, params) of tlie_tpu's transformer for ``model_cfg``,
    initialised under jit."""
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=False)
    toks = np.zeros((1, model_cfg["seq_len"]), np.int32)
    return jeval, to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(seed), toks)["params"])


def port_transformer(model_cfg, params):
    """The port's (train model, eval model) on the CPU carrying ``params``."""
    model, eval_model, family = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    assert family == "transformer"
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


def jax_sparse_loss(model, k):
    """tlie_tpu's sparse-head masked CE of ``model`` as a function of
    (params, x, y): the features at the k labelled positions of each row
    through the decoder kernel."""
    import jax.numpy as jnp

    from tlie_tpu.training import scan_loop

    def loss(params, x, y):
        feats = model.apply({"params": params}, x, method=type(model).features)
        _, pos = jax.lax.top_k((y != -100).astype(jnp.int32), k)
        f_sel = jnp.take_along_axis(feats, pos[..., None], axis=1)
        y_sel = jnp.take_along_axis(y, pos, axis=1)
        return scan_loop.cross_entropy_loss(f_sel @ params["decoder"]["kernel"], y_sel)
    return loss


# -- rehearsing chip_smoke.py on the CPU ---------------------------------------------

ARTIFACT_FILES = sorted([f"{k}.npy" for k in (
    "eig", "eig_init", "percentage", "percentage_init", "percentage_phase",
    "percentage_phase_init", "percentage_mean", "percentage_init_mean", "percentage_std",
    "percentage_init_std")] + ["percentage_file.txt", "used_config.yaml"])


def load_chip_smoke():
    """``chip_smoke.py`` as a module, for rehearsing its paths on the CPU."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def stub_card(monkeypatch, cs, decay_kernels: bool = False):
    """The card's timers and profiler stubbed for a CPU rehearsal of
    ``chip_smoke`` (CUDA events that time nothing, a profiler that sees no
    device time), every launch count set to 0; with ``decay_kernels`` the
    decay attention's routing forced to its ``*_cuda`` wrappers, which run
    the plain versions and count their launches under the kernels' names."""
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import decay_attention as da

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    for name, stub in (("synchronize", lambda *a, **k: None), ("Event", Event),
                       ("_sleep", lambda *a: None), ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, stub)
    for key in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, key, 0)
    monkeypatch.setattr(cs, "top_device_ops", lambda fn, k=6: (fn(), [])[1])
    if not decay_kernels:
        return

    def counting(kernel, plain):
        def run(*args):
            LAUNCHES[da.launch_name(kernel, args[3].dtype)] += 1
            return plain(*args)
        return run

    monkeypatch.setattr(da, "_on_cuda", lambda t: True)
    for kernel, plain in (("fwd", da.decay_attention_plain),
                          ("bwd_i", da.decay_attention_bwd_i_plain),
                          ("bwd_j", da.decay_attention_bwd_j_plain)):
        monkeypatch.setattr(da, f"decay_attention_{kernel}_cuda", counting(kernel, plain))
