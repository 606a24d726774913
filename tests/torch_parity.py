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


class Jitted:
    """A flax module whose ``init`` runs jitted (eager flax init costs
    seconds), for tlie_tpu's state factories."""

    def __init__(self, module):
        self.init, self.apply = jax.jit(module.init), module.apply


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


def stub_card(monkeypatch, cs, decay_kernels: bool = False, head_kernels: bool = False,
              scan_kernels: bool = False, attention_kernels: bool = False):
    """The card's timers and profiler stubbed for a CPU rehearsal of
    ``chip_smoke`` (CUDA events that time nothing, a profiler that sees no
    device time), every launch count set to 0; with ``decay_kernels`` the
    decay attention's routing forced to its ``*_cuda`` wrappers, which run
    the plain versions and count their launches under the kernels' names,
    and with ``head_kernels`` the fused head's, with ``scan_kernels`` the
    diagonal scan's and with ``attention_kernels`` the flash attention's the
    same way."""
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import decay_attention as da
    from tlie_tpu_torch.ops import fused_xent as fx
    from tlie_tpu_torch.ops import scan as sc

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
    monkeypatch.setattr(da, "LOAD_ROUTES", {})
    monkeypatch.setattr(cs, "top_device_ops", lambda fn, k=6: (fn(), [])[1])
    if head_kernels:
        def fwd(h, w, b, labels):
            LAUNCHES[fx.launch_name("fwd", h.dtype)] += 1
            return fx.fused_xent_fwd_plain(h, w, b, labels)

        def dh(*args):
            LAUNCHES[fx.launch_name("dh", args[0].dtype)] += 1
            return fx.fused_xent_bwd_plain(*args)[0]

        def dw(*args):
            LAUNCHES[fx.launch_name("dw", args[0].dtype)] += 1
            return fx.fused_xent_bwd_plain(*args)[1:]

        monkeypatch.setattr(fx, "_on_cuda", lambda t: True)
        for name, stub in (("fwd", fwd), ("dh", dh), ("dw", dw)):
            monkeypatch.setattr(fx, f"fused_xent_{name}_cuda", stub)
    if scan_kernels:
        def scan_fwd(a, b, reverse=False):
            LAUNCHES["diag_scan"] += 1
            return sc.diag_scan_plain(a, b, reverse)

        def scan_bwd(a, h, g, reverse=False):
            LAUNCHES["diag_scan_bwd"] += 1
            return sc.diag_scan_bwd_plain(a, h, g, reverse)

        monkeypatch.setattr(sc, "_on_cuda", lambda t: True)
        monkeypatch.setattr(sc, "diag_scan_cuda", scan_fwd)
        monkeypatch.setattr(sc, "diag_scan_bwd_cuda", scan_bwd)
    if attention_kernels:
        from tlie_tpu_torch.ops import attention as fa

        def counted(name, plain):
            def launch(*args):
                LAUNCHES[name] += 1
                return plain(*args)
            return launch

        monkeypatch.setattr(fa, "_on_cuda", lambda t: True)
        for kind, plain in (("fwd", fa.flash_attention_plain),
                            ("bwd_dkv", fa.flash_attention_bwd_dkv_plain),
                            ("bwd_dq", fa.flash_attention_bwd_dq_plain)):
            monkeypatch.setattr(fa, f"flash_attention_{kind}_cuda",
                                counted(f"flash_attention_{kind}", plain))
    if not decay_kernels:
        return

    def counting(kernel, plain):
        def run(*args):  # (C, B, cs, xdt[, dy]): counted as the wrapper counts its launch
            da._count(kernel, args[3].dtype, args[0], args[1], *args[3:])
            return plain(*args)
        return run

    monkeypatch.setattr(da, "_on_cuda", lambda t: True)
    for kernel, plain in (("fwd", da.decay_attention_plain),
                          ("bwd_i", da.decay_attention_bwd_i_plain),
                          ("bwd_j", da.decay_attention_bwd_j_plain)):
        monkeypatch.setattr(da, f"decay_attention_{kernel}_cuda", counting(kernel, plain))


def load_chip_smoke():
    """``chip_smoke.py`` imported as a module."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


ARTIFACT_FILES = sorted([f"{k}.npy" for k in (
    "eig", "eig_init", "percentage", "percentage_init", "percentage_phase",
    "percentage_phase_init", "percentage_mean", "percentage_init_mean", "percentage_std",
    "percentage_init_std")] + ["percentage_file.txt", "used_config.yaml"])


def run_ssm_path(monkeypatch, full, tag, steps=4, eval_every=2):
    """``chip_smoke.ssm_family_path`` (paths 12 and 13) on the CPU at a tiny
    cut of ``full`` (L 64, vocab 256, d_model and state 32, batch 32, 256
    train and 96 test examples, prompts of 48 tokens), the card stubbed
    and the scan kernels replaced by counting plain versions.  Returns the
    path's launch counts and its step count."""
    import copy

    from tlie_tpu_torch.data import MQAR

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
    monkeypatch.setattr(cs, "ATT_PROMPT", 48)
    tiny = copy.deepcopy(full)
    tiny["dataset"].update(input_seq_length=64, num_kv_pairs=8, vocab_size=256)
    tiny["train"]["batch_size"] = 32
    tiny["model"].update(seq_len=64, input_dim=256, output_dim=256, hidden_dim=32, state_dim=32)
    data = MQAR(input_seq_length=64, num_kv_pairs=8, vocab_size=256, num_train_examples=256,
                num_test_examples=96)
    test_x, test_y = data.split("test")
    launches, s5_times = cs.ssm_family_path(torch.device("cpu"), test_x, test_y,
                                            data.split("train"), ARTIFACT_FILES, tiny, tag,
                                            steps, eval_every)
    assert (s5_times is not None) == (full["model"]["layer"] == "s5")
    return launches, steps
