"""The transformer's last options against ``tlie_tpu``: the ``hybrid`` mixer
(``LAMBDA``, a learned convex combination of a GLU and an MLP on one
encoder) and the dense input encoder (``embedding: false``).

- ``LAMBDA``'s values and gradients, α's included, and the float32 mix its
  (1,)-shaped α gives under bfloat16;
- the hybrid and dense-encoder transformers' logits (2e-5 of max|logit|)
  and gradients (1e-4 of each leaf's max|g|) on ``tlie_tpu``'s weights, and
  in bfloat16 their log-probs (two roundings of the largest, 0.004 in the
  mean, nearer than the float32 model, which fails that) and each module's
  output dtype;
- ``compat`` both ways (``layers.{i}.mixer.alpha``, the dense
  ``encoder``);
- greedy decoding of a hybrid LM against the forward, and the
  ``ValueError`` for ``embedding: false`` in both packages;
- ``mixer_alpha_{i}`` = σ(α_i) in the run logger's records;
- an untokenized grayscale CIFAR batch through ``prep_batch`` reaching the
  dense encoder as ``tlie_tpu``'s does; eval_eig of a hybrid dense-encoder
  classifier against ``tlie_tpu``'s; two stacked hybrid points against
  their serial runs;
- ``chip_smoke.hybrid_classifier_path`` (path 36) rehearsed on the CPU
  with counting plain flash kernels.

Weights are ``tlie_tpu``'s, drawn under jit and carried with ``compat``;
inputs are made with numpy from a seed.  JAX runs jitted at HIGHEST matmul
precision (tests/conftest.py).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_torch_sweep_families import _mqar_config, _stacked_vs_serial
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.data import cifar as jax_cifar
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models import layers as jax_layers
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training.steps import prep_batch as jax_prep_batch
from tlie_tpu_torch import compat
from tlie_tpu_torch import config as config_mod
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.data import CIFAR10
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models.layers import LAMBDA
from tlie_tpu_torch.training import cross_entropy_loss, prep_batch, save_checkpoint, train
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

U = 2.0 ** -8  # bfloat16's unit roundoff
L, D, V = 32, 32, 64
BASE = {
    "input_dim": 1, "output_dim": V, "layer": "transformer", "attention_fn": "sm-attention",
    "use_flash": True, "num_layers": 1, "hidden_dim": D, "state_dim": D, "num_heads": 2,
    "att_dropout": 0.0, "norm": "layer", "embedding": True, "vocab_size": V,
    "max_pos_embed": L, "mixer": "hybrid", "mixer_dim": D, "dropout": 0.0, "classifier": False,
    "pooling": "mean", "dual": False, "seq_len": L,
}
VARIANTS = {
    # the hybrid mixer on tokens, a decoder on every position
    "hybrid_lm": {},
    # the dense encoder on 3 float features, the GLU mixer, with the gate
    "dense_glu_gate": {"embedding": False, "input_dim": 3, "mixer": "glu", "use_gate": True},
    # both, as a pooled classifier on one float feature (CIFAR's grey levels)
    "dense_hybrid_classifier": {"embedding": False, "input_dim": 1, "classifier": True,
                                "output_dim": 10},
}


def _cfg(variant, **over):
    return {**BASE, **VARIANTS[variant], **over}


def _inputs(cfg, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    if cfg["embedding"]:
        return rng.integers(0, V, (batch, L)).astype(np.int32)
    return rng.standard_normal((batch, L, cfg["input_dim"])).astype(np.float32)


def _labels(cfg, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    shape = (batch,) if cfg["classifier"] else (batch, L)
    return rng.integers(0, cfg["output_dim"], shape).astype(np.int64)


_JAX_CACHE = {}


def _jax(cfg, seed=0):
    """(eval model, params) of ``tlie_tpu``'s transformer, initialised under
    jit once a config and seed (the tests below share them)."""
    key = (json.dumps(cfg, sort_keys=True), seed)
    if key not in _JAX_CACHE:
        _, jeval, _ = jax_build_models(dict(cfg), padded=False)
        x = _inputs(cfg, batch=1)
        _JAX_CACHE[key] = jeval, to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(seed), x)[
            "params"])
    return _JAX_CACHE[key]


def _port(cfg, params):
    model, eval_model, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


def _torch_in(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)


# -- LAMBDA ---------------------------------------------------------------------------------

def _lambda_pair(dtype=None):
    """flax's ``LAMBDA(init=0.2)`` and the port's carrying its weights, on x
    (2, 8, 16)."""
    d = 16
    x = np.random.default_rng(2).standard_normal((2, 8, d)).astype(np.float32)
    flax_mod = jax_layers.LAMBDA(init=0.2, dtype=dtype)
    # the field ``init`` shadows the module's ``init`` method
    params = to_numpy(jax.jit(lambda r, t: nn.Module.init(flax_mod, r, t))(
        jax.random.PRNGKey(4), x)["params"])
    port = LAMBDA(d, torch.Generator(), init=0.2,
                  compute_dtype=None if dtype is None else torch.bfloat16)
    with torch.no_grad():
        for name in ("encoder", "decoder"):
            getattr(port, name).weight.copy_(torch.from_numpy(params[name]["kernel"].T.copy()))
            getattr(port, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
        port.alpha.copy_(torch.from_numpy(params["alpha"]))
    return flax_mod, params, port, x


def test_lambda_matches_flax_in_values_and_gradients():
    """α starts at logit(0.2) of shape (1,); the output within 2e-5 of its
    max, and the gradients of Σ out·r (r fixed) in every weight, α and the
    input within 1e-4 of each one's max|g|."""
    flax_mod, params, port, x = _lambda_pair()
    assert port.alpha.shape == (1,) and float(torch.sigmoid(port.alpha)) == pytest.approx(0.2)
    r = np.random.default_rng(3).standard_normal((2, 8, 16)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(flax_mod.apply({"params": p}, xx) * r)

    want = np.asarray(jax.jit(flax_mod.apply)({"params": params}, x))
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    (out * torch.from_numpy(r)).sum().backward()
    pairs = [(port.alpha.grad, jg_p["alpha"]), (xt.grad, jg_x)]
    for name in ("encoder", "decoder"):
        pairs += [(getattr(port, name).weight.grad.T, jg_p[name]["kernel"]),
                  (getattr(port, name).bias.grad, jg_p[name]["bias"])]
    for got, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_lambdas_float32_alpha_promotes_the_bf16_mix_to_float32():
    """Under bfloat16 compute both packages' LAMBDA return float32 (a (1,)
    float32 α beside the bfloat16 halves), within a few bfloat16 roundings
    of each other; a 0-d α would leave the port's mix in bfloat16."""
    flax_mod, params, port, x = _lambda_pair(dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(flax_mod.apply)({"params": params}, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        glu = torch.ones(2, dtype=torch.bfloat16)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * U * np.abs(want).max())
    assert (torch.sigmoid(port.alpha.detach()) * glu).dtype == torch.float32
    assert (torch.sigmoid(port.alpha.detach()[0]) * glu).dtype == torch.bfloat16


# -- the models against tlie_tpu -------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_gradients_match_jax(variant):
    """The eval forward within 2e-5 of max|logit|; the masked CE (1e-5
    relative) and the gradient of every leaf, α included, within 1e-4 of
    its max|g|; the hybrid mixers' α at logit(0.2)."""
    cfg = _cfg(variant)
    jeval, params = _jax(cfg, seed=3)
    x, y = _inputs(cfg), _labels(cfg)
    want = np.asarray(jax.jit(jeval.apply)({"params": params}, x))
    model, eval_model = _port(cfg, params)
    with torch.no_grad():
        got = eval_model(_torch_in(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())

    from tlie_tpu.training.steps import cross_entropy_loss as jax_ce

    def jloss(p):
        return jax_ce(jeval.apply({"params": p}, x), y)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    loss = cross_entropy_loss(model(_torch_in(x)), torch.from_numpy(y))
    loss.backward()
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    got_g, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    got_leaves = jax.tree_util.tree_leaves_with_path(got_g)
    want_leaves = jax.tree_util.tree_leaves(to_numpy(jg))
    assert len(got_leaves) == len(want_leaves)
    for (path, g), w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=str(path))
    if cfg["mixer"] == "hybrid":
        alphas = [params[f"layers_{i}"]["mixer"]["alpha"] for i in range(cfg["num_layers"])]
        assert all(a.shape == (1,) and abs(a[0] - np.log(0.25)) < 1e-6 for a in alphas)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_log_probs_and_module_dtypes_match_tlie_tpu(variant):
    """``compute_dtype: bfloat16``: the port's log-probs within 2u of the
    largest |log-prob| of ``tlie_tpu``'s bf16 model and their mean within
    0.004; with the hybrid mixer also within 0.9 of the port's float32
    model's mean gap, which that control fails.  (The dense GLU variant's
    residual stream stays bfloat16 through every block, where each
    projection adds its bias before the product's one rounding in the port
    and after it in flax (``layers.Linear``): those roundings leave it as far
    from ``tlie_tpu``'s bf16 model as the float32 model is, 0.0040 against
    0.0037 in the mean, so its share is not held.)  The logits bfloat16
    (the classifier head's float32, as flax's ``ClassifierHead`` takes no
    dtype); every parameter-holding module's output in the dtype of
    ``tlie_tpu``'s module at the same place: the dense encoder bfloat16,
    each hybrid mixer float32 (its α), its encoder and decoder bfloat16."""
    cfg = _cfg(variant, compute_dtype="bfloat16")
    jeval, params = _jax(cfg, seed=5)
    x = _inputs(cfg, seed=6)
    jl, state = jax.jit(lambda p, t: jeval.apply({"params": p}, t, capture_intermediates=True,
                                                 mutable=["intermediates"]))(params, x)
    want = np.asarray(jax.nn.log_softmax(jnp.asarray(jl).astype(jnp.float32), -1))
    _, model = _port(cfg, params)
    _, control = _port({k: v for k, v in cfg.items() if k != "compute_dtype"}, params)
    seen = {}
    places = {}
    modules = dict(model.named_modules())
    for key in model.state_dict():
        mod_name = key.rsplit(".", 1)[0]
        places.setdefault(mod_name, compat.flax_path(key)[1:-1])
    for mod_name in places:
        modules[mod_name].register_forward_hook(
            lambda m, i, o, n=mod_name: seen.setdefault(n, []).append(str(o.dtype)[6:]))
    with torch.no_grad():
        logits = model(_torch_in(x))
        logits32 = control(_torch_in(x))
    assert str(logits.dtype)[6:] == str(jl.dtype)
    got = torch.log_softmax(logits.float(), -1).numpy()
    err = np.abs(got - want)
    gap32 = np.abs(torch.log_softmax(logits32, -1).numpy() - want).mean()
    assert err.max() <= 2 * U * np.abs(want).max() and err.mean() <= 0.004, (err.max(),
                                                                            err.mean())
    if cfg["mixer"] == "hybrid":
        assert err.mean() <= 0.9 * gap32, (err.mean(), gap32)

    flax_dtypes = {}

    def collect(tree, path=()):
        for k, v in tree.items():
            if k == "__call__":
                flax_dtypes[path] = [str(o.dtype) for o in v]
            else:
                collect(v, path + (k,))

    collect(state["intermediates"])
    compared = {m: (seen[m], flax_dtypes.get(places[m])) for m in places if m in seen}
    assert all(a == b for a, b in compared.values()), compared
    if cfg["mixer"] == "hybrid":
        assert seen["layers.0.mixer"] == ["float32"]
        assert seen["layers.0.mixer.encoder"] == ["bfloat16"]
    if not cfg["embedding"]:
        assert seen["encoder"] == ["bfloat16"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_compat_maps_both_ways(variant):
    """Every flax leaf has its place in the port (the hybrid mixer's
    ``layers.{i}.mixer.{encoder,decoder,alpha}``, α (1,) on both sides; the
    dense ``encoder.{weight,bias}`` ↔ ``encoder/{kernel,bias}``), and
    ``params_to_jax`` inverts ``params_from_jax`` bit for bit."""
    cfg = _cfg(variant)
    _, params = _jax(cfg, seed=3)
    sd = params_from_jax(params)
    model, _ = _port(cfg, params)
    assert sd.keys() == model.state_dict().keys()
    if cfg["mixer"] == "hybrid":
        assert sd["layers.0.mixer.alpha"].shape == (1,)
        assert compat.flax_path("layers.0.mixer.alpha") == ("params", "layers_0", "mixer",
                                                            "alpha")
    if not cfg["embedding"]:
        assert compat.flax_path("encoder.weight") == ("params", "encoder", "kernel")
        assert sd["encoder.weight"].shape == (D, cfg["input_dim"])
    back, stats = params_to_jax(sd)
    assert stats is None
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)


# -- serving ---------------------------------------------------------------------------------

def test_hybrid_lm_decodes_as_its_forward():
    """The hybrid LM's step path (each block's ``mix`` through LAMBDA) and
    its prefill against its full forward (2e-5 of max|logit|; the forward
    is held to ``tlie_tpu``'s above), and greedy tokens as the forward's
    argmax; a dense-encoder model raises ``ValueError`` in both packages."""
    cfg = _cfg("hybrid_lm")
    _, params = _jax(cfg, seed=3)
    _, model = _port(cfg, params)
    dec = Decoder(cfg, model, device="cpu")
    x = _inputs(cfg, batch=3, seed=10)
    with torch.no_grad():
        full = model(_torch_in(x))
    tol = 2e-5 * full.abs().max().item()
    torch.testing.assert_close(dec.stepwise_logits(_torch_in(x)), full, rtol=0, atol=tol)
    prompt = x[:, :20]
    _, logits = dec.prefill(prompt, 28)
    torch.testing.assert_close(logits, full[:, 19], rtol=0, atol=tol)
    out = dec.generate(prompt, 8)
    with torch.no_grad():
        forward = model(out)[:, 19:-1].argmax(-1)
    torch.testing.assert_close(out[:, 20:], forward, rtol=0, atol=0)
    dense = _cfg("dense_glu_gate")
    _, dparams = _jax(dense, seed=3)
    with pytest.raises(ValueError, match="token encoder"):
        Decoder(dense, params_from_jax(dparams), device="cpu")
    with pytest.raises(ValueError):
        JaxDecoder(dense, dparams)


# -- training: the logged mix, CIFAR's float pixels, eval_eig, stacked points ------------------

def test_mixer_alpha_is_logged_as_sigmoid_of_alpha(tmp_path, monkeypatch):
    """A hybrid MQAR transformer trained 4 steps with an eval every 2: each
    eval's record in the run logger holds ``mixer_alpha_{i}`` for every
    layer, the last equal to σ(α_i) of the trained mixers (moved off 0.2),
    as ``tlie_tpu``'s loop logs it (``loop.py:441-447``)."""
    monkeypatch.chdir(tmp_path)
    raw, tr, te, _ = _mqar_config("sm_flash", tmp_path)
    raw["model"]["mixer"] = "hybrid"
    raw["lang_model"] = True
    result = train(raw, tr, te, device="cpu")
    (log,) = os.listdir(tmp_path / "logs")
    recs = [json.loads(line) for line in (tmp_path / "logs" / log).read_text().splitlines()]
    evals = [r for r in recs if "test loss" in r]
    assert [r["step"] for r in evals] == [2, 4]
    alphas = [float(torch.sigmoid(layer.mixer.alpha.detach())[0])
              for layer in result.model.layers]
    assert [evals[-1][f"mixer_alpha_{i}"] for i in range(len(alphas))] == alphas
    assert all(abs(a - 0.2) > 1e-6 for a in alphas)
    assert all(set(r) >= {f"mixer_alpha_{i}" for i in range(len(alphas))} for r in evals)


def test_an_untokenized_cifar_batch_reaches_the_dense_encoder_as_in_tlie_tpu():
    """Grayscale CIFAR-10 without ``tokenize`` gives float pixels (N, 1024,
    1); through each package's ``prep_batch`` at input_dim 1 they stay (B,
    1024, 1) float32 with the same values (no one-hot), and a tiny
    hybrid dense-encoder classifier on them gives ``tlie_tpu``'s logits
    (2e-5 of max|logit|)."""
    kw = dict(grayscale=True, tokenize=False, synthetic=True)
    ours = CIFAR10(_name_="cifar", **kw)
    theirs = jax_cifar.CIFAR10(_name_="cifar", **kw)
    theirs.setup()
    x, y = ours.split("test")
    np.testing.assert_array_equal(x, theirs.test_inputs)
    batch = (x[:3], y[:3])
    got, _ = prep_batch(batch, 1024, 1, device="cpu")
    want, _ = jax_prep_batch(batch, 1024, 1)
    assert got.shape == (3, 1024, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = _cfg("dense_hybrid_classifier", seq_len=1024, num_layers=1, hidden_dim=16,
               state_dim=16, mixer_dim=16)
    _, jeval, _ = jax_build_models(dict(cfg), padded=False)
    params = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), np.asarray(want))["params"])
    jl = np.asarray(jax.jit(jeval.apply)({"params": params}, want))
    _, model = _port(cfg, params)
    with torch.no_grad():
        logits = model(got).numpy()
    np.testing.assert_allclose(logits, jl, rtol=0, atol=2e-5 * np.abs(jl).max())


def test_eval_eig_of_a_hybrid_dense_classifier_matches_tlie_tpu(tmp_path):
    """eval_eig of a hybrid dense-encoder classifier's checkpoint on float
    inputs in both packages: the same artifact set under the same name,
    the trained η within 1e-5 relative."""
    cfg = _cfg("dense_hybrid_classifier")
    _, params = _jax(cfg, seed=3)
    model, _ = _port(cfg, params)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": cfg})
    args = {"seed": 1919, "save": None, "model": cfg, "train": {"lr": 1e-3},
            "dataset": {"_name_": "cifar", "name": "CIFAR-10"}}
    batch = _inputs(cfg, batch=4, seed=12)
    got = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                   batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    want = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                        [(batch, np.zeros(4, np.int64), {})], ckpt, 0.5, params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and sorted(os.listdir(tmp_path / "port" / pdir)) == ARTIFACT_FILES
    assert got[0].shape == (4, L - 1, 2, 1)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5, atol=0)


def test_stacked_hybrid_points_equal_their_serial_runs(tmp_path):
    """Two points of a hybrid MQAR transformer (the sweep families' tiny
    softmax one, ``mixer: hybrid``) stacked by ``run_sweep`` against their
    serial runs, at the sweep families' float32 bounds."""
    raw, tr, te, l_max = _mqar_config("sm_flash", tmp_path)
    raw["model"]["mixer"] = "hybrid"
    _stacked_vs_serial(tmp_path, raw, tr, te, l_max)


# -- chip_smoke path 36 ------------------------------------------------------------------------

def test_chip_smoke_path_36_runs_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.hybrid_classifier_path`` on a cut of its config (2
    layers, d_model and d_qk 16, 2 heads, batch 4, 8 + 4 synthetic
    images), the card's timers stubbed and the flash kernels counted: the
    forward, an epoch of 2 steps with the exact launches, the logged
    ``mixer_alpha_{i}``, the spectra and the card step against the CPU's."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, attention_kernels=True)
    monkeypatch.chdir(tmp_path)
    cut = copy.deepcopy(config_mod.CIFAR_SM_ATTENTION_FULL)
    cut["dataset"].update(synthetic_train=8, synthetic_test=4)
    cut["train"].update(batch_size=4, train_size=8)
    cut["model"].update(num_layers=2, hidden_dim=16, num_heads=2, mixer_dim=8)
    monkeypatch.setattr(config_mod, "CIFAR_SM_ATTENTION_FULL", cut)
    for name, value in (("P36_TRAIN", 8), ("P36_D_QK", 16), ("CIFAR_ANALYSIS_BATCH", 2),
                        ("CIFAR_STEP_EXAMPLES", 1)):
        monkeypatch.setattr(cs, name, value)
    launches = cs.hybrid_classifier_path(torch.device("cpu"), ARTIFACT_FILES)
    # 2 layers: the forward (1), 2 steps and 1 eval batch, eval_eig's
    # forwards of its two models
    assert launches["flash_attention_bwd_dkv"] == launches["flash_attention_bwd_dq"] == 2 * 2
    assert launches["flash_attention_fwd"] >= 2 * (1 + 2 + 1)
    assert not any(v for k, v in launches.items() if not k.startswith("flash_attention"))
