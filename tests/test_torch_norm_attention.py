"""The port's norm attention against tlie_tpu's: ``norm_fn_by_name``,
``approx_fn_by_name``, ``init_offset`` and both ``offset_init`` values; the
small MQAR norm-attention transformer's logits and masked-CE gradients
through weights carried by ``compat.py`` (both ways, exact), with and
without the conv, the offset and ``scale_B``; ``eig_att_norm`` and eval_eig's
artifacts; the decoder (step path, prefill, greedy tokens); the init η
distribution; and the full config.

The model is ``configs/tasks/mqar/mqar-norm-attention-conv.yaml`` shrunk (2
layers, d_model 32, two heads of 16, vocab 64) at L 40 (ragged against the
chunk of 128) and L 64.  Inputs are made with numpy from a seed; JAX runs
jitted at HIGHEST matmul precision (tests/conftest.py).  Parity runs at
dropout 0.  Tolerances are stated where they are used.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from tlie_tpu.analysis.eval_eig import _extract_attention_family
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_att_norm as jax_eig_att_norm
from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu.data.mqar import MQAR as JaxMQAR
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models import attention_layers as jal
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.analysis.extractors import eig_att_norm
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import MQAR_NORM_ATTENTION_CONV_FULL
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import attention_layers as pal
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
from tlie_tpu_torch.training.state import make_family_optimizer
from tlie_tpu_torch.training.steps import head_logits
from torch_parity import jax_sparse_loss, jax_transformer_params, port_transformer, to_numpy

torch.set_num_threads(1)

FULL_YAML = "configs/tasks/mqar/mqar-norm-attention-conv.yaml"
L = 40


def small_config(length=L):
    """The MQAR norm-attention config shrunk: d_model 32, two heads of 16,
    vocab 64, L ``length``."""
    cfg = jax_load_experiment(FULL_YAML).raw
    cfg["dataset"].update(input_seq_length=length, num_kv_pairs=4, vocab_size=64,
                          num_train_examples=128, num_test_examples=64)
    cfg["model"].update(hidden_dim=32, state_dim=32, num_heads=2, vocab_size=64, output_dim=64,
                        seq_len=length)
    return cfg


# the MQAR config (softplus, elu, scale_B, offset from linspace, conv 4 over
# [v | q | k]) and variants that turn each part off or change it
_VARIANTS = {
    "mqar_conv": {},
    "no_conv_uniform_offset": {"dim_conv": 0, "offset_init": "uniform"},
    "qk_conv_glu_exp_no_offset": {"dim_conv": 3, "conv_type": "qk", "mixer": "glu",
                                  "offset": False, "norm_fn": "exp", "approx_fn": "none",
                                  "scale_B": False},
    "sigmoid": {"norm_fn": "sigmoid"},
    "elu": {"norm_fn": "elu", "dim_conv": 0},
}


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    model_cfg = dict(cfg["model"], dropout=0.0)
    data = MQAR(**cfg["dataset"])
    train, test = data.split("train"), data.split("test")
    return cfg, model_cfg, train, test, sparse_head_k_for(model_cfg, train[1], test[1])


# -- the layer's pieces ---------------------------------------------------------

def test_functions_by_name_and_offset_inits_match_tlie_tpu():
    """Each norm_fn and approx_fn on the same inputs (1e-6 relative), and
    ``init_offset`` and both ``offset_init`` values equal for 1, 2, 3 and 8
    heads, read from the port's ``MHNA`` and tlie_tpu's initialised params;
    an unknown name raises RuntimeError in both."""
    x = np.linspace(-6, 6, 97).astype(np.float32)
    for name in ("exp", "elu", "softplus", "sigmoid"):
        np.testing.assert_allclose(pal.norm_fn_by_name(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jal.norm_fn_by_name(name)(x)), rtol=1e-6)
    for name in ("none", "elu"):
        np.testing.assert_allclose(pal.approx_fn_by_name(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jal.approx_fn_by_name(name)(x)), rtol=1e-6)
    for bad in (pal.norm_fn_by_name, pal.approx_fn_by_name):
        with pytest.raises(RuntimeError, match="not implemented"):
            bad("tanh")
    xs = np.zeros((1, 4, 24), np.float32)
    for heads in (1, 2, 3, 8):
        np.testing.assert_array_equal(pal.init_offset(heads), jal.init_offset(heads))
        for init in ("uniform", "exp"):
            jm = jal.MHNA(d_model=24, d_qk=48, num_heads=heads, offset=True, offset_init=init)
            want = np.asarray(jm.init(jax.random.PRNGKey(0), xs)["params"]["offset"])
            port = pal.MHNA(24, torch.Generator(), d_qk=48, num_heads=heads, offset=True,
                            offset_init=init)
            np.testing.assert_array_equal(port.offset.detach().numpy(), want)
            assert port.Wvqkn.weight.shape == (24 + 2 * 48 + heads, 24)
    with pytest.raises(RuntimeError, match="Invalid init option"):
        pal.MHNA(16, torch.Generator(), offset=True, offset_init="zeros")
    assert pal.MHNA(16, torch.Generator(), offset=False, offset_init="zeros").offset is None


@pytest.mark.parametrize("variant", ["mqar_conv", "qk_conv_glu_exp_no_offset"])
def test_compat_carries_wvqkn_and_offset_both_ways_exactly(variant):
    """params_from_jax then params_to_jax gives tlie_tpu's flax tree back
    bit for bit, and the other way round the port's state_dict; the flax
    paths of ``Wvqkn`` and ``offset``."""
    cfg = dict(small_config()["model"], **_VARIANTS[variant])
    _, params = jax_transformer_params(cfg, seed=2)
    sd = params_from_jax(params)
    assert "layers.0.attention.Wvqkn.weight" in sd and "layers.1.attention.Wvqkn.bias" in sd
    assert ("layers.0.attention.offset" in sd) == cfg["offset"]
    assert flax_path("layers.1.attention.offset") == ("params", "layers_1", "attention", "offset")
    back, stats = params_to_jax(sd)
    assert stats is None
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(back)] == [p for p, _ in leaves]
    for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _, model = port_transformer(cfg, params)
    again = params_from_jax(params_to_jax(model.state_dict())[0])
    assert again.keys() == model.state_dict().keys()
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("length", [L, 64], ids=["ragged_l40", "l64"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_logits_match_jax(variant, length):
    """The eval forward's log-probs on 4 examples, 2e-5 absolute."""
    cfg = dict(small_config(length)["model"], dropout=0.0, **_VARIANTS[variant])
    jeval, params = jax_transformer_params(cfg, seed=3)
    x = np.random.default_rng(length).integers(0, 64, (4, length)).astype(np.int32)
    want = jax.nn.log_softmax(jax.jit(jeval.apply)({"params": params}, x))
    _, model = port_transformer(cfg, params)
    assert isinstance(model.layers[0].attention, pal.MHNA)
    with torch.no_grad():
        got = torch.log_softmax(model(torch.from_numpy(x).long()), -1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("variant", ["mqar_conv", "qk_conv_glu_exp_no_offset"])
def test_every_gradient_of_the_masked_ce_matches_jax(small, variant):
    """The sparse-head masked CE (1e-5 relative) and the gradient of every
    leaf, ``offset`` included, within 1e-4 of that leaf's max|g|."""
    _, model_cfg, train, _, k = small
    cfg = dict(model_cfg, **_VARIANTS[variant])
    jeval, params = jax_transformer_params(cfg, seed=0)
    x, y = train[0][:32], train[1][:32]
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_sparse_loss(jeval, k)))(
        params, x.astype(np.int32), y.astype(np.int32))
    model, _ = port_transformer(cfg, params)
    loss = cross_entropy_loss(*head_logits(model, torch.from_numpy(x), torch.from_numpy(y), k))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    assert len(jax.tree_util.tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=str(path))


@pytest.mark.parametrize("norm_fn, offset", [("softplus", True), ("exp", False),
                                             ("sigmoid", True), ("elu", False)])
def test_eig_att_norm_matches_jax_and_guards_zeros(norm_fn, offset):
    """``eig_att_norm`` against tlie_tpu's, 1e-5 relative (the BASELINE.json
    tolerance), with and without the offset; where exp(−norm_fn(n))
    underflows to 0 (four steps of one example whose n-projection is 700,
    far past float32's subnormals, which XLA's CPU flushes and torch keeps)
    both put 2e-23 in its place."""
    rng = np.random.default_rng(6)
    d_model, d_qk, H = 8, 6, 2
    x = rng.standard_normal((3, L, d_model)).astype(np.float32)
    W = (rng.standard_normal((d_model, d_model + 2 * d_qk + H)) * 0.7).astype(np.float32)
    b = rng.standard_normal(d_model + 2 * d_qk + H).astype(np.float32)
    off = np.array([4.0, 9.0], np.float32) if offset else None
    fn = jax.jit(jax_eig_att_norm, static_argnums=(3, 4, 5), static_argnames=("norm_fn",))
    # the n-projection small enough that exp(−exp(n)) stays a normal float32
    # elsewhere
    W[:, d_model + 2 * d_qk:] *= 0.3
    b[d_model + 2 * d_qk:] *= 0.3
    x[..., 0] = 0.0
    x[1, 5:9, 0] = 100.0
    W[0, d_model + 2 * d_qk:] = 7.0
    want = np.asarray(fn(x, W, b, d_qk, d_model, H, norm_fn=norm_fn, offset=off))
    got = eig_att_norm(torch.from_numpy(x), torch.from_numpy(W.T.copy()), torch.from_numpy(b),
                       d_qk, d_model, norm_fn,
                       offset=None if off is None else torch.from_numpy(off)).numpy()
    assert got.shape == want.shape == (3, L - 1, H) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if norm_fn in ("softplus", "exp"):  # 2e-23 / 2e-23 inside the run, ratios at its ends
        np.testing.assert_array_equal(got[1, 5:8], 1.0)
        assert np.all(got[1, 4] < 1e-15) and np.all(got[1, 8] > 1e15)


def test_eval_eig_artifacts_match_tlie_tpu(small, tmp_path):
    """From one port checkpoint (the small model after two large steps),
    both packages write the same 12 artifacts under the same name: the
    trained η within 1e-5 relative, the percentages within 1e-5 and the
    report's trained lines equal; eval_eig passes the offset only where the
    config sets ``offset`` (with it unset the η equal the offset-free
    formula)."""
    cfg, model_cfg, train, test, k = small
    args = copy.deepcopy(cfg)
    args["model"] = model_cfg
    _, params = jax_transformer_params(model_cfg, seed=1)
    model, _ = port_transformer(model_cfg, params)
    opt, clip = make_family_optimizer(model, "transformer", model_cfg, cfg["train"],
                                      {"lr": 0.05, "wd": 0.1, "betas": (0.9, 0.999)})
    x, y = torch.from_numpy(train[0][:32]), torch.from_numpy(train[1][:32])
    for _ in range(2):
        train_step(model, opt, x, y, {"regular": 0.05}, k, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    batch = test[0][:16]
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(batch.astype(np.int32), test[1][:16], {})], ckpt, 0.5,
                           params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir
    pfiles = sorted(os.listdir(tmp_path / "port" / pdir))
    assert pfiles == sorted(os.listdir(tmp_path / "jax" / jdir)) and len(pfiles) == 12
    eig = port_out[0]
    assert eig.shape == port_out[1].shape == (16, L - 1, 2, 2) and eig.dtype == np.float32
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=1e-5, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    # with offset unset in the config, the extractor leaves the parameter out
    xb = torch.from_numpy(batch).long()
    with_off = extract_attention_family(model.eval(), xb, model_cfg)
    without = extract_attention_family(model, xb, dict(model_cfg, offset=False))
    h = model.layers[0](model.encoder(xb))
    a = model.layers[0].attention
    direct = eig_att_norm(h, a.Wvqkn.weight, a.Wvqkn.bias, a.d_qk, a.d_model, "softplus")
    np.testing.assert_array_equal(without[..., 0], direct.detach().numpy())
    assert not np.array_equal(with_off, without)


def test_init_eta_spectra_match_tlie_tpus_distribution():
    """Init η of the small MQAR model on one batch, pooled over six seeds in
    each package: the 5/25/50/75/95 % quantiles of log η per layer within
    0.1 (a seed-to-seed spread of about 0.04 measured at this size)."""
    cfg = dict(small_config(64)["model"], dropout=0.0)
    x = np.random.default_rng(0).integers(0, 64, (16, 64)).astype(np.int32)
    jeval, _ = jax_transformer_params(cfg, seed=0)
    init = jax.jit(jeval.init)
    jax_eta, port_eta = [], []
    for s in range(6):
        p = init(jax.random.PRNGKey(s), x[:1])["params"]
        jax_eta.append(np.asarray(_extract_attention_family(jeval, p, x, cfg)))
        _, m, _ = build_models(cfg, generator=torch.Generator().manual_seed(s), device="cpu")
        port_eta.append(extract_attention_family(m, torch.from_numpy(x).long(), cfg))
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    for layer in range(cfg["num_layers"]):
        want = np.quantile(np.log(np.stack(jax_eta)[..., layer]), qs)
        got = np.quantile(np.log(np.stack(port_eta)[..., layer]), qs)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1)


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["mqar_conv", "no_conv_uniform_offset",
                                     "qk_conv_glu_exp_no_offset"])
def test_stepwise_and_prefill_match_the_full_forward(small, variant):
    """The step path over S (and the conv's tail) against the full forward,
    2e-5 of max|logit|; prefill's last logits likewise, its state equal to
    the steps' (1e-5 of max|S|), and a step from it; without a position
    table generation runs past the training length."""
    cfg = dict(small[1], **_VARIANTS[variant])
    _, params = jax_transformer_params(cfg, seed=9)
    _, model = port_transformer(cfg, params)
    dec = Decoder(cfg, model, device="cpu")
    x = torch.from_numpy(small[3][0][:3])
    with torch.no_grad():
        full = model(x)
    tol = 2e-5 * full.abs().max().item()
    torch.testing.assert_close(dec.stepwise_logits(x), full, rtol=0, atol=tol)
    cache, last = dec.prefill(x[:, :20])
    torch.testing.assert_close(last, full[:, 19], rtol=0, atol=tol)
    stepped = dec.init_cache(3)
    for t in range(20):
        stepped, _ = dec.step(stepped, x[:, t], t)
    for c, s in zip(cache, stepped):
        assert c[-1].shape == (3, 2, 16, 16)
        assert len(c) == (2 if cfg["dim_conv"] else 1)
        for a, b in zip(c, s):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
    _, logits = dec.step(cache, x[:, 20], 20)
    torch.testing.assert_close(logits, full[:, 20], rtol=0, atol=tol)
    assert dec.generate(x, 24).shape == (3, L + 24)


@pytest.mark.parametrize("variant", ["mqar_conv", "qk_conv_glu_exp_no_offset"])
def test_prefill_state_and_greedy_tokens_match_jax(small, variant):
    """Prefill's logits and (conv tail, S) against tlie_tpu's Decoder on the
    same weights (2e-5 of each one's max), and 8 greedy tokens (equal)."""
    cfg = dict(small[1], **_VARIANTS[variant])
    _, params = jax_transformer_params(cfg, seed=7)
    model, _ = port_transformer(cfg, params)
    jdec, dec = JaxDecoder(cfg, params), Decoder(cfg, model.state_dict(), device="cpu")
    prompt = small[3][0][:3, :24]
    jcache, jlogits = jdec.prefill(prompt.astype(np.int32), 32)
    cache, logits = dec.prefill(prompt, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=2e-5)
    for c, jc in zip(cache, jcache):
        assert len(c) == len(jc) == 2
        for a, b in zip(c, jc):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-5 * np.abs(b).max())
    want = np.asarray(jdec.generate(prompt.astype(np.int32), 8))
    np.testing.assert_array_equal(dec.generate(prompt, 8).numpy(), want)


# -- the full config ------------------------------------------------------------

def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    exp = jax_load_experiment(FULL_YAML)
    data = JaxMQAR(**exp.dataset)

    class _Shape:
        l_max = data.l_max
        train_inputs = range(data.num_train_examples)

    exp.derive_runtime_fields(_Shape())
    assert MQAR_NORM_ATTENTION_CONV_FULL == exp.raw


# -- the card run's paths 6 and 7, rehearsed ------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("attention_fn", ["lin-attention", "norm-attention"])
def test_chip_smoke_paths_6_and_7_run_on_the_cpu(monkeypatch, attention_fn):
    """``chip_smoke.attention_family_path`` at a tiny size on the CPU, with
    the card's timers and profiler stubbed: every check of the path (the
    forward against the CPU, training, the checkpoint's spectra, serving,
    the step against float64, no port kernel launched) runs as on the
    card."""
    from tlie_tpu_torch.config import MQAR_LIN_ATTENTION_FULL
    from tlie_tpu_torch.ops import LAUNCHES

    cs = _chip_smoke()

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
        monkeypatch.setitem(LAUNCHES, key, LAUNCHES[key])
    monkeypatch.setattr(cs, "top_device_ops", lambda fn, k=6: (fn(), [])[1])
    monkeypatch.setattr(cs, "ATT_PROMPT", 48)
    full = MQAR_LIN_ATTENTION_FULL if attention_fn == "lin-attention" else \
        MQAR_NORM_ATTENTION_CONV_FULL
    tiny = copy.deepcopy(full)
    tiny["dataset"].update(input_seq_length=64, num_kv_pairs=8, vocab_size=256)
    tiny["train"]["batch_size"] = 32
    tiny["model"].update(seq_len=64, vocab_size=256, output_dim=256, hidden_dim=32, state_dim=32)
    if tiny["model"]["max_pos_embed"]:
        tiny["model"]["max_pos_embed"] = 64
    data = MQAR(input_seq_length=64, num_kv_pairs=8, vocab_size=256, num_train_examples=256,
                num_test_examples=96)
    test_x, test_y = data.split("test")
    files = sorted([f"{k}.npy" for k in ("eig", "eig_init", "percentage", "percentage_init",
                                          "percentage_phase", "percentage_phase_init",
                                          "percentage_mean", "percentage_init_mean",
                                          "percentage_std", "percentage_init_std")]
                   + ["percentage_file.txt", "used_config.yaml"])
    launches = cs.attention_family_path(torch.device("cpu"), test_x, test_y, data.split("train"),
                                        files, tiny, attention_fn.split("-")[0], 4, 2)
    assert set(launches) == set(LAUNCHES) and not any(launches.values())
