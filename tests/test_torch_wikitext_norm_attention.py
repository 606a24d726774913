"""The port's WikiText norm-attention LM (``configs/wikitext-norm-attention-short.yaml``)
against tlie_tpu's: the MLP mixer, the model's log-probs and every gradient
of the dense head's loss through weights carried by ``params_from_jax``, one
AdamW + global-norm-clip step against ``make_train_block``, ``compat`` both
ways, eval_eig's norm η and artifacts, the decoder (teacher-forced step
path, prefill and greedy tokens), two stacked sweep points against their
serial runs, the resolved config, ``launch`` (serial and
``--sweep_parallel``) end to end on the CPU, and rehearsals of
``chip_smoke``'s paths 16 and 17.

The model is the config cut to 2 layers, d_model and d_qk 32, 4 heads of 8,
``mixer_dim`` 48, L 16 and vocab 97 (the launch tests keep the GPT-2
vocabulary of the synthetic stream at d_model 16 and block 64).  Inputs are
made with numpy from a seed; JAX runs jitted at HIGHEST matmul precision
(tests/conftest.py).  Parity runs at dropout 0, as the config sets it.
Tolerances are stated where they are used.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu.data.wikitext import WikiText as JaxWikiText
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models import layers as jax_layers
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state_adamw
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import (
    WIKITEXT_NORM_ATTENTION_SHORT, ExperimentConfig, apply_sweep_point, derive_runtime_fields,
    load_yaml,
)
from tlie_tpu_torch.data import WikiText
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models.layers import MLP
from tlie_tpu_torch.parallel import run_sweep
from tlie_tpu_torch.training import (
    cross_entropy_loss, restore_checkpoint, save_checkpoint, schedules, train, train_step,
)
from tlie_tpu_torch.training.scan_loop import batch_indices, put_dataset
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import (
    ARTIFACT_FILES, jax_transformer_params, load_chip_smoke, port_transformer, stub_card, to_numpy,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "configs" / "wikitext-norm-attention-short.yaml"
SWEEP_YAML = ROOT / "configs" / "sweep" / "wikitext-norm-attention-seeds-lrs.yaml"
L, V = 16, 97


def small_model_config(**over):
    """The config's model cut to 2 layers, d 32, 4 heads, mixer 48, L 16,
    vocab 97."""
    cfg = load_yaml(YAML)["model"]
    cfg.update(num_layers=2, hidden_dim=32, state_dim=32, num_heads=4, mixer_dim=48,
               vocab_size=V, output_dim=V, seq_len=L, **over)
    return cfg


def lm_batch(n, seed, length=L):
    """(tokens, next-token labels with a −100 tail), as WikiText builds them."""
    x = np.random.default_rng(seed).integers(0, V, (n, length)).astype(np.int64)
    y = np.full_like(x, -100)
    y[:, :-1] = x[:, 1:]
    return x, y


def tiny_lm_config(save=None, steps=6, eval_every=3):
    """configs/wikitext-norm-attention-short.yaml for the CPU: 2 layers of
    width 16 (4 heads, mixer 24), block 64, batch 2, a short synthetic
    stream of the GPT-2 vocabulary."""
    cfg = load_yaml(YAML)
    cfg["save"] = save
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=16, num_heads=4, mixer_dim=24)
    cfg["dataset"].update(block_size=64, synthetic_train_tokens=64 * 24 + 5,
                          synthetic_test_tokens=64 * 6)
    cfg["train"].update(total_steps=steps, eval_every=eval_every, batch_size=2, warmup_steps=2)
    return cfg


@pytest.fixture(scope="module")
def small():
    """The cut config at dropout 0 and tlie_tpu's weights for it."""
    model_cfg = small_model_config()
    jeval, params = jax_transformer_params(model_cfg, seed=0)
    return model_cfg, jeval, params


# -- the MLP mixer ----------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["no_dropout", "eval_mode_dropout"])
def test_mlp_matches_flax(dropout):
    """``MLP`` against tlie_tpu's (Dense → erf GELU → Dropout → Dense →
    Dropout) on the same weights in evaluation mode, 1e-6 absolute; its
    parameters are U(±1/√fan_in), ``encoder`` then ``decoder``."""
    x = np.random.default_rng(1).standard_normal((3, 5, 12)).astype(np.float32)
    jm = jax_layers.MLP(20, dropout=dropout, deterministic=True)
    p = to_numpy(jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"])
    want = np.asarray(jm.apply({"params": p}, x))
    m = MLP(12, 20, torch.Generator().manual_seed(0), dropout).eval()
    assert abs(m.encoder.weight).max() <= 12 ** -0.5 and abs(m.decoder.bias).max() <= 20 ** -0.5
    with torch.no_grad():
        for name in ("encoder", "decoder"):
            getattr(m, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            getattr(m, name).bias.copy_(torch.from_numpy(p[name]["bias"].copy()))
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mlp_dropout_draws_two_masks():
    """In training mode the mixer draws two independent keep masks from its
    generator, first over the GELU's output and then over the second
    projection's, each kept value scaled by 1/(1 − rate); in evaluation it
    is Dense → GELU → Dense."""
    m = MLP(8, 64, torch.Generator().manual_seed(0), 0.5).train()
    m.drop.generator = torch.Generator().manual_seed(3)
    x = torch.randn(4, 6, 8)
    with torch.no_grad():
        out = m(x)
        g = torch.Generator().manual_seed(3)
        h = torch.nn.functional.gelu(m.encoder(x))
        h = h * torch.empty(h.shape).bernoulli_(0.5, generator=g) / 0.5
        y = m.decoder(h)
        want = y * torch.empty(y.shape).bernoulli_(0.5, generator=g) / 0.5
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        assert 0 < int((out == 0).sum()) < out.numel()
        torch.testing.assert_close(m.eval()(x),
                                   m.decoder(torch.nn.functional.gelu(m.encoder(x))))


# -- the model ------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [{}, {"dim_conv": 0}, {"offset": False, "norm_fn": "exp"}],
                         ids=["config", "no_conv", "exp_no_offset"])
def test_logits_match_jax(variant):
    """The eval forward's log-probs on 3 sequences, 2e-5 absolute."""
    cfg = small_model_config(**variant)
    jeval, params = jax_transformer_params(cfg, seed=3)
    x, _ = lm_batch(3, 3)
    want = jax.nn.log_softmax(jax.jit(jeval.apply)({"params": params}, x.astype(np.int32)))
    _, model = port_transformer(cfg, params)
    assert isinstance(model.layers[0].mixer, MLP)
    with torch.no_grad():
        got = torch.log_softmax(model(torch.from_numpy(x)), -1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


def _jax_dense_loss(model):
    def loss(params, x, y):
        return jax_scan_loop.cross_entropy_loss(model.apply({"params": params}, x), y)
    return loss


def test_every_gradient_of_the_dense_head_matches_jax(small):
    """The dense head's masked CE over the −100-tailed labels (1e-5
    relative; WikiText takes no sparse head) and the gradient of every leaf,
    the mixer's included, within 1e-4 of that leaf's max|g|."""
    model_cfg, jeval, params = small
    x, y = lm_batch(4, 4)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_dense_loss(jeval)))(
        params, x.astype(np.int32), y.astype(np.int32))
    model, _ = port_transformer(model_cfg, params)
    loss = cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    assert "mixer" in got["layers_1"] and set(got["layers_1"]["mixer"]) == {"encoder", "decoder"}
    assert len(jax.tree_util.tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=str(path))


def test_adamw_clip_step_matches_make_train_block(small):
    """One AdamW step behind the global-norm clip at the config's betas
    (0.9, 0.95), weight decay 0.1 and a rate of 1e-3, through the dense
    head, against ``make_train_block``: the loss (1e-5 relative), and the
    parameters 2e-6 absolute where |g| is at least 1e-2 of its leaf's max
    or exactly 0 (weight decay alone moves them), within the movement bound
    2·lr + 2e-6 everywhere (Adam divides each element by its own magnitude;
    see tests/test_torch_mamba2.py); over 40 % of the elements with a
    gradient are held to the 2e-6."""
    model_cfg, _, params = small
    tc = dict(load_yaml(YAML)["train"], warmup_steps=0, batch_size=4)
    lr, betas = 1e-3, tuple(tc["betas"])
    x, y = lm_batch(32, 5)
    jmodel, _, _ = jax_build_models(model_cfg, padded=False)
    state, _ = create_train_state_adamw(
        jmodel, jax.random.PRNGKey(0), in_dim=model_cfg["input_dim"], batch_size=2,
        seq_len=L, weight_decay=tc["wd"], lr=lr, betas=betas, integer_inputs=True,
        param_group=None)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    groups = tuple(sorted(state.opt_state.inner_states))
    block = jax_scan_loop.make_train_block(jmodel, "layer", groups, 0, tc["total_steps"],
                                           tc["cosine_anneal"], 1e-6, sparse_head_k=None)
    idx = batch_indices(np.random.default_rng(0), len(x), tc["batch_size"], 1)
    jstate, jloss = block(state, jax.random.PRNGKey(1),
                          jax_scan_loop.put_dataset(x.astype(np.int32), y.astype(np.int32)),
                          idx, 0, lr, lr)

    model, _ = port_transformer(model_cfg, params)
    opt, clip = make_family_optimizer(model, "transformer", model_cfg, tc,
                                      {"lr": lr, "ssm_lr": lr, "wd": tc["wd"], "betas": betas})
    data = put_dataset(x, y, "cpu")
    rate = schedules.lr_for_step(0, lr, 0, tc["total_steps"], tc["cosine_anneal"], 1e-6)
    i = torch.from_numpy(idx[0]).long()
    loss = float(train_step(model, opt, data.inputs[i], data.labels[i], {"regular": rate}, None,
                            clip_norm=clip))
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax(model.state_dict())
    g1, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    n_det = n_all = 0
    for (path, g), w, gr in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(to_numpy(jstate.params)),
                                jax.tree_util.tree_leaves(g1)):
        err = np.abs(g - w)
        det = np.abs(gr) >= 1e-2 * np.abs(gr).max()
        assert err[det | (gr == 0)].max(initial=0.0) <= 2e-6, path
        assert err.max() <= 2 * rate + 2e-6, path
        n_det, n_all = n_det + det.sum(), n_all + (gr != 0).sum()
    assert n_det > 0.4 * n_all


def test_compat_carries_the_mixer_both_ways_exactly(small):
    """``layers.{i}.mixer.{encoder,decoder}`` map onto
    ``layers_i/mixer/{encoder,decoder}``: params_from_jax then params_to_jax
    gives tlie_tpu's tree back bit for bit, and the port's keys are the
    reference's torch names."""
    model_cfg, _, params = small
    sd = params_from_jax(params)
    for i in range(2):
        for part in ("encoder", "decoder"):
            assert sd[f"layers.{i}.mixer.{part}.weight"].shape == (
                (48, 32) if part == "encoder" else (32, 48))
            assert flax_path(f"layers.{i}.mixer.{part}.bias") == (
                "params", f"layers_{i}", "mixer", part, "bias")
    back, stats = params_to_jax(sd)
    assert stats is None
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(back)] == [p for p, _ in leaves]
    for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _, model = port_transformer(model_cfg, params)
    assert set(model.state_dict()) == set(sd)


def test_eval_eig_artifacts_match_tlie_tpu(small, tmp_path):
    """From one port checkpoint (the small LM after two large steps), both
    packages write the same 12 artifacts under the same name: the trained
    norm η (B, L−1, H, layers) within 1e-5 relative, the percentages within
    1e-5 and the report's trained lines equal."""
    model_cfg, _, params = small
    args = {"seed": 1919, "save": None, "dataset": load_yaml(YAML)["dataset"],
            "train": load_yaml(YAML)["train"], "model": model_cfg, "lang_model": True}
    model, _ = port_transformer(model_cfg, params)
    opt, clip = make_family_optimizer(model, "transformer", model_cfg, args["train"],
                                      {"lr": 0.05, "wd": 0.1, "betas": (0.9, 0.95)})
    x, y = (torch.from_numpy(t) for t in lm_batch(8, 6))
    for _ in range(2):
        train_step(model, opt, x, y, {"regular": 0.05}, None, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    batch, labels = lm_batch(8, 7)
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 9.5, ckpt, device="cpu",
                        batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(batch.astype(np.int32), labels, {})], ckpt, 9.5, params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and pdir.startswith("WikiText")
    pfiles = sorted(os.listdir(tmp_path / "port" / pdir))
    assert pfiles == sorted(os.listdir(tmp_path / "jax" / jdir)) and len(pfiles) == 12
    eig = port_out[0]
    assert eig.shape == port_out[1].shape == (8, L - 1, 4, 2) and eig.dtype == np.float32
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=1e-5, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))


# -- serving ----------------------------------------------------------------------

def test_decoder_matches_the_forward_and_tlie_tpu(small):
    """The step path (the conv's tail and S through the mixer) against the
    full forward at every position, 2e-5 of max|logit|; prefill's logits
    and state against tlie_tpu's Decoder on the same weights (2e-5 of each
    one's max) and 8 greedy tokens equal; without a position table the
    decoder runs past the training length."""
    model_cfg, _, params = small
    _, model = port_transformer(model_cfg, params)
    dec = Decoder(model_cfg, model, device="cpu")
    x, _ = lm_batch(3, 8)
    with torch.no_grad():
        full = model(torch.from_numpy(x))
    tol = 2e-5 * full.abs().max().item()
    torch.testing.assert_close(dec.stepwise_logits(x), full, rtol=0, atol=tol)
    jdec = JaxDecoder(model_cfg, params)
    prompt = x[:, :10]
    jcache, jlogits = jdec.prefill(prompt.astype(np.int32), 24)
    cache, logits = dec.prefill(prompt, 24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=tol)
    for c, jc in zip(cache, jcache):
        for a, b in zip(c, jc):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-5 * np.abs(b).max())
    want = np.asarray(jdec.generate(prompt.astype(np.int32), 8))
    np.testing.assert_array_equal(dec.generate(prompt, 8).numpy(), want)
    assert dec.generate(x, 12).shape == (3, L + 12)


# -- the stacked sweep ----------------------------------------------------------------

def test_two_stacked_points_equal_their_serial_runs(tmp_path):
    """Two points of the config's grid (seeds 1919 and 2222 at rates 0.0005
    and 0.001) stacked by ``run_sweep`` against each point's serial
    ``train`` at dropout 0 (the config's) after 6 steps: the train loss,
    test loss and perplexity of both evals within 1e-5 relative, every
    parameter within 1e-5 absolute (the stacked step batches the same
    float32 products, so its sums may run in another order), as
    tests/test_torch_sweep.py holds the MQAR points."""
    raw = tiny_lm_config(save=str(tmp_path / "ckpt" / "wt"))
    data = WikiText(**raw["dataset"])
    tr, te = data.split("train"), data.split("test")
    base = ExperimentConfig(raw)
    points = [{("seed",): 1919, ("train", "lr"): 0.0005}, {("seed",): 2222, ("train", "lr"): 0.001}]
    stacked, (wave,) = run_sweep(base, points, tr, te, data.l_max, device="cpu")
    for point, hist, (path, perf) in zip(points, wave["histories"], stacked):
        one = derive_runtime_fields(apply_sweep_point(base, point).raw, data.l_max, len(tr[0]))
        one["save"] = None
        ser = train(one, tr, te, device="cpu")
        assert [h["step"] for h in hist] == [h["step"] for h in ser.history] == [3, 6]
        for h, s in zip(hist, ser.history):
            for key in ("train_loss", "test_loss", "test_perf"):
                assert h[key] == pytest.approx(s[key], rel=1e-5, abs=1e-7), key
        got = restore_checkpoint(path)["model"]
        for name, want in ser.model.state_dict().items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


# -- the config and launch ----------------------------------------------------------------

def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    exp = jax_load_experiment(YAML)
    jdata = JaxWikiText(**exp.dataset)
    jdata.setup()
    exp.derive_runtime_fields(jdata)
    assert WIKITEXT_NORM_ATTENTION_SHORT == exp.raw
    model = build_models(dict(WIKITEXT_NORM_ATTENTION_SHORT["model"], num_layers=1),
                         generator=torch.Generator(), device="cpu")[0]
    one_layer = sum(p.numel() for p in model.layers[0].parameters())
    n = sum(p.numel() for p in model.parameters()) + 5 * one_layer
    assert 60e6 < n < 62e6  # the config's about 61M parameters


def test_launch_trains_checkpoints_analyses_and_sweeps_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on the cut config (6 steps, 2 evals): the checkpoint,
    the 12 artifacts with η (4, 63, 4, 2) from the checkpoint; then
    ``--sweep_parallel`` on the config's sweep file (2 seeds × 2 rates) over
    the cut base: one wave of the four points, four checkpoints, four
    journal lines and four analyses."""
    cfg = tiny_lm_config(save=str(tmp_path / "checkpoint" / "wt-norm"))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 4, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 6:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (4, 63, 4, 2) and np.all(eig > 0) and run.startswith("WikiText")

    sweep = load_yaml(SWEEP_YAML)
    cfg["save"] = str(tmp_path / "sweep" / "wt-norm")
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(cfg))
    sweep["base_config"] = str(tmp_path / "base.yaml")
    (tmp_path / "sweep.yaml").write_text(yaml.safe_dump(sweep))
    an_path.write_text(yaml.safe_dump({"batch_size": 4,
                                       "save_path": str(tmp_path / "sweep_analysis")}))
    assert launch.main(["--config", str(tmp_path / "sweep.yaml"), "--sweep_parallel",
                        "--analysis_config", str(an_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Found 4 sweep configurations" in out and "group 4 points" in out
    ckpts = sorted(p for p in os.listdir(tmp_path / "sweep") if p.endswith(".pth"))
    assert len(ckpts) == 4
    with open(tmp_path / "sweep" / "wt-norm.sweep_journal.jsonl") as f:
        journal = [json.loads(line) for line in f]
    assert len(journal) == 4 and len(os.listdir(tmp_path / "sweep_analysis")) == 4


# -- the card run's paths 16 and 17, rehearsed ------------------------------------------

def test_chip_smoke_paths_16_and_17_run_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.wikitext_norm_attention_path`` and ``wikitext_sweep_path``
    on the cut LM (d_model 16, block 64, a short synthetic stream; the sweep
    file's four points over the cut base), with the card's timers, profiler
    and memory counters stubbed: training, the checkpoint's η, serving
    against the forward's argmax, the card step against float64, the stacked
    wave, each stacked point against its serial step and the timings all run
    as on the card, and no port kernel launches."""
    from tlie_tpu_torch import config as config_mod
    from tlie_tpu_torch.ops import LAUNCHES

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cfg = tiny_lm_config(save="./checkpoint/wikitext-norm-attention-short", steps=4,
                         eval_every=2)
    data = WikiText(**cfg["dataset"])
    tr, te = data.split("train"), data.split("test")
    tiny = derive_runtime_fields(cfg, data.l_max, len(tr[0]))
    monkeypatch.setattr(config_mod, "WIKITEXT_NORM_ATTENTION_SHORT", tiny)
    for name, value in (("WTN_STEPS", 2), ("WTN_NEW", 4), ("WTS_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    sweep = load_yaml(SWEEP_YAML)
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(cfg))
    sweep["base_config"] = str(tmp_path / "base.yaml")
    (tmp_path / "sweep.yaml").write_text(yaml.safe_dump(sweep))
    monkeypatch.setattr(cs, "WTS_SWEEP", str(tmp_path / "sweep.yaml"))
    splits = (tr, te, data.l_max)
    cpu = torch.device("cpu")
    for launches in (cs.wikitext_norm_attention_path(cpu, splits, ARTIFACT_FILES),
                     cs.wikitext_sweep_path(cpu, splits, ARTIFACT_FILES)):
        assert set(launches) == set(LAUNCHES) and not any(launches.values())
