"""The WikiText LRU language model in the port against tlie_tpu: the
synthetic and cached token arrays (byte-equal), perplexity, the resolved
config, the weights carried both ways, one training step through the fused
head (against tlie_tpu's fused step at ``norm: layer``, and against the
dense step of both packages at ``norm: batch``, statistics included), the
launch entry point end to end, and the two repaired faults of the port.

Parity runs at dropout 0 on a tiny WikiText LRU: 2 layers, d_model and state
16, block 64, batch 2 (so B·L = 128 rows, the fused head's smallest tile),
the GPT-2 vocabulary of 50,257.  Tolerances are stated where they are used.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from tlie_tpu.config import load_experiment
from tlie_tpu.data.base import perplexity as jax_perplexity
from tlie_tpu.data.wikitext import WikiText as JaxWikiText
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import WIKITEXT_LRU_SHORT, derive_runtime_fields, load_yaml
from tlie_tpu_torch.data import DATASETS, MQAR, WikiText, perplexity
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import train, train_step
from tlie_tpu_torch.training.loop import use_fused_head
from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
from tlie_tpu_torch.training.schedules import lr_for_step
from tlie_tpu_torch.training.state import make_optimizer
from tlie_tpu_torch.training.steps import cross_entropy_loss, fused_head_loss
from torch_parity import jax_apply, jax_weights, to_numpy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "configs/wikitext-lru-short.yaml"
BLOCK, BATCH = 64, 2


def tiny_config(norm="batch", fused=True, save=None):
    """configs/wikitext-lru-short.yaml cut to 2 layers of width 16, block 64,
    batch 2 and a short synthetic stream, with the runtime fields derived."""
    cfg = load_yaml(YAML)
    cfg["save"] = save
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=16, norm=norm, dropout=0.0)
    cfg["dataset"].update(block_size=BLOCK, synthetic_train_tokens=BLOCK * 24 + 5,
                          synthetic_test_tokens=BLOCK * 6)
    cfg["train"].update(batch_size=BATCH, total_steps=4, eval_every=2, fused_xent=fused)
    data = WikiText(**cfg["dataset"])
    train_split = data.split("train")
    return derive_runtime_fields(cfg, data.l_max, len(train_split[0])), data


# -- data, metric and config ----------------------------------------------------


@pytest.mark.parametrize("block, n_train, n_test", [(64, 64 * 24 + 5, 64 * 6), (1024, 5000, 3000)])
def test_synthetic_arrays_are_byte_equal(block, n_train, n_test):
    kw = dict(version=103, block_size=block, synthetic=True, synthetic_train_tokens=n_train,
              synthetic_test_tokens=n_test, seed=7)
    jdata = JaxWikiText(**kw)
    jdata.setup()
    data = WikiText(**kw)
    for split in ("train", "test"):
        x, y = data.split(split)
        jx, jy = getattr(jdata, f"{split}_inputs"), getattr(jdata, f"{split}_labels")
        assert x.dtype == jx.dtype == np.int64 and y.dtype == jy.dtype
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert (y[:, -1] == -100).all() and np.array_equal(y[:, :-1], x[:, 1:])
    assert data.l_max == jdata.l_max == block and data.d_output == jdata.d_output == 50257


def test_token_cache_is_read_as_tlie_tpu_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "tokens_train.npy", rng.integers(0, 50257, 1000).astype(np.int32))
    np.save(tmp_path / "tokens_test.npy", rng.integers(0, 50257, 300).astype(np.int32))
    kw = dict(version=103, block_size=64, data_dir=str(tmp_path), synthetic=False)
    jdata = JaxWikiText(**kw)
    jdata.setup()
    data = WikiText(**kw)
    for split in ("train", "test"):
        x, y = data.split(split)
        assert np.array_equal(x, getattr(jdata, f"{split}_inputs"))
        assert np.array_equal(y, getattr(jdata, f"{split}_labels"))
    # without a cache the port does not tokenize: it raises
    with pytest.raises(FileNotFoundError, match="does not tokenize"):
        WikiText(version=103, data_dir=str(tmp_path / "none"), synthetic=False).split("train")


def test_perplexity_matches_jax():
    """1e-6 relative: float32 log-softmax and one exp."""
    rng = np.random.default_rng(1)
    logits = (2 * rng.standard_normal((3, 17, 301))).astype(np.float32)
    y = rng.integers(0, 301, (3, 17))
    y[:, -1] = -100
    got = float(perplexity(torch.from_numpy(logits), torch.from_numpy(y)))
    assert got == pytest.approx(float(jax_perplexity(jnp.asarray(logits), jnp.asarray(y))),
                                rel=1e-6)
    assert DATASETS["wikitext"].get_metrics() is perplexity


def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    exp = load_experiment(str(YAML))
    jdata = JaxWikiText(**exp.dataset)
    jdata.setup()
    exp.derive_runtime_fields(jdata)
    assert WIKITEXT_LRU_SHORT == exp.raw
    data = WikiText(**load_yaml(YAML)["dataset"])
    got = derive_runtime_fields(load_yaml(YAML), data.l_max, len(data.split("train")[0]))
    assert got == exp.raw


def test_the_head_gate_follows_tlie_tpu():
    """Fused where asked on a per-position head with B·L % 128 == 0 and
    D <= 1024; the sparse head is off then, and WikiText never takes it (1023
    of 1024 labels per block are valid)."""
    cfg, data = tiny_config()
    assert use_fused_head(cfg, BATCH)
    assert not use_fused_head(cfg, 3)  # 3 * 64 rows are not tileable by 128
    assert not use_fused_head(dict(cfg, train=dict(cfg["train"], fused_xent=False)), BATCH)
    assert not use_fused_head(dict(cfg, model=dict(cfg["model"], hidden_dim=2048)), BATCH)
    assert not use_fused_head(dict(cfg, lang_model=False), BATCH)
    assert sparse_head_k_for(cfg["model"], data.split("train")[1]) is None


# -- weights carried both ways ----------------------------------------------------


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_weights_carry_both_ways_and_forward_matches(norm):
    """The 50,257-row encoder and decoder and the LayerNorm scale and bias
    (or BatchNorm statistics) map into the port and back unchanged, and the
    eval forward agrees with tlie_tpu's (2e-5 absolute, f32)."""
    cfg, _ = tiny_config(norm)
    jmodel, params, stats = jax_weights(cfg["model"], seed=3)
    sd = params_from_jax(params, stats)
    assert sd["encoder.encoder.weight"].shape == (50257, 16)
    assert sd["decoder.weight"].shape == (50257, 16)
    if norm == "layer":
        assert {"encoder.layers.1.normalize.weight", "encoder.layers.1.normalize.bias"} <= set(sd)
    _, model, _ = build_models(cfg["model"], generator=torch.Generator(), device="cpu")
    model.load_state_dict(sd)  # strict: every leaf has its place
    back_params, back_stats = params_to_jax(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back_params), jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)
    assert (back_stats is None) == (stats is None)
    x = np.random.default_rng(4).integers(0, 50257, (2, BLOCK)).astype(np.int32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_apply(jmodel, params, stats, x), rtol=0, atol=2e-5)


# -- one training step through the fused head -----------------------------------


def _port_step(cfg, params, stats, x, y, fused):
    """One port step from the JAX weights: (loss, grads by state_dict key,
    params and batch_stats after the step as flax trees)."""
    tc = cfg["train"]
    model, _, _ = build_models(cfg["model"], generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    opt = make_optimizer(model, cfg["model"]["ssm_lr_vars"], tc["lr"], tc["ssm_lr"], tc["wd"],
                         tuple(tc["betas"]))
    lrs = {g: lr_for_step(0, base, tc["warmup_steps"], tc["total_steps"], tc["cosine_anneal"],
                          tc["lr_min"]) for g, base in (("regular", tc["lr"]), ("ssm", tc["ssm_lr"]))}
    loss = train_step(model, opt, torch.from_numpy(x).long(), torch.from_numpy(y).long(), lrs,
                      fused_head=fused)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    new_params, new_stats = params_to_jax(model.state_dict())
    return float(loss), grads, new_params, new_stats, lrs["regular"]


def _jax_step(cfg, params, stats, x, y, fused):
    """tlie_tpu's one-step block (make_train_block) from the same weights;
    the fused head's Pallas kernels run in interpret mode."""
    tc, mc = cfg["train"], cfg["model"]
    jmodel, _, _ = jax_build_models(mc, padded=False)
    state, _ = create_train_state(
        jmodel, jax.random.PRNGKey(0), in_dim=mc["input_dim"], batch_size=BATCH,
        seq_len=mc["seq_len"], weight_decay=tc["wd"], norm=mc["norm"], ssm_lr=tc["ssm_lr"],
        ssm_vars=mc["ssm_lr_vars"], lr=tc["lr"], padded=False, betas=tuple(tc["betas"]),
        integer_inputs=True)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    if stats:
        state = state.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    block = jax_scan_loop.make_train_block(
        jmodel, mc["norm"], tuple(sorted(state.opt_state.inner_states)), tc["warmup_steps"],
        tc["total_steps"], tc["cosine_anneal"], tc["lr_min"], fused_head=fused)
    data = jax_scan_loop.put_dataset(x, y)
    with pltpu.force_tpu_interpret_mode():
        jstate, jloss = block(state, jax.random.PRNGKey(1), data, np.arange(BATCH)[None],
                              0, tc["lr"], tc["ssm_lr"])
    return float(jloss), to_numpy(jstate.params), to_numpy(jstate.batch_stats)


def _assert_params_close(got, want, grads, lr):
    """Adam's first step moves each element by lr·g/(|g| + 1e-8), about
    lr·sign(g).  Where that sign is above the gradients' rounding, or g is
    exactly 0 (encoder rows of tokens not in the batch, only decayed), the
    weights agree to f32 rounding (1e-6); elsewhere the sign may follow
    noise and the bound is the movement, 2·lr + 1e-6.  The rounding floor is
    1e-4 of the leaf's max|g| (as the packages' gradients agree), except in
    the decoder, where each vocabulary entry's gradient is its own sum over
    the batch: 1e-4 of its own row's max there (each bias entry stands
    alone).  The determined elements must cover 90 % of the weights."""
    g_tree, _ = params_to_jax(grads)
    n_det = n_all = 0
    for (path, a), b, g in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(g_tree)):
        err, ag = np.abs(a - b), np.abs(g)
        names = [getattr(k, "key", "") for k in path]
        if "decoder" in names:
            floor = 1e-4 * (ag.max(axis=0, keepdims=True) if ag.ndim == 2 else ag)
        else:
            floor = 1e-4 * ag.max()
        det = (ag >= floor) | (g == 0)
        assert err[det].max(initial=0.0) <= 1e-6, path
        assert err.max() <= 2 * lr + 1e-6, path
        n_det, n_all = n_det + det.sum(), n_all + det.size
    assert n_det > 0.9 * n_all


@pytest.fixture(scope="module")
def step_batch():
    _, data = tiny_config()
    x, y = data.split("train")
    return x[:BATCH], y[:BATCH]


def test_fused_step_matches_tlie_tpu_fused_step_at_layer_norm(step_batch):
    cfg, _ = tiny_config("layer")
    _, params, stats = jax_weights(cfg["model"], seed=5)
    x, y = step_batch
    loss, grads, new_params, _, lr = _port_step(cfg, params, stats, x, y, fused=True)
    jloss, jparams, _ = _jax_step(cfg, params, stats, x, y, fused=True)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _assert_params_close(new_params, jparams, grads, lr)


def test_fused_step_matches_the_dense_step_with_batch_norm(step_batch):
    """Loss (1e-6 relative), every gradient and the BatchNorm statistics,
    which the fused head updates as the dense head does (equal: the same
    features run in both).  The gradients are held to the dense step in
    float64: the fused step's error may be at most 4 times the dense f32
    step's own, or 1e-5 of the leaf's max.  (Some leaves, such as a GLU bias
    feeding a BatchNorm, are row sums that cancel, so both f32 steps miss
    the float64 value there by about 2e-4 of the leaf's max.)"""
    cfg, _ = tiny_config("batch")
    _, params, stats = jax_weights(cfg["model"], seed=6)
    x, y = step_batch
    f_loss, f_grads, _, f_stats, _ = _port_step(cfg, params, stats, x, y, fused=True)
    d_loss, d_grads, _, d_stats, _ = _port_step(cfg, params, stats, x, y, fused=False)
    assert f_loss == pytest.approx(d_loss, rel=1e-6)
    model, _, _ = build_models(cfg["model"], generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    model = model.double()
    cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    assert set(f_grads) == set(d_grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g64 = p.grad
        e_fused = float((f_grads[name].double() - g64).abs().max())
        e_dense = float((d_grads[name].double() - g64).abs().max())
        assert e_fused <= max(4 * e_dense, 1e-5 * float(g64.abs().max())), name
    moved = 0
    for a, b, s0 in zip(jax.tree_util.tree_leaves(f_stats), jax.tree_util.tree_leaves(d_stats),
                        jax.tree_util.tree_leaves(stats)):
        assert np.array_equal(a, b)
        moved += int(not np.array_equal(a, s0))
    assert moved == len(jax.tree_util.tree_leaves(stats))


def test_fused_step_matches_tlie_tpu_dense_step_with_batch_norm(step_batch):
    """tlie_tpu's fused head cannot run a BatchNorm model; its dense step is
    the reference: loss 1e-5 relative, weights as above, statistics 1e-5."""
    cfg, _ = tiny_config("batch")
    _, params, stats = jax_weights(cfg["model"], seed=7)
    x, y = step_batch
    loss, grads, new_params, new_stats, lr = _port_step(cfg, params, stats, x, y, fused=True)
    jloss, jparams, jstats = _jax_step(cfg, params, stats, x, y, fused=False)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _assert_params_close(new_params, jparams, grads, lr)
    for a, b in zip(jax.tree_util.tree_leaves(new_stats), jax.tree_util.tree_leaves(jstats)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_fused_head_loss_is_the_dense_cross_entropy():
    cfg, data = tiny_config("batch")
    model, eval_model, _ = build_models(cfg["model"], generator=torch.Generator().manual_seed(0),
                                        device="cpu")
    x, y = (torch.from_numpy(a[:BATCH]) for a in data.split("test"))
    with torch.no_grad():
        fused = fused_head_loss(eval_model, x, y)
        dense = cross_entropy_loss(eval_model(x), y)
    assert float(fused) == pytest.approx(float(dense), rel=1e-6)


# -- the entry points -------------------------------------------------------------


def test_train_evaluates_perplexity_through_the_fused_head(capsys):
    cfg, data = tiny_config("batch")
    result = train(cfg, data.split("train"), data.split("test"), device="cpu")
    out = capsys.readouterr().out
    assert "[train] fused decoder+softmax-CE head enabled" in out
    assert "sparse decoder head" not in out
    assert [r["step"] for r in result.history] == [2, 4]
    for r in result.history:
        # perplexity is exp of the mean CE of each batch: above 1, and at
        # least exp of the mean of the losses (Jensen)
        assert np.isfinite(r["test_perf"]) and r["test_perf"] >= np.exp(r["test_loss"]) * (1 - 1e-6)


def test_launch_trains_and_analyses_wikitext_on_the_cpu(tmp_path, monkeypatch, capsys):
    cfg = load_yaml(YAML)
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=16)
    cfg["dataset"].update(block_size=BLOCK, synthetic_train_tokens=BLOCK * 12,
                          synthetic_test_tokens=BLOCK * 4)
    cfg["train"].update(batch_size=BATCH, total_steps=4, eval_every=2, fused_xent=True)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(tmp_path / "tiny.yaml"), "--analysis_config",
                        str(ROOT / "configs/analysis/wikitext.yaml"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fused decoder+softmax-CE head enabled" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("wikitext-lru-short-seed-1919-layers-2") and ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis_results")
    assert run.startswith("WikiTextdmodel16")
    assert np.load(tmp_path / "analysis_results" / run / "eig.npy").shape == (16, 2)


def test_trained_wikitext_model_serves_at_the_full_vocabulary():
    cfg, data = tiny_config("batch")
    result = train(cfg, data.split("train"), data.split("test"), device="cpu")
    dec = Decoder(cfg["model"], result.eval_model, device="cpu")
    prompt = data.split("test")[0][:3, :20]
    out = dec.generate(prompt, 5)
    assert out.shape == (3, 25) and int(out.max()) < 50257
    _, last = dec.prefill(prompt)
    with torch.no_grad():
        full = result.eval_model(torch.from_numpy(prompt))[:, -1]
    torch.testing.assert_close(last, full, rtol=0, atol=2e-5)


# -- the repaired faults ------------------------------------------------------------

_SMALL_SPLIT = """
import numpy as np, torch
torch.set_num_threads(1)
from tlie_tpu_torch.config import derive_runtime_fields, load_yaml
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.training import train
cfg = load_yaml("configs/mqar-lru-small.yaml")
cfg["train"]["batch_size"] = 64
data = MQAR(**dict(cfg["dataset"], num_train_examples=256, num_test_examples=64))
tr, te = data.split("train"), data.split("test")
cfg = derive_runtime_fields(cfg, data.l_max, 10)
for splits in (((tr[0][:10], tr[1][:10]), te), (tr, (te[0][:10], te[1][:10]))):
    try:
        train(cfg, *splits, device="cpu")
    except ValueError as err:
        assert "fewer than one batch of 64" in str(err), err
    else:
        raise SystemExit("no error for a split of 10 examples")
print("ok")
"""


def test_train_refuses_a_split_smaller_than_a_batch():
    """A 10-example split with batch 64 raises instead of looping forever
    (train split) or gathering past the end (test split).  In a subprocess
    with a time limit, so that the fault would fail the test, not hang it."""
    proc = subprocess.run([sys.executable, "-c", _SMALL_SPLIT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_decoder_leaves_the_callers_module_as_it_was():
    cfg, data = tiny_config("batch")
    model, _, _ = build_models(cfg["model"], generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert model.training
    dec = Decoder(cfg["model"], model, device="cpu")
    assert model.training and all(m.training for m in model.modules())
    assert not dec.model.training
    x = torch.from_numpy(data.split("test")[0][:2, :16])
    stats = [b.clone() for b in model.buffers()]
    dec.prefill(x)
    assert all(torch.equal(a, b) for a, b in zip(stats, model.buffers()))


def test_mqar_keeps_its_masked_accuracy():
    assert DATASETS["mqar"] is MQAR and MQAR.get_metrics().__name__ == "masked_accuracy"
