"""Training, sweeping, serving and eigen-analysis of ``model.compute_dtype:
bfloat16`` for the LRU, S5, S4 and transformer families against
``tlie_tpu``: one AdamW step of a post-norm BatchNorm LRU LM (its
statistics and float32 weights) against ``make_train_block``; its fused
head on bfloat16 operands against the dense bf16 head; stacked bf16 points
against their serial runs; the decoder serving bf16 models in float32 as
``tlie_tpu``'s does; eval_eig of a bf16 checkpoint as the float32
extraction.

Weights are ``tlie_tpu``'s where both packages run, carried with
``compat``; inputs are made with numpy from a seed.  Tolerances are stated
where they are used.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bf16 import _ATT_TINY, _LRU_TINY
from test_torch_sweep_families import _mqar_config, _points
from test_torch_wikitext_norm_attention import YAML as NORM_LM_YAML
from test_torch_wikitext_norm_attention import lm_batch, small_model_config
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state
from tlie_tpu.training.steps import cross_entropy_loss as jax_cross_entropy_loss
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.compat import params_to_jax
from tlie_tpu_torch.config import ExperimentConfig, apply_sweep_point, derive_runtime_fields
from tlie_tpu_torch.config import load_yaml
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.ops import fused_xent as fx
from tlie_tpu_torch.parallel import run_sweep
from tlie_tpu_torch.training import (
    cross_entropy_loss, restore_checkpoint, save_checkpoint, schedules, train, train_step,
)
from tlie_tpu_torch.training.loop import use_fused_head
from tlie_tpu_torch.training.state import make_optimizer
from tlie_tpu_torch.training.steps import fused_head_loss
from torch_parity import jax_weights, port_model, to_numpy

torch.set_num_threads(1)

# the post-norm BatchNorm LRU LM of tests/test_bf16.py's widths, in bf16
LM = {**_LRU_TINY, "norm": "batch", "pooling": "none", "compute_dtype": "bfloat16"}
V, L = LM["input_dim"], LM["seq_len"]


def _lm_batch(n, seed):
    """(tokens, next-token labels with a −100 tail)."""
    x = np.random.default_rng(seed).integers(0, V, (n, L)).astype(np.int64)
    y = np.full_like(x, -100)
    y[:, :-1] = x[:, 1:]
    return x, y


# -- one step of the bf16 LRU LM -------------------------------------------------------

def test_bf16_lru_lm_step_matches_make_train_block():
    """One AdamW step (the ssm and regular groups, the dense head, train
    mode) of the bf16 post-norm BatchNorm LRU LM from ``tlie_tpu``'s
    weights and moved statistics, against ``make_train_block`` on the same
    batch of 4 × 32: the loss within 1e-3 relative (both round activations
    to bfloat16, XLA's GELU and sigmoid approximating otherwise); each
    layer's BatchNorm running mean and variance, taken from the bf16
    residual sum widened to float32, within 1e-3 (0.01 of the batch's
    statistics enters them, which differ by bfloat16 noise); the float32
    weights within 1e-6 where both packages' |g| are at least 0.05 of their
    leaf's max (there the signs agree, and Adam's first step,
    lr·g/(|g| + eps), is the same up to float32 rounding), and within the
    movement bound 2·lr + 1e-6 everywhere, those elements covering at least
    30 % of the weights."""
    lr, wd, total = 1e-3, 0.05, 10
    jmodel, params, stats = jax_weights(LM, seed=0, stats_seed=1)
    jtrain, _, _ = jax_build_models(dict(LM), padded=False)
    state, _ = create_train_state(
        jtrain, jax.random.PRNGKey(0), in_dim=V, batch_size=2, seq_len=L, weight_decay=wd,
        norm="batch", ssm_lr=lr, ssm_vars=LM["ssm_lr_vars"], lr=lr, padded=False,
        betas=(0.9, 0.999), integer_inputs=True)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    block = jax_scan_loop.make_train_block(
        jtrain, "batch", tuple(sorted(state.opt_state.inner_states)), 0, total, True, 1e-7)
    x, y = _lm_batch(4, 3)
    jstate, jloss = block(state, jax.random.PRNGKey(1), jax_scan_loop.put_dataset(x, y),
                          np.arange(4)[None], 0, lr, lr)

    def jax_grads():
        def loss(p):
            logits, _ = jtrain.apply({"params": p, "batch_stats": stats}, x.astype(np.int32),
                                     mutable=["batch_stats"])
            return jax_cross_entropy_loss(logits, y)
        return to_numpy(jax.jit(jax.grad(loss))(params))

    model, _, _ = build_models(LM, generator=torch.Generator(), device="cpu")
    model.load_state_dict(port_model(LM, params, stats).state_dict())
    opt = make_optimizer(model, LM["ssm_lr_vars"], lr, lr, wd, (0.9, 0.999))
    rate = schedules.lr_for_step(0, lr, 0, total, True, 1e-7)
    loss = train_step(model, opt, torch.from_numpy(x), torch.from_numpy(y),
                      {"regular": rate, "ssm": rate})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    got_p, got_s = params_to_jax(model.state_dict())
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_s),
                            jax.tree_util.tree_leaves(to_numpy(jstate.batch_stats))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=str(path))
    moved = [np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(got_s),
                                                 jax.tree_util.tree_leaves(stats))]
    assert min(moved) > 1e-3  # the step did move every statistic

    g_port, _ = params_to_jax(_port_grads(params, stats, x, y))
    n_det = n_all = 0
    for (path, a), b, g1, g2 in zip(jax.tree_util.tree_leaves_with_path(got_p),
                                    jax.tree_util.tree_leaves(to_numpy(jstate.params)),
                                    jax.tree_util.tree_leaves(g_port),
                                    jax.tree_util.tree_leaves(jax_grads())):
        err = np.abs(a - b)
        det = (np.abs(g1) >= 0.05 * np.abs(g1).max()) & (np.abs(g2) >= 0.05 * np.abs(g2).max())
        assert err[det].max(initial=0.0) <= 1e-6, path
        assert err.max() <= 2 * rate + 1e-6, path
        n_det, n_all = n_det + det.sum(), n_all + det.size
    assert n_det >= 0.3 * n_all
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _port_grads(params, stats, x, y):
    """The port's gradients of the dense-head loss in train mode."""
    model = port_model(LM, params, stats).train()
    cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_bf16_lru_lm_fused_head_matches_the_dense_bf16_head(monkeypatch):
    """The bf16 LRU LM with ``train.fused_xent`` takes the fused head
    (``use_fused_head``), on bfloat16 operands (the features, the
    decoder's weight read in place as (D, V) and its bias), as
    ``fused_head_dtype`` does in ``tlie_tpu``: its loss within 1e-3
    relative of the dense bf16 head's (whose logits are rounded to bfloat16
    before the float32 reduction, where the fused head keeps them in
    float32), its float32 gradients within 0.04 of each leaf's max|g| (ten
    bfloat16 roundings), the BatchNorm statistics it updates equal to the
    dense head's."""
    cfg = {"model": LM, "train": {"fused_xent": True}, "dataset": {"name": "WikiText"}}
    assert use_fused_head(cfg, 4)
    x, y = (torch.from_numpy(t) for t in _lm_batch(4, 5))
    seen = []
    real = fx.FusedXentFn.apply

    def spy(h, w, b, labels):
        seen.append((h.dtype, w.dtype, b.dtype, w.stride()))
        return real(h, w, b, labels)

    monkeypatch.setattr(fx.FusedXentFn, "apply", spy)

    def run(fused):
        model, _, _ = build_models(LM, generator=torch.Generator().manual_seed(2), device="cpu")
        loss = (fused_head_loss(model, x, y) if fused
                else cross_entropy_loss(model(x), y))
        loss.backward()
        return (float(loss), {n: p.grad for n, p in model.named_parameters()},
                [b.clone() for b in model.buffers()])

    f_loss, f_g, f_stats = run(True)
    d_loss, d_g, d_stats = run(False)
    assert seen == [(torch.bfloat16,) * 3 + ((1, LM["hidden_dim"]),)]
    assert f_loss == pytest.approx(d_loss, rel=1e-3)
    for name, g in f_g.items():
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, d_g[name], rtol=0, atol=0.04 * d_g[name].abs().max().item())
    for a, b in zip(f_stats, d_stats):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- stacked bf16 points ---------------------------------------------------------------

@pytest.mark.parametrize("fid", ["lru", "s5", "s4", "sm_flash", "lin", "mamba1"])
def test_stacked_bf16_points_equal_their_serial_runs(tmp_path, fid):
    """Two bf16 points (seeds 1919 and 2222, each its own rates) of each
    family on tiny MQAR, stacked by ``run_sweep`` as ``tlie_tpu``'s stacked
    block builds them (through ``build_models``), against their serial
    ``train`` at dropout 0 after 4 steps: the train and test losses and the
    metric within 2e-2 relative (``tests/test_torch_bf16.py``'s bound for a
    stacked bf16 step: batched bfloat16 products round apart), every
    weight within the movement bound 2·Σ lr, and at least 99 % of all the
    model's elements within 1e-3 (a weight whose gradient is bfloat16 noise
    takes Adam's ±lr either way)."""
    raw, tr, te, l_max = _mqar_config(fid, tmp_path)
    raw["model"]["compute_dtype"] = "bfloat16"
    base = ExperimentConfig(copy.deepcopy(raw))
    points = _points()
    stacked, (wave,) = run_sweep(base, points, tr, te, l_max, None, device="cpu")
    for point, hist, (path, _) in zip(points, wave["histories"], stacked):
        cfg = derive_runtime_fields(apply_sweep_point(base, point).raw, l_max, len(tr[0]))
        cfg["save"] = None
        ser = train(cfg, tr, te, device="cpu")
        assert [h["step"] for h in hist] == [h["step"] for h in ser.history]
        for h, s in zip(hist, ser.history):
            for key in ("train_loss", "test_loss", "test_perf"):
                assert h[key] == pytest.approx(s[key], rel=2e-2, abs=1e-7), key
        got = restore_checkpoint(path)["model"]
        bound = 2 * hist[-1]["step"] * max(point[("train", "lr")], point[("train", "ssm_lr")])
        close = count = 0
        for name, want in ser.model.state_dict().items():
            err = (got[name].float() - want.float()).abs()
            assert got[name].dtype == want.dtype
            if want.is_floating_point() and not name.startswith("running"):
                assert err.max().item() <= bound + 2e-6, name
            close, count = close + int((err <= 1e-3).sum()), count + err.numel()
        assert close >= 0.99 * count


# -- serving and eigen-analysis --------------------------------------------------------

@pytest.mark.parametrize("family", ["lru", "transformer"])
def test_bf16_models_are_served_in_float32_as_tlie_tpu_serves_them(family):
    """A bf16 LRU LM (with its BatchNorm statistics) and a bf16 linear
    attention transformer: ``tlie_tpu``'s decoder multiplies the float32
    parameters as stored, so the port's decodes in float32 too: float32
    prefill and stepwise logits within 2e-5 of tlie_tpu's and the same
    greedy tokens, while the bf16 model's own forward differs from them by
    more than that."""
    cfg = LM if family == "lru" else {**_ATT_TINY, "compute_dtype": "bfloat16"}
    _, params, stats = jax_weights(cfg, seed=4)
    model = port_model(cfg, params, stats)
    dec = Decoder(cfg, model, device="cpu")
    jdec = JaxDecoder(cfg, params, batch_stats=stats)
    x = np.random.default_rng(9).integers(0, 64, (2, 24)).astype(np.int32)
    _, logits = dec.prefill(x)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jdec.prefill(x)[1]), rtol=0, atol=2e-5)
    sw = dec.stepwise_logits(x)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jdec.stepwise_logits(x)), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(dec.generate(x[:, :16], 6).numpy(),
                                  np.asarray(jdec.generate(x[:, :16], 6)))
    with torch.no_grad():
        own = model(torch.from_numpy(x).long())
    assert own.dtype == torch.bfloat16 and (own.float() - sw).abs().max().item() > 10 * 2e-5


def test_eval_eig_of_a_bf16_lru_checkpoint_is_the_float32_extraction(tmp_path):
    """The bf16 LRU LM's checkpoint (float32 weights, ``compute_dtype:
    bfloat16`` in its config) eigen-analysed: every array equals that of the
    same weights under the float32 config, bit for bit, and is float32 or
    complex64 (eval_eig builds float32 models, as ``tlie_tpu`` extracts in
    float32)."""
    _, model, _ = build_models(LM, generator=torch.Generator().manual_seed(3), device="cpu")
    path = save_checkpoint(str(tmp_path / "ck"), model, {"model": LM})
    args = {"seed": 1919, "model": LM, "dataset": {"_name_": "mqar", "name": "MQAR"},
            "train": {"lr": 1e-3}}
    got = eval_eig(args, {"save_path": str(tmp_path / "a")}, 1.0, path, device="cpu")
    f32 = dict(args, model={k: v for k, v in LM.items() if k != "compute_dtype"})
    want = eval_eig(f32, {"save_path": str(tmp_path / "b")}, 1.0, path, device="cpu")
    assert got[0].shape == (LM["state_dim"], LM["num_layers"]) and got[0].dtype == np.complex64
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_eval_eig_of_a_bf16_norm_attention_lm_matches_tlie_tpu(tmp_path):
    """A bf16 WikiText norm-attention LM (the config cut to 2 layers of d
    32, 4 heads): eval_eig of its checkpoint in both packages, each taking
    the float32 extraction of the stored weights: the trained η (B, L−1, H,
    layers) within 1e-5 relative and the binned percentages within 1e-5,
    and the port's η equal to its own float32 config's bit for bit."""
    model_cfg = small_model_config(compute_dtype="bfloat16")
    args = {"seed": 1919, "save": None, "dataset": load_yaml(NORM_LM_YAML)["dataset"],
            "train": load_yaml(NORM_LM_YAML)["train"], "model": model_cfg, "lang_model": True}
    _, model, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    batch, labels = lm_batch(4, 7)
    got = eval_eig(args, {"save_path": str(tmp_path / "port")}, 9.5, ckpt, device="cpu",
                   batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    want = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                        [(batch.astype(np.int32), labels, {})], ckpt, 9.5, params=trained)
    assert got[0].dtype == np.float32 and got[0].shape == (4, 15, 4, 2)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5, atol=0)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    for name in ("percentage", "percentage_mean", "percentage_std"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / pdir / f"{name}.npy"),
                                   np.load(tmp_path / "jax" / jdir / f"{name}.npy"),
                                   rtol=0, atol=1e-5, err_msg=name)
    f32 = dict(args, model={k: v for k, v in model_cfg.items() if k != "compute_dtype"})
    same = eval_eig(f32, {"save_path": str(tmp_path / "f32")}, 9.5, ckpt, device="cpu",
                    batch=batch)
    np.testing.assert_array_equal(got[0], same[0])
