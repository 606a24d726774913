"""The stacked sweep (``tlie_tpu_torch.parallel.run_sweep``, ``launch
--sweep_parallel``) for every family, on the CPU at tiny widths (the plain
versions of the kernels under their ``vmap`` rules): the LRU (BatchNorm),
S5, S4, Mamba-2, ``SSD_LTI``, Mamba-1, bfloat16 Mamba-2, the softmax
transformer through the flash route and materialised, linear and norm
attention, a padded ListOps S5 and transformer classifier, and the dual
(AAN) transformer.

* Each stacked point against its own serial ``train`` at dropout 0: the
  train loss, test loss and metric of each eval within 1e-5 relative (or
  1e-7 absolute), every parameter and BatchNorm statistic within 1e-5
  absolute (the stacked step batches the same float32 products, so its sums
  may run in another order) and within the movement bound 2·steps·lr
  everywhere, each point checkpointed, journaled and eigen-analysed.  The
  softmax attention's key bias is held to the movement bound alone: its
  gradient is 0 in exact arithmetic, so its float32 value is rounding noise,
  which Adam turns into steps of ±lr (:func:`_gradient_free`).  The bfloat16
  Mamba-2 takes 2e-2 relative on its losses, and at least 99 % of each
  leaf's elements within 1e-3 (all within the movement bound): its products
  round to bfloat16, and a batched product may sum in another order before
  its rounding.
* One stacked step per family against ``tlie_tpu``'s ``make_train_block``
  vmapped over the grid, on ``tlie_tpu``'s ``_stacked_state`` weights
  carried per point by ``params_from_jax``, at dropout 0, with the
  tolerance of ``tests/test_torch_sweep.py``'s
  ``test_stacked_step_matches_tlie_tpu_vmapped_block`` (the mean loss 1e-5
  relative; parameters 2e-6 absolute where both steps' |g| are at least
  1e-2 of their leaf's max or the gradient is 0, within the movement bound
  2·Σ lr + 2e-6 everywhere).  S4's log_step is held to the movement bound
  alone: ``tlie_tpu``'s gradient of it loses the Nyquist term
  (``tests/test_torch_s4.py``).
* A padded split: ``tlie_tpu``'s stacked block puts inputs and labels alone
  on the device, and its padded model then raises (a fault of the
  reference, ROADMAP Queue 3); the port carries the lengths, and its
  stacked step is held to ``tlie_tpu``'s serial block, which carries them.
* ``train.fused_xent`` trains stacked through the dense head.
* The refusal that the fused head once met stays gone for the bf16 config.
"""

import copy
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.config import ExperimentConfig as JaxExperimentConfig
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.parallel import sweep as jax_sweep
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.loop import _family_norm
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import (
    AAN_TRANSFORMER_FULL, ExperimentConfig, LISTOPS_S5_FULL, apply_sweep_point,
    derive_runtime_fields, load_yaml, train_fields,
)
from tlie_tpu_torch.data import AAN, MQAR, ListOps
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import run_sweep
from tlie_tpu_torch.parallel import sweep as sweep_mod
from tlie_tpu_torch.training import restore_checkpoint, train
from tlie_tpu_torch.training.scan_loop import batch_indices, sparse_head_k_for
from tlie_tpu_torch.training.schedules import lr_for_step
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (1919, 2222)
MQAR_TINY = dict(input_seq_length=32, num_kv_pairs=4, vocab_size=64, num_train_examples=128,
                 num_test_examples=32)
# the families, each as (base YAML or full dict, model overrides)
FAMILIES = {
    "lru": ("mqar-lru-small.yaml", dict(hidden_dim=16, state_dim=16)),
    "s5": ("mqar-s5-small.yaml", dict(hidden_dim=16, state_dim=16, num_blocks=2)),
    "s4": ("mqar-s4-small.yaml", dict(hidden_dim=16, state_dim=16)),
    "mamba2": ("mqar-mamba2-small.yaml", dict(hidden_dim=32, state_dim=16)),
    "ssd_lti": ("mqar-mamba2-small.yaml", dict(hidden_dim=32, state_dim=16, pseudoLTI=True)),
    "mamba1": ("mqar-mamba1-small.yaml", dict(hidden_dim=16, state_dim=4)),
    "mamba2_bf16": ("mqar-mamba2-small.yaml", dict(hidden_dim=32, state_dim=16,
                                                   compute_dtype="bfloat16")),
    "sm_flash": ("mqar-sm-attention-small.yaml", dict(hidden_dim=32, state_dim=32, num_heads=2)),
    "sm_materialised": ("mqar-sm-attention-small.yaml", dict(hidden_dim=32, state_dim=32,
                                                             num_heads=2, use_flash=False)),
    "lin": ("mqar-lin-attention-small.yaml", dict(hidden_dim=32, state_dim=32, num_heads=2)),
    "norm": ("mqar-norm-attention-small.yaml", dict(hidden_dim=32, state_dim=32, num_heads=2)),
}
# the rates of the two points, (lr, ssm_lr)
RATES = ((0.003, 0.001), (0.001, 0.002))
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-7, 1e-5
BF16_RTOL, BF16_PARAM_ATOL, BF16_SHARE = 2e-2, 1e-3, 0.99


def _mqar_config(fid, tmp_path=None, steps=4, eval_every=2):
    yaml_name, model = FAMILIES[fid]
    raw = load_yaml(ROOT / "configs" / yaml_name)
    raw["dataset"].update(MQAR_TINY)
    raw["model"].update(model, dropout=0.0, vocab_size=64, seq_len=32)
    if "input_dim" in raw["model"] and raw["model"]["layer"] in ("lru", "s4", "s5"):
        raw["model"]["input_dim"] = 64
    raw["model"]["output_dim"] = 64
    if "max_pos_embed" in raw["model"] and raw["model"]["max_pos_embed"]:
        raw["model"]["max_pos_embed"] = 32
    raw["train"].update(total_steps=steps, eval_every=eval_every, batch_size=8)
    raw["train"].pop("warmup", None)
    raw["train"]["warmup_steps"] = 1
    raw["save"] = str(tmp_path / "checkpoint" / fid) if tmp_path is not None else None
    data = MQAR(**raw["dataset"])
    return raw, data.split("train"), data.split("test"), data.l_max


def _listops_config(tmp_path, layer="s5", epochs=2):
    """A padded ListOps config on ``tests/fixtures/listops`` (8 training and
    4 test rows at l_max 32), batch 2, epoch-driven with 1 epoch of warmup."""
    if layer == "s5":
        raw = copy.deepcopy(LISTOPS_S5_FULL)
        raw["model"].update(num_layers=2, hidden_dim=8, state_dim=16, num_blocks=2)
    else:
        raw = load_yaml(ROOT / "configs" / "tasks" / "listops" / "listops-sm-attention.yaml")
        raw["model"].update(num_layers=1, hidden_dim=16, state_dim=16, num_heads=2,
                            max_pos_embed=32, mixer_dim=16, att_dropout=0.0)
    raw["dataset"].update(data_dir=str(ROOT / "tests" / "fixtures" / "listops"), l_max=32)
    raw["model"]["dropout"] = 0.0
    raw["train"].update(num_epochs=epochs, batch_size=2, warmup=1)
    raw["train"].pop("checkpoint_every", None)
    raw["save"] = str(tmp_path / "checkpoint" / f"listops-{layer}")
    data = ListOps(**raw["dataset"])
    return raw, data.split("train"), data.split("test"), data.l_max


def _aan_config(tmp_path):
    """The dual AAN transformer on 24 / 8 synthetic pairs of 64 characters."""
    raw = copy.deepcopy(AAN_TRANSFORMER_FULL)
    raw["dataset"].update(l_max=64, synthetic_train=24, synthetic_test=8)
    raw["model"].update(num_layers=1, hidden_dim=16, state_dim=16, num_heads=2, mixer_dim=16,
                        max_pos_embed=64, dropout=0.0)
    raw["train"].update(num_epochs=2, batch_size=4, warmup=0)
    raw["train"].pop("checkpoint_every", None)
    raw["save"] = str(tmp_path / "checkpoint" / "aan")
    data = AAN(**raw["dataset"])
    return raw, data.split("train"), data.split("test"), data.l_max


def _points():
    return [{("seed",): s, ("train", "lr"): lr, ("train", "ssm_lr"): slr}
            for s, (lr, slr) in zip(SEEDS, RATES)]


def _analysis(tmp_path, batch_size):
    return {**load_yaml(ROOT / "configs" / "analysis" / "mqar.yaml"),
            "save_path": str(tmp_path / "analysis"), "batch_size": batch_size}


def _stacked_vs_serial(tmp_path, raw, tr, te, l_max, rtol=RTOL, param_atol=PARAM_ATOL):
    """``run_sweep`` over the two points (checkpoints, journal, eval_eig),
    each held to its serial ``train``."""
    base = ExperimentConfig(copy.deepcopy(raw))
    points = _points()
    conf = _analysis(tmp_path, 4)
    stacked, waves = run_sweep(base, points, tr, te, l_max, conf, device="cpu")
    (wave,) = waves
    with open(str(tmp_path / "checkpoint" / Path(raw["save"]).name) + ".sweep_journal.jsonl") as f:
        journal = [json.loads(line) for line in f]
    assert [r["path"] for r in journal] == [p for p, _ in stacked]
    runs = sorted(os.listdir(tmp_path / "analysis"))
    assert len(runs) == 2
    for run in runs:
        assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    for point, hist, (path, perf) in zip(points, wave["histories"], stacked):
        cfg = derive_runtime_fields(apply_sweep_point(base, point).raw, l_max, len(tr[0]))
        cfg["save"] = None
        ser = train(cfg, tr, te, device="cpu")
        assert [h["step"] for h in hist] == [h["step"] for h in ser.history]
        for h, s in zip(hist, ser.history):
            for key in ("train_loss", "test_loss", "test_perf"):
                assert h[key] == pytest.approx(s[key], rel=rtol, abs=ATOL), key
        got = restore_checkpoint(path)["model"]
        bound = 2 * hist[-1]["step"] * max(point[("train", "lr")],
                                           point[("train", "ssm_lr")]) + 2e-6
        for name, want in ser.model.state_dict().items():
            a, w = got[name].float().numpy(), want.float().numpy()
            err = np.abs(a - w)
            if name.endswith("running_mean") or name.endswith("running_var"):
                assert err.max() <= param_atol, name
                continue
            assert err.max() <= bound, name
            if param_atol >= BF16_PARAM_ATOL:
                assert (err <= param_atol).mean() >= BF16_SHARE, name
            else:
                free = _gradient_free(name, raw["model"], w.shape)
                assert err[~free].max(initial=0.0) <= param_atol, name
    return stacked, wave


def _gradient_free(name, model_cfg, shape):
    """The elements whose gradient is 0 in exact arithmetic, so that their
    float32 gradient is rounding noise, which Adam, dividing each element by
    its own magnitude, turns into steps of ±lr in either run: the softmax
    attention's key bias (adding it shifts a query's scores by one constant,
    which the softmax removes)."""
    free = np.zeros(shape, bool)
    if model_cfg.get("attention_fn") == "sm-attention" and name.endswith("attention.Wqkv.bias"):
        d_qk = (shape[0] - model_cfg["hidden_dim"]) // 2
        free[d_qk:2 * d_qk] = True
    return free


@pytest.mark.parametrize("fid", list(FAMILIES))
def test_each_stacked_point_is_its_serial_run(tmp_path, fid):
    """Every MQAR family: two stacked points (seeds 1919 and 2222, each its
    own rates) checkpointed, journaled and eigen-analysed, each against its
    serial run after 4 steps with an eval every 2."""
    raw, tr, te, l_max = _mqar_config(fid, tmp_path)
    bf16 = raw["model"].get("compute_dtype") == "bfloat16"
    _stacked_vs_serial(tmp_path, raw, tr, te, l_max, *((BF16_RTOL, BF16_PARAM_ATOL) if bf16
                                                       else ()))


@pytest.mark.parametrize("layer", ["s5", "sm-attention"])
def test_padded_listops_points_are_their_serial_runs(tmp_path, layer):
    """The padded ListOps S5 (the masked mean pool over each row's length)
    and the softmax classifier transformer, epoch-driven (2 epochs of 4
    steps, 1 of warmup, so the warmup counts epochs as in the serial run):
    each stacked point against its serial run, which carries the lengths."""
    raw, tr, te, l_max = _listops_config(tmp_path, layer)
    assert len(tr) == 3
    stacked, wave = _stacked_vs_serial(tmp_path, raw, tr, te, l_max)
    assert wave["steps"] == 2 * (len(tr[0]) // 2)


def test_dual_aan_points_are_their_serial_runs(tmp_path):
    """The dual (MATCH) transformer on AAN pairs, stacked against serial."""
    raw, tr, te, l_max = _aan_config(tmp_path)
    _stacked_vs_serial(tmp_path, raw, tr, te, l_max)


def test_batchnorm_statistics_are_stacked_per_point(tmp_path):
    """The LRU's BatchNorm running statistics under ``vmap(grad_and_value)``
    with ``functional_call``: after stacked steps each point's statistics are
    those its own serial steps reach (checked above by the state dicts), and
    two points on different weights end with different statistics."""
    raw, tr, te, l_max = _mqar_config("lru", tmp_path, steps=2, eval_every=2)
    stacked, _ = _stacked_vs_serial(tmp_path, raw, tr, te, l_max)
    a, b = (restore_checkpoint(p)["model"] for p, _ in stacked)
    stats = [k for k in a if k.endswith("running_mean")]
    assert stats and all(not torch.equal(a[k], b[k]) for k in stats)


# -- one stacked step against tlie_tpu's vmapped block -------------------------------------

BLOCK_FAMILIES = ["lru", "s5", "s4", "mamba2", "ssd_lti", "mamba1", "sm_flash",
                  "sm_materialised"]


def _raise_log_step(tree):
    """Every log_step of an S4 tree raised to log 0.002 where it lies below,
    where tlie_tpu keeps the Nyquist frequency (``tests/test_torch_s4.py``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.maximum(x, np.log(0.002)).astype(x.dtype)
        if getattr(path[-1], "key", None) == "log_step" else x, tree)


def _port_grid(model_cfg, family, raw, params_g, stats_g, padded=False):
    """The port's stacked state on tlie_tpu's per-point weights."""
    models = []
    for p, st in zip(params_g, stats_g):
        m, _, _ = build_models(model_cfg, padded, generator=torch.Generator(), device="cpu")
        m.load_state_dict(params_from_jax(p, st))
        models.append(m)
    params, buffers = torch.func.stack_module_state(models)
    params = {n: p.detach() for n, p in params.items()}
    f = train_fields(raw)
    group_of, clip = sweep_mod.optimizer_groups(models[0], family, model_cfg, raw["train"], f)
    return models, params, buffers, group_of, clip, f


def _hold_params(params, buffers, gs, want_params, want_stats, lr_sum, skip=(), model_cfg=None):
    """Each point's parameters against tlie_tpu's after the steps (see the
    module docstring; the gradient-free elements of :func:`_gradient_free`
    within the movement bound alone), and its BatchNorm statistics within
    1e-5 of max(1, |x|)."""
    G = next(iter(params.values())).shape[0]
    for g in range(G):
        got, stats = params_to_jax({**{n: p[g] for n, p in params.items()},
                                    **{n: b[g] for n, b in buffers.items()}})
        g1, _ = params_to_jax({n: t[g] for n, t in gs[0].items()})
        g2, _ = params_to_jax({n: t[g] for n, t in gs[-1].items()})
        pick = lambda t: jax.tree_util.tree_map(lambda a: a[g], t)  # noqa: E731
        n_det = n_all = 0
        for (path, a), w, d1, d2 in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves(pick(want_params)),
                jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
            err = np.abs(np.asarray(a) - np.asarray(w))
            assert err.max() <= 2 * lr_sum[g] + 2e-6, path
            if getattr(path[-1], "key", None) in skip:
                continue
            det = (np.abs(d1) >= 1e-2 * np.abs(d1).max()) & (np.abs(d2) >= 1e-2 * np.abs(d2).max())
            name = ".".join(str(getattr(k, "key", k)) for k in path)
            free = _gradient_free(name, model_cfg or {}, err.shape)
            det, zero = det & ~free, (d1 == 0) & ~free
            assert err[det | zero].max(initial=0.0) <= 2e-6, path
            n_det, n_all = n_det + det.sum(), n_all + (d1 != 0).sum()
        assert n_det > 0.4 * n_all
        if want_stats is not None:
            for a, w in zip(jax.tree_util.tree_leaves(stats),
                            jax.tree_util.tree_leaves(pick(want_stats))):
                np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fid", BLOCK_FAMILIES)
def test_stacked_step_matches_tlie_tpu_vmapped_block(fid):
    """Two steps of two stacked points (seeds 1919 and 2222, rates as
    RATES) against ``tlie_tpu``'s ``make_train_block`` vmapped over the grid
    as ``run_sweep_on_mesh`` builds it (warmup 0, cosine over 8,000 steps,
    the sparse head, one shared batch stream); S4 one step."""
    raw, tr, te, _ = _mqar_config(fid)
    raw = derive_runtime_fields(raw, 32, len(tr[0]))
    model_cfg, family = raw["model"], raw["model"]["layer"]
    n_steps = 1 if fid == "s4" else 2
    k = sparse_head_k_for(model_cfg, tr[1], te[1])
    lrs = np.array([r[0] for r in RATES], np.float32)
    slrs = np.array([r[1] for r in RATES], np.float32)

    jcfg = JaxExperimentConfig(copy.deepcopy(raw)).validate()
    jtrain, _, _ = jax_build_models(jcfg.model, False)
    state = jax_sweep._stacked_state(jcfg, jtrain, list(SEEDS), integer_inputs=True)
    if fid == "s4":
        state = state.replace(params=_raise_log_step(state.params))
    groups = tuple(sorted(state.opt_state.inner_states.keys()))
    norm = _family_norm(model_cfg, family)
    block = jax_scan_loop.make_train_block(jtrain, norm, groups, warmup=0, total_steps=8_000,
                                           cosine=True, lr_min=1e-6, sparse_head_k=k)
    vblock = jax.jit(jax.vmap(
        lambda st, rng, d, idx, s0, lr, slr: block(st, rng, d, idx, s0, lr, slr),
        in_axes=(0, 0, None, None, None, 0, 0)))
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), raw["train"]["batch_size"],
                        n_steps)
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.arange(2, dtype=jnp.uint32))
    init = to_numpy(state.params)
    init_stats = to_numpy(state.batch_stats) if norm == "batch" else None
    jstate, jloss = vblock(state, rngs, jax_scan_loop.put_dataset(*tr), jnp.asarray(idx),
                           jnp.asarray(0, jnp.int32), jnp.asarray(lrs), jnp.asarray(slrs))

    pick = lambda t, g: None if t is None else jax.tree_util.tree_map(lambda a: a[g], t)  # noqa: E731
    models, params, buffers, group_of, clip, f = _port_grid(
        model_cfg, family, raw, [pick(init, g) for g in range(2)],
        [pick(init_stats, g) for g in range(2)])
    assert clip == (1.0 if family in ("mamba", "transformer") else None)
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    grads_fn = sweep_mod.stacked_grads(models[0], k)
    inputs, labels = torch.from_numpy(tr[0]).long(), torch.from_numpy(tr[1]).long()
    losses, lr_sum, gs = [], np.zeros(2), []
    for s in range(n_steps):
        rate = {name: torch.tensor([lr_for_step(s, float(r), 0, 8_000, True, 1e-6) for r in base],
                                   dtype=torch.float32)
                for name, base in (("regular", lrs), ("ssm", slrs))}
        i = torch.from_numpy(idx[s]).long()
        grads, loss = grads_fn(params, buffers, inputs[i].expand(2, -1, -1),
                               labels[i].expand(2, -1, -1))
        gs.append(grads)
        sweep_mod.stacked_adamw_step(params, grads, moments, s + 1, rate, group_of, f["betas"],
                                     clip)
        losses.append(loss.numpy())
        lr_sum += np.maximum(rate["regular"].numpy(), rate["ssm"].numpy())
    np.testing.assert_allclose(np.mean(losses, 0), np.asarray(jloss), rtol=1e-5)
    _hold_params(params, buffers, gs, to_numpy(jstate.params),
                 to_numpy(jstate.batch_stats) if norm == "batch" else None, lr_sum,
                 skip=("log_step",) if fid == "s4" else (), model_cfg=model_cfg)


def test_tlie_tpu_stacked_block_raises_on_a_padded_split_the_port_runs(tmp_path):
    """``tlie_tpu``'s stacked block on the padded ListOps S5: its sweep puts
    inputs and labels alone on the device (``parallel/sweep.py:229-234``),
    and its padded model raises on tokens without lengths.  The port carries
    the lengths: its stacked step on two points, each held to ``tlie_tpu``'s
    serial block (``make_train_block`` with the lengths, as its serial loop
    runs it) on the same weights, two steps."""
    raw, tr, te, l_max = _listops_config(tmp_path)
    raw = derive_runtime_fields(raw, l_max, len(tr[0]))
    model_cfg, n_steps = raw["model"], 2
    jcfg = JaxExperimentConfig(copy.deepcopy(raw)).validate()
    jtrain, _, _ = jax_build_models(jcfg.model, True)
    state = jax_sweep._stacked_state(jcfg, jtrain, list(SEEDS), integer_inputs=True)
    groups = tuple(sorted(state.opt_state.inner_states.keys()))
    block = jax_scan_loop.make_train_block(jtrain, "batch", groups, warmup=0, total_steps=8_000,
                                           cosine=True, lr_min=1e-6)
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), 2, n_steps)
    lrs = np.array([r[0] for r in RATES], np.float32)
    slrs = np.array([r[1] for r in RATES], np.float32)
    vblock = jax.vmap(lambda st, rng, d, i, s0, lr, slr: block(st, rng, d, i, s0, lr, slr),
                      in_axes=(0, 0, None, None, None, 0, 0))
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.arange(2, dtype=jnp.uint32))
    # its padded model unpacks (tokens, lengths) from the token array alone
    with pytest.raises(ValueError):
        vblock(state, rngs, jax_scan_loop.put_dataset(tr[0], tr[1]), jnp.asarray(idx),
               jnp.asarray(0, jnp.int32), jnp.asarray(lrs), jnp.asarray(slrs))

    init, init_stats = to_numpy(state.params), to_numpy(state.batch_stats)
    pick = lambda t, g: jax.tree_util.tree_map(lambda a: a[g], t)  # noqa: E731
    want, want_stats, want_loss = [], [], []
    for g in range(2):
        st = jax.tree_util.tree_map(lambda a: a[g], state)
        st, loss = block(st, jax.random.PRNGKey(g), jax_scan_loop.put_dataset(*tr), idx, 0,
                         lrs[g], slrs[g])
        want.append(to_numpy(st.params))
        want_stats.append(to_numpy(st.batch_stats))
        want_loss.append(float(loss))
    stack = lambda trees: jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)  # noqa: E731
    models, params, buffers, group_of, clip, f = _port_grid(
        model_cfg, "s5", raw, [pick(init, g) for g in range(2)],
        [pick(init_stats, g) for g in range(2)], padded=True)
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    grads_fn = sweep_mod.stacked_grads(models[0], None)
    inputs, labels = torch.from_numpy(tr[0]).long(), torch.from_numpy(tr[1]).long()
    lengths = torch.from_numpy(tr[2]).float()
    losses, lr_sum, gs = [], np.zeros(2), []
    for s in range(n_steps):
        rate = {name: torch.tensor([lr_for_step(s, float(r), 0, 8_000, True, 1e-6) for r in base],
                                   dtype=torch.float32)
                for name, base in (("regular", lrs), ("ssm", slrs))}
        i = torch.from_numpy(idx[s]).long()
        x = (inputs[i].expand(2, -1, -1), lengths[i].expand(2, -1))
        grads, loss = grads_fn(params, buffers, x, labels[i].expand(2, -1))
        gs.append(grads)
        sweep_mod.stacked_adamw_step(params, grads, moments, s + 1, rate, group_of, f["betas"],
                                     clip)
        losses.append(loss.numpy())
        lr_sum += np.maximum(rate["regular"].numpy(), rate["ssm"].numpy())
    np.testing.assert_allclose(np.mean(losses, 0), want_loss, rtol=1e-5)
    _hold_params(params, buffers, gs, stack(want), stack(want_stats), lr_sum)


# -- the configs that once met a refusal ----------------------------------------------------

def test_fused_head_config_trains_stacked_through_the_dense_head(tmp_path, monkeypatch):
    """A ``train.fused_xent: true`` config stacks: the point trains through
    the dense head (no fused-head call), as ``tlie_tpu``'s stacked block
    takes no fused head, and equals its serial run with the flag off."""
    from tlie_tpu_torch.training import steps as steps_mod

    raw, tr, te, l_max = _mqar_config("mamba2", tmp_path)
    raw["train"]["fused_xent"] = True
    raw["train"]["sparse_head"] = False  # the dense head, not the sparse one
    monkeypatch.setattr(steps_mod, "fused_head_loss", lambda *a: pytest.fail("fused head"))
    base = ExperimentConfig(copy.deepcopy(raw))
    points = _points()[:1]
    (res,), (wave,) = run_sweep(base, points, tr, te, l_max, device="cpu")
    cfg = derive_runtime_fields(apply_sweep_point(base, points[0]).raw, l_max, len(tr[0]))
    cfg["save"], cfg["train"]["fused_xent"] = None, False
    ser = train(cfg, tr, te, device="cpu")
    for h, s in zip(wave["histories"][0], ser.history):
        assert h["train_loss"] == pytest.approx(s["train_loss"], rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("sweep", ["mqar-mamba2-layers.yaml", "mqar-sm-attention-seeds.yaml",
                                   "cifar-sm-attention-layers.yaml"],
                         ids=["mamba2_layers", "sm_seeds", "cifar_sm_layers"])
def test_sweep_files_of_the_kernel_families_run_stacked(tmp_path, monkeypatch, sweep):
    """``launch --sweep_parallel`` on a cut of each sweep file whose family
    ``--sweep_parallel`` once refused (its base config cut to tiny widths, 2
    steps, two points of its grid): every point trained, checkpointed and
    journaled."""
    monkeypatch.chdir(tmp_path)
    spec = load_yaml(ROOT / "configs" / "sweep" / sweep)
    base = load_yaml(ROOT / "configs" / spec["base_config"])
    base["model"].update(hidden_dim=16, state_dim=16, dropout=0.0)
    if base["model"]["layer"] == "transformer":
        base["model"].update(num_heads=2, mixer_dim=16)
    if base["dataset"]["_name_"] == "mqar":
        base["dataset"].update(MQAR_TINY)
        base["model"].update(vocab_size=64, output_dim=64, max_pos_embed=32)
        base["train"].update(total_steps=2, eval_every=2, batch_size=8)
    else:  # CIFAR: the synthetic split, one epoch of 2 steps
        base["dataset"].update(synthetic_train=16, synthetic_test=8)
        base["model"].update(max_pos_embed=1024)
        base["train"].update(num_epochs=1, batch_size=8, warmup=0)
    base["save"] = str(tmp_path / "checkpoint" / "s")
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(base))
    grid = {k: v[:2] if isinstance(v, list) else {kk: vv[:2] for kk, vv in v.items()}
            for k, v in spec["sweep"].items()}
    if "train" in grid and "model" in grid:  # rates × layers: two of one group
        grid["model"] = {"num_layers": grid["model"]["num_layers"][:1]}
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump({"base_config": str(tmp_path / "base.yaml"), "sweep": grid}))
    assert launch.main(["--config", str(path), "--sweep_parallel", "--device", "cpu"]) == 0
    with open(tmp_path / "checkpoint" / "s.sweep_journal.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 and all(os.path.exists(r["path"]) for r in records)


# -- the card run's paths 29-31, rehearsed ----------------------------------------------------

@pytest.mark.parametrize("tag", ["lru_sweep", "mamba2_layers_sweep", "sm_seeds_sweep"])
def test_chip_smoke_paths_29_to_31_run_on_the_cpu(monkeypatch, tag):
    """``chip_smoke.kernel_sweep_path`` on each of ``kernel_sweep_specs``'
    sweeps (the MQAR LRU's seeds, the Mamba-2's rates × layers, the softmax
    transformer's seeds), their configs cut to tiny widths on the CPU, 4
    stacked steps with an eval every 2 and the point check at 2, with the
    card's timers stubbed and the kernels' wrappers counting plain versions:
    the journal, checkpoints and analyses, the launches of the steps (each
    backward kernel ``per_step`` a stacked step), the resume, the point
    against its serial run and each group's stacked step against a serial
    step (the same launches) all run as on the card."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True, scan_kernels=True, attention_kernels=True)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "SWEEP_CHECK_STEPS", 2)
    monkeypatch.setattr(cs, "TRAIN_EXAMPLES", MQAR_TINY["num_train_examples"])
    base_raw, points, steps, every, per_step = cs.kernel_sweep_specs()[tag]
    assert (steps, every) == ((100, 50) if tag == "lru_sweep" else (50, 25))
    assert len(points) == (8 if tag == "mamba2_layers_sweep" else 4)
    tiny = copy.deepcopy(base_raw)
    tiny["dataset"].update(MQAR_TINY)
    tiny["train"]["batch_size"] = 8
    tiny["model"].update(hidden_dim=32, state_dim=16 if tiny["model"]["layer"] != "transformer"
                         else 32, output_dim=64, seq_len=32)
    for key, value in (("vocab_size", 64), ("input_dim", 64), ("max_pos_embed", 32),
                       ("num_heads", 2), ("mixer_dim", 32)):
        if key in tiny["model"] and not (key == "input_dim" and tiny["model"]["input_dim"] == 1):
            tiny["model"][key] = value
    data = MQAR(**tiny["dataset"])
    launches = cs.kernel_sweep_path(torch.device("cpu"), tag, tiny, points, data.split("train"),
                                    data.split("test"), ARTIFACT_FILES, 4, 2, per_step)
    layers = sorted({p.get(("model", "num_layers"), tiny["model"]["num_layers"]) for p in points})
    for name, n in per_step({"num_layers": 1}).items():
        if "bwd" in name:
            assert launches[name] == 4 * sum(layers) * n
