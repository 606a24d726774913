"""``train.param_group`` in the port (``training/state.py``'s
``MultiStepsAdamW`` for the serial trainer, ``parallel/sweep.py``'s
``StackedMultiSteps`` for the stacked one) against ``tlie_tpu``'s
``create_train_state_adamw`` (``training/state.py:143-170``): the leaves
whose flax leaf name contains the substring train with optax's ``adamw`` at
``group_lr`` inside ``optax.MultiSteps(every_k_schedule=update_step)``, the
regular chain's clip covering the other leaves alone.

A tiny MQAR Mamba-2 with ``param_group: bias`` (every ``bias`` and
``dt_bias`` leaf, so the substring match shows), ``update_step`` 3 and 4
steps (one emitted group step, then a mini-step into the next): the serial
trainer against ``tlie_tpu``'s ``make_train_block`` on the same weights,
the stacked trainer against it vmapped over two points, a run resumed from
a snapshot written mid-accumulation against the uninterrupted run bit for
bit, and ``group_lr`` ≠ 1e-3 through both trainers, where ``tlie_tpu``'s
stacked block takes ``make_train_block``'s default 1e-3 instead (a fault of
the reference, ROADMAP Queue 3).

Tolerances (as ``tests/test_torch_sweep.py`` holds the stacked step): the
mean loss within 1e-5 relative; each parameter within 2e-6 absolute where
both recorded gradients are at least 1e-2 of their leaf's max or the
gradient is 0, and within the movement bound (2·Σ lr of its group) +
2e-6 everywhere.
"""

import copy
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.config import ExperimentConfig as JaxExperimentConfig
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.parallel import sweep as jax_sweep
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import derive_runtime_fields, load_yaml, train_fields
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import sweep as sweep_mod
from tlie_tpu_torch.training import loop as loop_mod
from tlie_tpu_torch.training import steps as steps_mod
from tlie_tpu_torch.training import train, train_step
from tlie_tpu_torch.training.scan_loop import batch_indices, sparse_head_k_for
from tlie_tpu_torch.training.schedules import lr_for_step
from tlie_tpu_torch.training.state import GROUP, MultiStepsAdamW, make_family_optimizer
from torch_parity import to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (1919, 2222)
N_STEPS, EVERY_K, GROUP_LR = 4, 3, 0.01
LRS = np.array([0.003, 0.001], np.float32)


def _config(group_lr=GROUP_LR, save=None):
    raw = load_yaml(ROOT / "configs" / "mqar-mamba2-small.yaml")
    raw["dataset"].update(input_seq_length=32, num_kv_pairs=4, vocab_size=64,
                          num_train_examples=128, num_test_examples=32)
    raw["model"].update(hidden_dim=32, state_dim=16, vocab_size=64, output_dim=64,
                        max_pos_embed=32, dropout=0.0)
    raw["train"].update(total_steps=N_STEPS, eval_every=2, batch_size=8, param_group="bias",
                        group_lr=group_lr, update_step=EVERY_K, warmup_steps=0)
    raw["save"] = save
    data = MQAR(**raw["dataset"])
    tr, te = data.split("train"), data.split("test")
    return derive_runtime_fields(raw, data.l_max, len(tr[0])), tr, te


def _jax_state(raw, seeds, group_lr):
    """tlie_tpu's stacked state (the group's rate as the config gives it)
    and its block, with ``group_lr`` passed to ``make_train_block``."""
    jcfg = JaxExperimentConfig(copy.deepcopy(raw)).validate()
    jtrain, _, _ = jax_build_models(jcfg.model, False)
    state = jax_sweep._stacked_state(jcfg, jtrain, list(seeds), integer_inputs=True)
    assert tuple(sorted(state.opt_state.inner_states.keys())) == ("group", "regular")
    k = sparse_head_k_for(raw["model"], *_labels(raw))
    kw = {} if group_lr is None else {"group_lr": group_lr}
    block = jax_scan_loop.make_train_block(jtrain, "layer", ("group", "regular"), warmup=0,
                                           total_steps=N_STEPS, cosine=True, lr_min=1e-6,
                                           sparse_head_k=k, **kw)
    return state, block, k


def _labels(raw):
    data = MQAR(**raw["dataset"])
    return data.split("train")[1], data.split("test")[1]


def _port_model(raw, params):
    model, _, _ = build_models(raw["model"], generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _hold(got_sd, want, grads, lr_sum, group_lr_sum):
    """One point's parameters (a state dict) against tlie_tpu's tree."""
    got, _ = params_to_jax(got_sd)
    g1, _ = params_to_jax(grads[0])
    g2, _ = params_to_jax(grads[-1])
    n_det = n_all = 0
    for (path, a), w, d1, d2 in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree_util.tree_leaves(want),
                                    jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        in_group = "bias" in path[-1].key
        err = np.abs(np.asarray(a) - np.asarray(w))
        assert err.max() <= 2 * (group_lr_sum if in_group else lr_sum) + 2e-6, path
        det = (np.abs(d1) >= 1e-2 * np.abs(d1).max()) & (np.abs(d2) >= 1e-2 * np.abs(d2).max())
        assert err[det | (d1 == 0)].max(initial=0.0) <= 2e-6, path
        n_det, n_all = n_det + det.sum(), n_all + (d1 != 0).sum()
    assert n_det > 0.4 * n_all


def test_group_is_the_leaves_whose_flax_name_holds_the_substring():
    """``param_group: bias`` takes every ``bias`` and ``dt_bias`` leaf (the
    flax leaf names, never torch's ``weight``), at optax's defaults and the
    config's rate and ``update_step``; the rest stays ``regular``."""
    raw, _, _ = _config()
    model, _, _ = build_models(raw["model"], generator=torch.Generator(), device="cpu")
    opt, clip = make_family_optimizer(model, "mamba", raw["model"], raw["train"],
                                      train_fields(raw))
    assert isinstance(opt, MultiStepsAdamW) and clip == 1.0
    regular, group = opt.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = {flax_path(names[id(p)])[-1] for p in group["params"]}
    assert leaves == {"bias", "dt_bias"}
    assert all("bias" not in flax_path(names[id(p)])[-1] for p in regular["params"])
    assert (group["name"], group["lr"], group["weight_decay"], group["betas"],
            group["every_k"]) == (GROUP, GROUP_LR, 1e-4, (0.9, 0.999), EVERY_K)


def _serial_port(raw, tr, params, k, lrs_of):
    """The port's serial steps (``train_step``) on ``params``: (model,
    losses, the gradients recorded at each step before the clip)."""
    model = _port_model(raw, params)
    f = train_fields(raw)
    opt, clip = make_family_optimizer(model, "mamba", raw["model"], raw["train"], f)
    inputs, labels = torch.from_numpy(tr[0]).long(), torch.from_numpy(tr[1]).long()
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), 8, N_STEPS)
    grads, losses = [], []
    real_clip = steps_mod.clip_by_global_norm_

    def recording_clip(ps, norm):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return real_clip(ps, norm)

    mp = pytest.MonkeyPatch()
    mp.setattr(steps_mod, "clip_by_global_norm_", recording_clip)
    try:
        for s in range(N_STEPS):
            i = torch.from_numpy(idx[s]).long()
            losses.append(float(train_step(model, opt, inputs[i], labels[i], lrs_of(s), k,
                                           clip_norm=clip)))
    finally:
        mp.undo()
    return model, losses, grads, idx


def test_serial_steps_match_create_train_state_adamw():
    """Four serial steps against ``make_train_block`` on
    ``create_train_state_adamw``'s weights: the group stays put on the two
    mini-steps, steps once on the third with the mean of three gradients,
    and the clip leaves it out."""
    raw, tr, te = _config()
    state, block, k = _jax_state(raw, SEEDS[:1], GROUP_LR)
    state = jax.tree_util.tree_map(lambda a: a[0], state)
    init = to_numpy(state.params)
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), 8, N_STEPS)
    jstate, jloss = block(state, jax.random.PRNGKey(0), jax_scan_loop.put_dataset(*tr), idx, 0,
                          float(LRS[0]), float(LRS[0]))
    rate = lambda s: {"regular": lr_for_step(s, float(LRS[0]), 0, N_STEPS, True, 1e-6),  # noqa
                      "group": GROUP_LR}
    model, losses, grads, _ = _serial_port(raw, tr, init, k, rate)
    np.testing.assert_allclose(np.mean(losses), float(jloss), rtol=1e-5)
    lr_sum = sum(rate(s)["regular"] for s in range(N_STEPS))
    _hold(model.state_dict(), to_numpy(jstate.params), grads, lr_sum, GROUP_LR)


def test_the_group_waits_for_update_step():
    """After two steps the group's leaves are their init bit for bit, the
    regular ones have moved; the accumulator holds the two steps' mean."""
    raw, tr, te = _config()
    raw["train"].update(total_steps=2, eval_every=2)
    result = train(raw, tr, te, device="cpu")
    init = build_models(raw["model"], generator=torch.Generator().manual_seed(raw["seed"]),
                        device="cpu")[0].state_dict()
    for name, p in result.model.state_dict().items():
        same = torch.equal(p, init[name])
        assert same == ("bias" in flax_path(name)[-1]), name
    group = result.optimizer.param_groups[1]
    assert group["mini_step"] == 2 and all(a.abs().max() > 0 for a in group["acc"])


def _stacked_port(raw, tr, init, k, group_rate):
    """The port's stacked steps over the two points on tlie_tpu's weights."""
    models = [_port_model(raw, jax.tree_util.tree_map(lambda a: a[g], init)) for g in range(2)]
    params, buffers = torch.func.stack_module_state(models)
    params = {n: p.detach() for n, p in params.items()}
    f = train_fields(raw)
    group_of, clip = sweep_mod.optimizer_groups(models[0], "mamba", raw["model"], raw["train"], f)
    in_group = [n for n, (g, _) in group_of.items() if g == GROUP]
    assert in_group and all("bias" in flax_path(n)[-1] for n in in_group)
    ms = sweep_mod.StackedMultiSteps(params, in_group, EVERY_K)
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    grads_fn = sweep_mod.stacked_grads(models[0], k)
    inputs, labels = torch.from_numpy(tr[0]).long(), torch.from_numpy(tr[1]).long()
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), 8, N_STEPS)
    losses, gs, lr_sum = [], [], np.zeros(2)
    for s in range(N_STEPS):
        rate = torch.tensor([lr_for_step(s, float(r), 0, N_STEPS, True, 1e-6) for r in LRS])
        i = torch.from_numpy(idx[s]).long()
        grads, loss = grads_fn(params, buffers, inputs[i].expand(2, -1, -1),
                               labels[i].expand(2, -1, -1))
        gs.append(grads)
        sweep_mod.stacked_adamw_step(params, grads, moments, s + 1,
                                     {"regular": rate, GROUP: torch.full((2,), group_rate)},
                                     group_of, f["betas"], clip, multi_steps=ms)
        losses.append(loss.numpy())
        lr_sum += rate.numpy()
    assert (ms.mini_step, ms.count) == (N_STEPS % EVERY_K, N_STEPS // EVERY_K)
    return params, gs, np.mean(losses, 0), lr_sum, idx


def _vblock(block):
    return jax.jit(jax.vmap(lambda st, rng, d, i, s0, lr, slr: block(st, rng, d, i, s0, lr, slr),
                            in_axes=(0, 0, None, None, None, 0, 0)))


def test_stacked_steps_match_the_vmapped_block():
    """Two stacked points, four steps, against ``make_train_block`` (given
    the config's ``group_lr``) vmapped over the grid."""
    raw, tr, _ = _config()
    state, block, k = _jax_state(raw, SEEDS, GROUP_LR)
    init = to_numpy(state.params)
    params, gs, loss, lr_sum, idx = _stacked_port(raw, tr, init, k, GROUP_LR)
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.arange(2, dtype=jnp.uint32))
    jstate, jloss = _vblock(block)(state, rngs, jax_scan_loop.put_dataset(*tr), jnp.asarray(idx),
                                   jnp.asarray(0, jnp.int32), jnp.asarray(LRS), jnp.asarray(LRS))
    np.testing.assert_allclose(loss, np.asarray(jloss), rtol=1e-5)
    want = to_numpy(jstate.params)
    for g in range(2):
        _hold({n: p[g] for n, p in params.items()}, jax.tree_util.tree_map(lambda a: a[g], want),
              [{n: t[g] for n, t in x.items()} for x in (gs[0], gs[-1])], lr_sum[g], GROUP_LR)


def test_stacked_group_lr_is_the_configs_not_the_reference_default():
    """At ``group_lr`` 0.01 (≠ 1e-3): ``tlie_tpu``'s stacked block as
    ``run_sweep_on_mesh`` builds it (``make_train_block`` without
    ``group_lr``, ``parallel/sweep.py:263-266``) steps the group at 1e-3,
    which its serial loop (``training/loop.py:347-350``) does not; the port's
    stacked trainer takes the config's rate, as its serial one does."""
    raw, tr, _ = _config()
    state, block, k = _jax_state(raw, SEEDS, GROUP_LR)
    _, default_block, _ = _jax_state(raw, SEEDS, None)
    init = to_numpy(state.params)
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), 8, N_STEPS)
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.arange(2, dtype=jnp.uint32))
    args = (rngs, jax_scan_loop.put_dataset(*tr), jnp.asarray(idx), jnp.asarray(0, jnp.int32),
            jnp.asarray(LRS), jnp.asarray(LRS))
    with_rate = to_numpy(_vblock(block)(state, *args)[0].params)
    as_reference = to_numpy(_vblock(default_block)(state, *args)[0].params)
    params, _, _, _, _ = _stacked_port(raw, tr, init, k, GROUP_LR)
    got, _ = params_to_jax({n: p[0] for n, p in params.items()})
    for (path, a), w, r in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree_util.tree_leaves(with_rate),
                               jax.tree_util.tree_leaves(as_reference)):
        if "bias" in path[-1].key:  # one group step of about ±rate
            np.testing.assert_allclose(a, w[0], rtol=0, atol=2e-6, err_msg=str(path))
            assert np.abs(np.asarray(r[0]) - np.asarray(w[0])).max() > 5e-3, path


def test_a_run_resumed_mid_accumulation_is_the_uninterrupted_one(tmp_path, monkeypatch):
    """A snapshot at step 2 (mini-step 2 of 3: the accumulator holds two
    steps' mean) put back and resumed gives the uninterrupted run's weights,
    Adam moments, accumulator and mini-step bit for bit."""
    raw, tr, te = _config(save=str(tmp_path / "ckpt" / "pg"))
    raw["train"]["checkpoint_every"] = 2
    kept = []
    save = loop_mod.save_resume

    def keep(path, model, optimizer, meta):
        out = save(path, model, optimizer, meta)
        shutil.copyfile(out, f"{out}.step{meta['step']}")
        kept.append(f"{out}.step{meta['step']}")
        return out

    monkeypatch.setattr(loop_mod, "save_resume", keep)
    whole = train(raw, tr, te, device="cpu")
    monkeypatch.undo()
    snap = loop_mod.resume_path(raw)
    assert len(kept) == 1 and not os.path.exists(snap)
    snapshot = torch.load(kept[0], weights_only=True)
    assert snapshot["optimizer"]["param_groups"][1]["mini_step"] == 2
    shutil.copyfile(kept[0], snap)
    resumed = train(dict(raw, train=dict(raw["train"], resume=True)), tr, te, device="cpu")
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            whole.model.state_dict().values()):
        assert torch.equal(a, b), name
    got, want = resumed.optimizer.param_groups[1], whole.optimizer.param_groups[1]
    assert got["mini_step"] == want["mini_step"] == N_STEPS % EVERY_K
    assert all(torch.equal(a, b) for a, b in zip(got["acc"], want["acc"]))
    gs, ws = resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"]
    for i, st in ws.items():
        for key, v in st.items():
            assert torch.equal(gs[i][key], v), (i, key)
