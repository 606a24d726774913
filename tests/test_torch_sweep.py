"""Sweeps in the port (``tlie_tpu_torch.launch --sweep`` and
``--sweep_parallel``, ``tlie_tpu_torch/parallel/sweep.py``) against
``tlie_tpu``'s: the grouping, point keys and journal on every sweep YAML,
the serial and the stacked sweep end to end on the CPU (checkpoints,
journal, eigen-analysis, resume, the ``-pN`` suffix), the masked early
stop, each stacked point against its own serial run, and the stacked step
against ``tlie_tpu``'s vmapped ``make_train_block`` (built as
``bench.py::_bench_sweep_grid`` builds it) on the same weights.

Inputs are made with numpy from a seed; JAX runs jitted at HIGHEST matmul
precision (tests/conftest.py).  Parity runs at dropout 0: the stacked
points draw their dropout masks per point under ``vmap``, which cannot equal
a serial run's generator stream.  Tolerances are stated where they are used.
"""

import copy
import json
import os
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.config import ExperimentConfig as JaxExperimentConfig
from tlie_tpu.config import apply_sweep_point as jax_apply_sweep_point
from tlie_tpu.config import expand_sweep as jax_expand_sweep
from tlie_tpu.config import load_sweep as jax_load_sweep
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.parallel import sweep as jax_sweep
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import (
    apply_sweep_point, derive_runtime_fields, expand_sweep, load_sweep, load_yaml,
)
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import run_sweep
from tlie_tpu_torch.parallel import sweep as sweep_mod
from tlie_tpu_torch.training import restore_checkpoint, train
from tlie_tpu_torch.training.loop import save_trained
from tlie_tpu_torch.training.scan_loop import batch_indices, sparse_head_k_for
from tlie_tpu_torch.training.schedules import lr_for_step
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SWEEP_YAMLS = sorted((ROOT / "configs" / "sweep").glob("*.yaml"))
SMALL_SWEEP = ROOT / "configs" / "sweep" / "mqar-lin-attention-small-seeds.yaml"


def _write_cut_sweep(tmp_path, *, lrs=(0.003,), steps=20, eval_every=10, dropout=None,
                     stop=None, base_yaml=None, attention=None):
    """``configs/sweep/mqar-lin-attention-small-seeds.yaml`` cut for the CPU:
    its two seeds at the learning rates given, 20 steps with an eval every
    10, 256 training and 64 test examples, and ``save`` under ``tmp_path``.
    Returns the sweep file's path."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    sweep = load_yaml(SMALL_SWEEP)
    base = load_yaml(base_yaml or (ROOT / "configs" / sweep["base_config"]))
    base["train"].update(total_steps=steps, eval_every=eval_every)
    if stop is not None:
        base["train"]["stop_criterion"] = stop
    base["dataset"].update(num_train_examples=256, num_test_examples=64)
    if dropout is not None:
        base["model"]["dropout"] = dropout
    if attention is not None:
        base["model"]["attention_fn"] = attention
    base["save"] = str(tmp_path / "checkpoint" / "sweep")
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(base))
    sweep["base_config"] = str(tmp_path / "base.yaml")
    sweep["sweep"]["train"]["lr"] = list(lrs)
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(sweep))
    return path


def _analysis(tmp_path):
    conf = load_yaml(ROOT / "configs" / "analysis" / "mqar.yaml")
    conf["save_path"] = str(tmp_path / "analysis")
    path = tmp_path / "analysis.yaml"
    path.write_text(yaml.safe_dump(conf))
    return path


def _journal(tmp_path):
    with open(tmp_path / "checkpoint" / "sweep.sweep_journal.jsonl") as f:
        return [json.loads(line) for line in f]


# -- grouping, keys and the journal against tlie_tpu ----------------------------

@pytest.mark.parametrize("path", SWEEP_YAMLS, ids=[p.stem for p in SWEEP_YAMLS])
def test_grouping_point_keys_and_journal_match_tlie_tpu(path, tmp_path):
    """Every sweep YAML under ``configs/sweep/`` through both packages: the
    same points in the same order, the same ``_point_key`` strings, the same
    ``_group_signature`` strings (after the runtime fields, here from a
    stand-in dataset of 1,000 examples of length 64), so the same groups;
    the same journal path; and a journal the port writes reads back through
    ``tlie_tpu``'s ``_load_journal`` to the same records."""
    jbase, jsweep = jax_load_sweep(path, config_root=ROOT / "configs")
    base, sweep = load_sweep(path, config_root=ROOT / "configs")
    assert base.raw == jbase.raw and sweep == jsweep
    jpoints, points = jax_expand_sweep(jsweep), expand_sweep(sweep)
    assert points == jpoints
    assert [sweep_mod._point_key(p) for p in points] == [jax_sweep._point_key(p) for p in jpoints]
    ds = types.SimpleNamespace(l_max=64, train_inputs=range(1000))
    sigs, jsigs = [], []
    for p in points:
        c = apply_sweep_point(base, p)
        c.raw = derive_runtime_fields(c.raw, 64, 1000)
        jc = jax_apply_sweep_point(jbase, p).derive_runtime_fields(ds)
        sigs.append(sweep_mod._group_signature(c))
        jsigs.append(jax_sweep._group_signature(jc))
    assert sigs == jsigs
    assert sweep_mod._journal_path(base) == jax_sweep._journal_path(jbase)
    journal = str(tmp_path / "j" / "sweep.sweep_journal.jsonl")
    for i, p in enumerate(points[:3]):
        sweep_mod.write_journal(journal, p, f"/ck/{i}.pth" if i else None, 0.25 * i)
    assert sweep_mod._load_journal(journal) == jax_sweep._load_journal(journal)
    assert list(jax_sweep._load_journal(journal)) == [sweep_mod._point_key(p) for p in points[:3]]


def test_grid_of_the_north_star_sweep():
    """``configs/sweep/mqar-lin-attention-seeds-lrs-8k.yaml``: 16 points,
    four seeds by four rates, one group (only seed and lr vary)."""
    base, sweep = load_sweep(ROOT / "configs/sweep/mqar-lin-attention-seeds-lrs-8k.yaml",
                             config_root=ROOT / "configs")
    points = expand_sweep(sweep)
    assert len(points) == 16
    sigs = {sweep_mod._group_signature(apply_sweep_point(base, p)) for p in points}
    assert len(sigs) == 1


# -- the serial sweep ----------------------------------------------------------------

def test_serial_sweep_trains_checkpoints_journals_and_resumes(tmp_path, monkeypatch, capsys):
    """``launch --sweep`` on a two-point cut of the small seed sweep: each
    point trained, checkpointed under its own seed, journaled with its
    checkpoint and perf, and eigen-analysed; a rerun skips both points."""
    monkeypatch.chdir(tmp_path)
    path = _write_cut_sweep(tmp_path)
    argv = ["--config", str(path), "--sweep", "--device", "cpu",
            "--analysis_config", str(_analysis(tmp_path))]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("Done with") == 2 and out.count("Finished!") == 2
    records = _journal(tmp_path)
    assert [json.loads(r["point_key"]) for r in records] == [
        {"seed": 1919, "train/lr": 0.003}, {"seed": 2222, "train/lr": 0.003}]
    for rec, seed in zip(records, (1919, 2222)):
        assert os.path.basename(rec["path"]).startswith(f"sweep-seed-{seed}-layers-2")
        ckpt = restore_checkpoint(rec["path"])
        assert ckpt["config"]["train"]["lr"] == 0.003
        assert f"-perf{rec['perf']:0.3f}.pth" in rec["path"]
    assert len(os.listdir(tmp_path / "analysis")) == 2
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("Skipping") == 2 and "Training..." not in out
    assert len(_journal(tmp_path)) == 2


def test_checkpoint_paths_that_collide_take_a_suffix(tmp_path):
    """``save_trained`` with a sweep's set of paths: the second and third
    points of one name get ``-p1`` and ``-p2``, each path joins the set, and
    without the set the name is written over, as a single run does."""
    cfg = {"save": str(tmp_path / "ck"), "seed": 1, "model": {"num_layers": 2, "state_dim": 8},
           "train": {}, "dataset": {}}
    model = torch.nn.Linear(2, 2)
    used = set()
    paths = [save_trained(cfg, model, 0.5, used) for _ in range(3)]
    stem = str(tmp_path / "ck-seed-1-layers-2dim_conv0-s_d-8-perf0.500")
    assert paths == [stem + ".pth", stem + "-p1.pth", stem + "-p2.pth"]
    assert used == set(paths)
    assert save_trained(cfg, model, 0.5) == stem + ".pth"


# -- the stacked sweep -----------------------------------------------------------------

def test_stacked_sweep_trains_checkpoints_journals_and_resumes(tmp_path, monkeypatch, capsys):
    """``launch --sweep_parallel`` on the same cut: one group of two points,
    each checkpointed, journaled and eigen-analysed; a rerun trains nothing
    and returns the journaled (path, perf)."""
    monkeypatch.chdir(tmp_path)
    path = _write_cut_sweep(tmp_path)
    argv = ["--config", str(path), "--sweep_parallel", "--device", "cpu",
            "--analysis_config", str(_analysis(tmp_path))]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "[sweep] group 2 points" in out and "point-steps/s" in out
    records = _journal(tmp_path)
    assert len(records) == 2 and all(os.path.exists(r["path"]) for r in records)
    assert len(os.listdir(tmp_path / "analysis")) == 2
    assert launch.main(argv) == 0
    assert "[sweep] group" not in capsys.readouterr().out
    base, sweep = load_sweep(path)
    data = MQAR(**base.dataset)
    res, waves = run_sweep(base, expand_sweep(sweep), data.split("train"), data.split("test"),
                           data.l_max, device="cpu")
    assert res == [(r["path"], r["perf"]) for r in records] and waves == []


def test_collisions_in_a_stacked_sweep_take_a_suffix(tmp_path):
    """Two points of one seed at learning rates of 1e-9 and 2e-9: the same
    perf to three decimals, so the same checkpoint name; the second takes
    ``-p1``."""
    path = _write_cut_sweep(tmp_path, lrs=(1e-9, 2e-9), steps=4, eval_every=4)
    base, sweep = load_sweep(path)
    sweep["seed"] = [1919]
    data = MQAR(**base.dataset)
    res, _ = run_sweep(base, expand_sweep(sweep), data.split("train"), data.split("test"),
                       data.l_max, device="cpu")
    (p0, f0), (p1, f1) = res
    assert f"{f0:0.3f}" == f"{f1:0.3f}" and p1 == p0[:-len(".pth")] + "-p1.pth"


def _stacked_and_serial(tmp_path, steps, stop=None):
    """The two points of the cut at dropout 0, stacked (``run_sweep``) and
    each alone (``train``): (stacked results, stacked waves, serial
    results)."""
    path = _write_cut_sweep(tmp_path, lrs=(0.003,), steps=steps, eval_every=10, dropout=0.0,
                            stop=stop)
    base, sweep = load_sweep(path)
    sweep["train"]["lr"] = [0.003]
    points = expand_sweep(sweep)
    points[1][("train", "lr")] = 0.001  # two rates as well as two seeds
    data = MQAR(**base.dataset)
    tr, te = data.split("train"), data.split("test")
    stacked, waves = run_sweep(base, points, tr, te, data.l_max, device="cpu")
    serial = []
    for p in points:
        cfg = derive_runtime_fields(apply_sweep_point(base, p).raw, data.l_max, len(tr[0]))
        cfg["save"] = None
        serial.append(train(cfg, tr, te, device="cpu"))
    return stacked, waves, serial


def test_each_stacked_point_is_its_serial_run(tmp_path):
    """Each of two stacked points (seeds 1919 and 2222 at rates 0.003 and
    0.001) against its own serial ``train`` at dropout 0 after 20 steps: the
    train loss, test loss and test metric of both evals within 1e-5
    relative, and every parameter within 1e-5 absolute (the stacked step
    batches the same float32 products, so its sums may run in another
    order; the parameters move about 1e-2 over the 20 steps).  The card
    check (``chip_smoke.sweep_path``) holds a full-width point to the same
    tolerances."""
    stacked, (group,), serial = _stacked_and_serial(tmp_path, 20)
    for hist, ser, (path, perf) in zip(group["histories"], serial, stacked):
        assert [h["step"] for h in hist] == [h["step"] for h in ser.history] == [10, 20]
        for h, s in zip(hist, ser.history):
            for key in ("train_loss", "test_loss", "test_perf"):
                assert h[key] == pytest.approx(s[key], rel=1e-5, abs=1e-7), key
        assert perf == pytest.approx(ser[1], abs=1e-7)
        got = restore_checkpoint(path)["model"]
        for name, want in ser.model.state_dict().items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    model_cfg = restore_checkpoint(stacked[0][0])["config"]["model"]
    for ser, seed in zip(serial, (1919, 2222)):
        init = build_models(model_cfg, generator=torch.Generator().manual_seed(seed),
                            device="cpu")[0].state_dict()
        assert max((init[n] - v).abs().max().item()
                   for n, v in ser.model.state_dict().items()) > 1e-3


def test_a_point_past_the_criterion_keeps_its_parameters(tmp_path):
    """The masked early stop: with ``stop_criterion`` between the two
    points' metrics after the first 10 steps, the point above it stops
    there and its parameters after 20 steps are exactly those after 10
    (it steps on at learning rate 0); the other point trains on."""
    first, _, _ = _stacked_and_serial(tmp_path / "a", 10)
    perfs = [p for _, p in first]
    assert perfs[0] != perfs[1]
    stop = sum(perfs) / 2
    later, (group,), _ = _stacked_and_serial(tmp_path / "b", 20, stop=stop)
    top = int(np.argmax(perfs))
    assert [len(h) for h in group["histories"]][top] == 1
    assert [len(h) for h in group["histories"]][1 - top] == 2
    for slot, ((p_a, f_a), (p_b, f_b)) in enumerate(zip(first, later)):
        a, b = restore_checkpoint(p_a)["model"], restore_checkpoint(p_b)["model"]
        same = all(torch.equal(a[k], b[k]) for k in a)
        assert same == (slot == top)
        if slot == top:
            assert f_b == f_a


# -- the stacked step against tlie_tpu's vmapped block ----------------------------------

def test_stacked_step_matches_tlie_tpu_vmapped_block():
    """Three steps of two stacked points (seeds 1919 and 2222) of the
    small linear attention (d_model 32, two heads, L 40, dropout 0) at
    rates 0.001 and 0.003, on tlie_tpu's ``_stacked_state`` weights carried
    per point by ``params_from_jax``, against ``tlie_tpu``'s
    ``make_train_block`` vmapped over the grid as ``bench.py::
    _bench_sweep_grid`` builds it (warmup 0, cosine over 8,000 steps, the
    sparse head, one shared batch stream): each point's mean loss within
    1e-5 relative, and its parameters 2e-6 absolute where both steps' |g|
    are at least 1e-2 of their leaf's max or the gradient is 0, within the
    movement bound 2·Σ lr + 2e-6 everywhere (Adam divides each element by
    its own magnitude, so near the rounding floor the packages may step
    apart; tests/test_torch_mamba2.py holds the serial step so)."""
    raw = load_yaml(ROOT / "configs" / "mqar-lin-attention-small.yaml")
    raw["dataset"].update(input_seq_length=40, num_kv_pairs=4, vocab_size=64,
                          num_train_examples=128, num_test_examples=64)
    raw["model"].update(hidden_dim=32, state_dim=32, num_heads=2, vocab_size=64, output_dim=64,
                        max_pos_embed=64, dropout=0.0)
    data = MQAR(**raw["dataset"])
    tr, te = data.split("train"), data.split("test")
    raw = derive_runtime_fields(raw, data.l_max, len(tr[0]))
    seeds, lrs, n_steps = [1919, 2222], np.array([0.001, 0.003], np.float32), 3
    model_cfg = raw["model"]
    k = sparse_head_k_for(model_cfg, tr[1], te[1])

    jcfg = JaxExperimentConfig(copy.deepcopy(raw)).validate()
    jtrain, _, _ = jax_build_models(jcfg.model, False)
    state = jax_sweep._stacked_state(jcfg, jtrain, seeds, integer_inputs=True)
    block = jax_scan_loop.make_train_block(jtrain, "layer", ("regular",), warmup=0,
                                           total_steps=8_000, cosine=True, lr_min=1e-6,
                                           sparse_head_k=k)
    vblock = jax.jit(jax.vmap(
        lambda st, rng, d, idx, s0, lr, slr: block(st, rng, d, idx, s0, lr, slr),
        in_axes=(0, 0, None, None, None, 0, 0)))
    idx = batch_indices(np.random.default_rng(0), len(tr[0]), raw["train"]["batch_size"], n_steps)
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.arange(2, dtype=jnp.uint32))
    init = to_numpy(state.params)
    jstate, jloss = vblock(state, rngs, jax_scan_loop.put_dataset(*tr), jnp.asarray(idx),
                           jnp.asarray(0, jnp.int32), jnp.asarray(lrs), jnp.asarray(lrs))

    models = []
    for g in range(2):
        m, _, _ = build_models(model_cfg, generator=torch.Generator(), device="cpu")
        m.load_state_dict(params_from_jax(jax.tree_util.tree_map(lambda a: a[g], init)))
        models.append(m)
    params, buffers = torch.func.stack_module_state(models)
    params = {n: p.detach() for n, p in params.items()}
    f = {"lr": 0.001, "ssm_lr": 0.001, "wd": raw["train"]["wd"], "betas": (0.9, 0.999)}
    group_of, clip = sweep_mod.optimizer_groups(models[0], "transformer", model_cfg,
                                                raw["train"], f)
    assert clip == 1.0 and set(group_of.values()) == {("regular", raw["train"]["wd"])}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    grads_fn = sweep_mod.stacked_grads(models[0], k)
    inputs, labels = torch.from_numpy(tr[0]).long(), torch.from_numpy(tr[1]).long()
    losses, lr_sum, gs = [], np.zeros(2), []
    for s in range(n_steps):
        rate = np.array([lr_for_step(s, float(lr), 0, 8_000, True, 1e-6) for lr in lrs])
        i = torch.from_numpy(idx[s]).long()
        x, y = inputs[i].expand(2, -1, -1), labels[i].expand(2, -1, -1)
        grads, loss = grads_fn(params, buffers, x, y)
        gs.append(grads)
        sweep_mod.stacked_adamw_step(params, grads, moments, s + 1,
                                     {"regular": torch.tensor(rate, dtype=torch.float32)},
                                     group_of, (0.9, 0.999), clip)
        losses.append(loss.numpy())
        lr_sum += rate
    np.testing.assert_allclose(np.mean(losses, 0), np.asarray(jloss), rtol=1e-5)
    want = to_numpy(jstate.params)
    for g in range(2):
        got, _ = params_to_jax({n: p[g] for n, p in params.items()})
        g1, _ = params_to_jax({n: t[g] for n, t in gs[0].items()})
        g2, _ = params_to_jax({n: t[g] for n, t in gs[-1].items()})
        n_det = n_all = 0
        for (path, a), w, d1, d2 in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t[g], want)),
                jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
            err = np.abs(a - w)
            det = (np.abs(d1) >= 1e-2 * np.abs(d1).max()) & (np.abs(d2) >= 1e-2 * np.abs(d2).max())
            assert err[det | (d1 == 0)].max(initial=0.0) <= 2e-6, path
            assert err.max() <= 2 * lr_sum[g] + 2e-6, path
            n_det, n_all = n_det + det.sum(), n_all + (d1 != 0).sum()
        assert n_det > 0.4 * n_all


def test_stacked_adamw_step_is_torch_adamw_behind_the_clip():
    """``stacked_adamw_step`` on two stacked points against
    ``torch.optim.AdamW`` behind ``clip_by_global_norm_`` on each point
    alone, three steps, one point's gradients above the clip's norm: 1e-7
    absolute (the same float32 arithmetic, reassociated); a point at rate 0
    keeps its parameters bit for bit."""
    from tlie_tpu_torch.training.state import clip_by_global_norm_

    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3), "b": (3,)}
    p0 = {n: torch.from_numpy(rng.standard_normal((2,) + s).astype(np.float32))
          for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.standard_normal((2,) + s).astype(np.float32))
              * torch.tensor([0.05, 3.0]).reshape((2,) + (1,) * len(s))
              for n, s in shapes.items()} for _ in range(3)]
    params = {n: v.clone() for n, v in p0.items()}
    moments = {n: (torch.zeros_like(v), torch.zeros_like(v)) for n, v in params.items()}
    group_of = {"w": ("regular", 0.1), "b": ("regular", 0.1)}
    for s, g in enumerate(grads):
        sweep_mod.stacked_adamw_step(params, g, moments, s + 1,
                                     {"regular": torch.tensor([0.01, 0.02])}, group_of,
                                     (0.9, 0.95), 1.0)
    for point, lr in ((0, 0.01), (1, 0.02)):
        ps = [torch.nn.Parameter(p0[n][point].clone()) for n in shapes]
        opt = torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
        for g in grads:
            for p, n in zip(ps, shapes):
                p.grad = g[n][point].clone()
            clip_by_global_norm_(ps, 1.0)
            opt.step()
        for p, n in zip(ps, shapes):
            np.testing.assert_allclose(params[n][point].numpy(), p.detach().numpy(), rtol=0,
                                       atol=1e-7)
    frozen = {n: v.clone() for n, v in params.items()}
    sweep_mod.stacked_adamw_step(params, grads[0], moments, 4,
                                 {"regular": torch.tensor([0.0, 0.02])}, group_of, (0.9, 0.95),
                                 1.0)
    assert all(torch.equal(params[n][0], frozen[n][0]) for n in shapes)
    assert not any(torch.equal(params[n][1], frozen[n][1]) for n in shapes)


# -- the kernel families, stacked ------------------------------------------------------------

@pytest.mark.parametrize("base_yaml, attention", [
    ("mqar-lru-small.yaml", None), ("mqar-mamba2-small.yaml", None),
    ("mqar-lin-attention-small.yaml", "sm-attention")], ids=["lru", "mamba", "softmax"])
def test_sweep_parallel_raises_for_kernel_families(tmp_path, base_yaml, attention):
    """``--sweep_parallel`` over a family whose step runs a port kernel (the
    scan, the decay attention, the flash attention), which it refused until
    the kernels' Functions had ``vmap`` rules, now trains the cut sweep
    stacked: one group of two points, each checkpointed and journaled, each
    kernel's plain version called once a stacked step for both points (as
    the kernel launches once on the card)."""
    from tlie_tpu_torch.ops import attention as attn_mod
    from tlie_tpu_torch.ops import decay_attention as decay_mod
    from tlie_tpu_torch.ops import scan as scan_mod

    path = _write_cut_sweep(tmp_path, base_yaml=ROOT / "configs" / base_yaml, attention=attention,
                            steps=2, eval_every=2)
    if attention == "sm-attention":  # through the flash route (the config sets it off)
        base = load_yaml(tmp_path / "base.yaml")
        base["model"]["use_flash"] = True
        (tmp_path / "base.yaml").write_text(yaml.safe_dump(base))
    module, plain = {"mqar-lru-small.yaml": (scan_mod, "diag_scan_bwd_plain"),
                     "mqar-mamba2-small.yaml": (decay_mod, "decay_attention_bwd_j_plain")}.get(
        base_yaml, (attn_mod, "flash_attention_bwd_dq_plain"))
    calls = [0]
    real = getattr(module, plain)

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(module, plain, counted)
    try:
        assert launch.main(["--config", str(path), "--sweep_parallel", "--device", "cpu"]) == 0
    finally:
        mp.undo()
    layers = load_yaml(ROOT / "configs" / base_yaml)["model"]["num_layers"]
    assert calls[0] == 2 * layers  # 2 stacked steps, one backward call a layer
    records = _journal(tmp_path)
    assert len(records) == 2 and all(os.path.exists(r["path"]) for r in records)


# -- the card run's path 10, rehearsed ---------------------------------------------------

def test_chip_smoke_path_10_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.sweep_path`` at a tiny size on the CPU (the linear
    attention at d_model 32, L 64, vocab 256, batch 32; 4 stacked steps
    with an eval every 2, the card check at 2 steps), with the card's timers
    and profiler stubbed: the sweep's journal, checkpoints and analyses, no
    port kernel launched, the resume, the stacked point against its serial
    run and the step timing all run as on the card."""
    from tlie_tpu_torch import config as config_mod
    from tlie_tpu_torch.ops import LAUNCHES

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs)
    # the path records the wave's peak device memory (chip_smoke.kernel_sweep_path)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    tiny = copy.deepcopy(config_mod.MQAR_LIN_ATTENTION_FULL)
    tiny["dataset"].update(input_seq_length=64, num_kv_pairs=8, vocab_size=256)
    tiny["train"]["batch_size"] = 32
    tiny["model"].update(seq_len=64, vocab_size=256, output_dim=256, hidden_dim=32, state_dim=32,
                         max_pos_embed=64)
    monkeypatch.setattr(config_mod, "MQAR_LIN_ATTENTION_FULL", tiny)
    for name, value in (("SWEEP_STEPS", 4), ("SWEEP_EVAL_EVERY", 2), ("SWEEP_CHECK_STEPS", 2),
                        ("TRAIN_EXAMPLES", 256)):
        monkeypatch.setattr(cs, name, value)
    data = MQAR(input_seq_length=64, num_kv_pairs=8, vocab_size=256, num_train_examples=256,
                num_test_examples=96)
    test_x, test_y = data.split("test")
    launches = cs.sweep_path(torch.device("cpu"), test_x, test_y, data.split("train"),
                             ARTIFACT_FILES)
    assert set(launches) == set(LAUNCHES) and not any(launches.values())
