"""The port's epoch-driven training loop and its resume snapshots on the CPU:
``train_fields`` against ``tlie_tpu``'s cadence for every
``configs/tasks/listops/*.yaml`` (the LRU staying step-driven), the resolved
ListOps S5 and S4 configs against ``tlie_tpu.config``, and a small ListOps
run stopped at its snapshot and resumed (``train.resume``, ``launch
--resume``) against the run left alone: weights, optimiser state,
BatchNorm statistics and history bit for bit (dropout 0, as the configs
set it), the snapshot removed at the end."""

import copy
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.config import load_experiment
from tlie_tpu_torch import launch
from tlie_tpu_torch.config import (
    LISTOPS_S4_FULL, LISTOPS_S5_FULL, derive_runtime_fields, step_driven, train_fields,
)
from tlie_tpu_torch.data import ListOps
from tlie_tpu_torch.training import loop as loop_mod
from tlie_tpu_torch.training import restore_checkpoint, train

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
LISTOPS_YAMLS = sorted((ROOT / "configs" / "tasks" / "listops").glob("*.yaml"))
# the history's numbers that do not depend on the host's clock
RUN_KEYS = ("step", "train_loss", "test_loss", "test_perf")


class _Shape:
    """What derive_runtime_fields reads from a built ListOps dataset."""
    l_max = 2048
    train_inputs = range(96000)


def _resolved(path):
    exp = load_experiment(path)
    exp.derive_runtime_fields(_Shape())
    return exp.raw


@pytest.mark.parametrize("path", LISTOPS_YAMLS, ids=lambda p: p.stem)
def test_train_fields_give_tlie_tpus_cadence(path):
    """``tlie_tpu/training/loop.py:170-186`` on the resolved config: the
    epoch-driven families take train_size // batch_size steps an epoch,
    num_epochs of them, an eval each epoch and ``warmup`` epochs of warmup;
    the LRU is step-driven on ListOps and reads total_steps, which its
    config does not set, so both loops raise there."""
    cfg = _resolved(path)
    tc = cfg["train"]
    if cfg["model"]["layer"] == "lru":
        assert step_driven(cfg)
        with pytest.raises(KeyError, match="total_steps"):
            train_fields(cfg)
        return
    assert not step_driven(cfg)
    per_epoch = max(1, 96000 // tc["batch_size"])
    f = train_fields(cfg)
    assert (f["eval_every"], f["total_steps"], f["warmup"]) == (
        per_epoch, per_epoch * tc["num_epochs"], tc["warmup"] * per_epoch)
    assert f["checkpoint_every"] == tc.get("checkpoint_every") and f["resume"] is False
    if cfg["model"]["layer"] in ("s4", "s5"):
        assert (f["eval_every"], f["total_steps"], f["warmup"]) == (1920, 96000, 9600)
        assert f["plateau"] and f["lr_patience"] == 5 and f["reduce_factor"] == 0.5


@pytest.mark.parametrize("layer, full", [("s5", LISTOPS_S5_FULL), ("s4", LISTOPS_S4_FULL)])
def test_full_config_dicts_are_the_yamls_as_tlie_tpu_resolves_them(layer, full):
    assert full == _resolved(ROOT / f"configs/tasks/listops/listops-{layer}.yaml")


def _tiny(full, save, epochs=4, every=16):
    """``full`` cut to 2 layers, d_model and state 16, L 48, batch 8, on 64
    train and 16 test examples of 8-40 tokens: 8 steps an epoch, a snapshot
    every ``every`` steps."""
    cfg = copy.deepcopy(full)
    cfg["save"] = str(save)
    cfg["dataset"].update(l_max=48, min_length=8, max_length=40, num_train=64, num_test=16)
    cfg["train"].update(batch_size=8, num_epochs=epochs, warmup=1, checkpoint_every=every)
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=16)
    if cfg["model"]["layer"] == "s5":
        cfg["model"]["num_blocks"] = 2
    return cfg


def _splits(cfg, tmp_path):
    data = ListOps(**dict(cfg["dataset"], data_dir=str(tmp_path / "data")))
    return data.split("train"), data.split("test"), data.l_max


def _run(cfg, splits, kept=None, monkeypatch=None):
    """train() on the splits; with ``kept`` every snapshot is copied aside
    as it is written."""
    if kept is not None:
        save = loop_mod.save_resume

        def keep(path, model, optimizer, meta):
            out = save(path, model, optimizer, meta)
            shutil.copyfile(out, f"{out}.step{meta['step']}")
            kept.append((meta["step"], f"{out}.step{meta['step']}"))
            return out

        monkeypatch.setattr(loop_mod, "save_resume", keep)
    train_split, test_split, l_max = splits
    return train(derive_runtime_fields(cfg, l_max, len(train_split[0])), train_split,
                 test_split, device="cpu")


def _assert_same_run(got, want):
    for (k, a), (_, b) in zip(got.model.state_dict().items(), want.model.state_dict().items()):
        assert torch.equal(a, b), k  # parameters and BatchNorm statistics
    gs, ws = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert gs["param_groups"] == ws["param_groups"]
    for i, st in ws["state"].items():
        for k, v in st.items():
            assert torch.equal(gs["state"][i][k], v), (i, k)
    assert [{k: r[k] for k in RUN_KEYS} for r in got.history] == \
        [{k: r[k] for k in RUN_KEYS} for r in want.history]
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("full", [LISTOPS_S5_FULL, LISTOPS_S4_FULL], ids=["s5", "s4"])
def test_resumed_run_is_bitwise_the_uninterrupted_one(full, tmp_path, monkeypatch):
    """32 steps in 4 epochs with a snapshot every 16 steps: the snapshot at
    step 16 (the one at 32 is never written: the run ends there) put back
    and resumed gives the uninterrupted run's weights, Adam moments and
    step counts, BatchNorm statistics, eval lines and checkpoint, bit for
    bit; each run removes its snapshot when it completes."""
    cfg = _tiny(full, tmp_path / "ckpt" / "listops")
    splits = _splits(cfg, tmp_path)
    kept = []
    whole = _run(cfg, splits, kept, monkeypatch)
    snap = loop_mod.resume_path(cfg)
    assert [s for s, _ in kept] == [16] and not os.path.exists(snap)
    assert [r["step"] for r in whole.history] == [8, 16, 24, 32]
    monkeypatch.undo()

    shutil.copyfile(kept[0][1], snap)
    resumed = _run(dict(cfg, train=dict(cfg["train"], resume=True)), splits)
    assert not os.path.exists(snap)
    _assert_same_run(resumed, whole)
    ckpt = restore_checkpoint(resumed[0])["model"]
    assert all(torch.equal(ckpt[k], v) for k, v in whole.model.state_dict().items())


def test_snapshots_fire_at_epoch_ends_only(tmp_path, monkeypatch):
    """8 steps an epoch and ``checkpoint_every`` 20: the first snapshot
    waits for the epoch that passes 20 steps (24), the next for 48, as
    1,920-step epochs and 4,800 give 5,760 in the full configs."""
    cfg = _tiny(LISTOPS_S5_FULL, tmp_path / "ckpt" / "listops", epochs=7, every=20)
    kept = []
    _run(cfg, _splits(cfg, tmp_path), kept, monkeypatch)
    assert [s for s, _ in kept] == [24, 48]
    assert not os.path.exists(loop_mod.resume_path(cfg))


def test_snapshot_of_another_split_is_refused(tmp_path, monkeypatch):
    """The replayed batch-index stream must reach the snapshot's generator
    state: a snapshot taken on a split of another size raises."""
    cfg = _tiny(LISTOPS_S5_FULL, tmp_path / "ckpt" / "listops")
    kept = []
    _run(cfg, _splits(cfg, tmp_path), kept, monkeypatch)
    monkeypatch.undo()
    shutil.copyfile(kept[0][1], loop_mod.resume_path(cfg))
    other = copy.deepcopy(cfg)
    other["dataset"]["num_train"] = 72
    with pytest.raises(RuntimeError, match="batch-index stream"):
        _run(dict(other, train=dict(other["train"], resume=True)), _splits(other, tmp_path))


def test_resume_without_a_snapshot_trains_from_the_start(tmp_path):
    """``resume: true`` with no snapshot on disk is the plain run."""
    cfg = _tiny(LISTOPS_S5_FULL, tmp_path / "ckpt" / "listops", epochs=2)
    splits = _splits(cfg, tmp_path)
    plain = _run(cfg, splits)
    again = _run(dict(cfg, train=dict(cfg["train"], resume=True)), splits)
    _assert_same_run(again, plain)


def test_launch_resume_end_to_end(tmp_path, monkeypatch):
    """``python -m tlie_tpu_torch.launch --resume`` on a cut of
    ``listops-s5.yaml``: the run picks up at the snapshot left in place,
    ends with the uninterrupted run's checkpoint bit for bit, removes the
    snapshot, and writes eval_eig's artifacts only under the analysis
    config's save_path."""
    monkeypatch.chdir(tmp_path)
    cfg = _tiny(LISTOPS_S5_FULL, "./checkpoint/listops-s5")
    for key in ("padded", "train_size"):
        cfg["train"].pop(key)
    cfg.pop("lang_model")
    cfg["model"].pop("seq_len")
    cfg["dataset"]["data_dir"] = str(tmp_path / "data")
    (tmp_path / "run.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "analysis.yaml").write_text(yaml.safe_dump(
        {"batch_size": 32, "save_path": str(tmp_path / "analysis")}))
    kept = []
    whole = _run(cfg, _splits(cfg, tmp_path), kept, monkeypatch)
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    snap = loop_mod.resume_path(derive_runtime_fields(cfg, 48, 64))
    os.replace(kept[0][1], snap)
    (ckpt_name,) = set(os.listdir(tmp_path / "checkpoint")) - {os.path.basename(snap)}
    want = restore_checkpoint(str(tmp_path / "checkpoint" / ckpt_name))["model"]
    os.remove(tmp_path / "checkpoint" / ckpt_name)
    assert launch.main(["--config", "run.yaml", "--analysis_config", "analysis.yaml",
                        "--device", "cpu", "--resume"]) == 0
    assert os.listdir(tmp_path / "checkpoint") == [ckpt_name]
    got = restore_checkpoint(str(tmp_path / "checkpoint" / ckpt_name))["model"]
    assert all(torch.equal(got[k], v) for k, v in want.items())
    # nothing else written but the run logger's records (logs/<run name>.jsonl,
    # as tlie_tpu writes them): no cache of the generated split either
    assert sorted(os.listdir(tmp_path)) == ["analysis", "analysis.yaml", "checkpoint", "logs",
                                            "run.yaml"]
    assert all(name.endswith(".jsonl") for name in os.listdir(tmp_path / "logs"))
    (run,) = os.listdir(tmp_path / "analysis")
    assert np.load(tmp_path / "analysis" / run / "eig.npy").shape == (8, 2)
    assert whole.history[-1]["step"] == 32
