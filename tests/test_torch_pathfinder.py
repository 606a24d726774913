"""The port's PathFinder (``tlie_tpu_torch/data/pathfinder.py``) and its S4
classifier against tlie_tpu on the CPU: the synthetic connected-path split
and the lra_release PNG tree (``tests/fixtures/pathfinder``, read with
PIL) bit for bit, the fallback without PIL, the config's S4 logits on
float pixels, ``launch`` end to end on a cut of
``configs/tasks/pathfinder/pathfinder-s4.yaml``, and a rehearsal of
``chip_smoke``'s path 26.

Models run at 2 layers, d_model 16, state 8; JAX runs jitted at HIGHEST
matmul precision (tests/conftest.py).  Tolerances: arrays bit for bit,
logits within 2e-5 of their max (S4 at every Δ ≥ 0.002, where tlie_tpu
keeps its Nyquist frequency: tests/test_torch_s4.py)."""

import builtins
import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.data import PathFinder as JaxPathFinder
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.config import PATHFINDER_S4_FULL
from tlie_tpu_torch.data import DATASETS, PathFinder
from tlie_tpu_torch.models import build_models
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "pathfinder"
DT_KEPT = 0.002


def _both(**cfg):
    """The port's and tlie_tpu's loaders built from the same keys."""
    ours = PathFinder(**cfg)
    ours.setup()
    theirs = JaxPathFinder(_name_="pathfinder", **cfg)
    theirs.setup()
    return ours, theirs


def _assert_same_splits(ours, theirs):
    for name in ("train_inputs", "train_labels", "test_inputs", "test_labels"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("seed", [42, 7])
def test_synthetic_split_equals_tlie_tpus_bit_for_bit(seed, center):
    ours, theirs = _both(synthetic=True, synthetic_train=24, synthetic_test=8, seed=seed,
                         center=center)
    _assert_same_splits(ours, theirs)
    x, y = ours.split("train")
    assert x.shape == (24, 1024, 1) and x.dtype == np.float32 and set(np.unique(y)) == {0, 1}
    assert ours.l_max == 1024 and ours.d_output == 2 and ours.d_input == 1
    assert DATASETS["pathfinder"] is PathFinder


def test_lra_release_pngs_read_as_tlie_tpu_reads_them(capsys):
    """The fixture's four PNGs through PIL, split by the seed's permutation:
    the same pixels and labels, no fallback line."""
    pytest.importorskip("PIL")
    ours, theirs = _both(data_dir=str(FIXTURE), test_split=0.25, seed=3, center=False)
    _assert_same_splits(ours, theirs)
    assert ours.train_inputs.shape == (3, 1024, 1) and ours.test_inputs.shape == (1, 1024, 1)
    assert "synthetic" not in capsys.readouterr().out


def test_without_pil_or_files_the_synthetic_split_stands_in(monkeypatch, tmp_path, capsys):
    """Where PIL cannot be imported the tree is not read (the card machine
    has no PIL), and where no tree is there the loader prints tlie_tpu's
    line; both give the synthetic split."""
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    from tlie_tpu_torch.data.pathfinder import read_lra_pathfinder

    assert read_lra_pathfinder(FIXTURE, 32) is None
    kw = dict(synthetic_train=8, synthetic_test=4)
    no_pil_split = PathFinder(data_dir=str(FIXTURE), **kw).split("train")
    monkeypatch.setattr(builtins, "__import__", real_import)
    no_tree_split = PathFinder(data_dir=str(tmp_path), **kw).split("train")
    synthetic = PathFinder(synthetic=True, **kw).split("train")
    out = capsys.readouterr().out
    assert out.count("using the synthetic connected-path generator") == 2
    for split in (no_pil_split, no_tree_split):
        np.testing.assert_array_equal(split[0], synthetic[0])
        np.testing.assert_array_equal(split[1], synthetic[1])


def test_pathfinder_s4_logits_match_jax():
    """The config's S4 at 2 layers, d_model 16, state 8 in eval mode on 3
    synthetic images of 1,024 centred pixels, JAX's weights (BatchNorm
    statistics moved off their init) carried by ``compat``: logits within
    2e-5 of their max."""
    cfg = dict(PATHFINDER_S4_FULL["model"], num_layers=2, hidden_dim=16, state_dim=8)
    x = PathFinder(synthetic=True, synthetic_train=3, synthetic_test=3).split("test")[0]
    _, jeval, _ = jax_build_models(dict(cfg), padded=False)
    variables = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), x[:1]))
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(1)
    for key, layer in params["encoder"].items():
        if key.startswith("layers_"):
            layer["seq"]["log_step"] = np.maximum(layer["seq"]["log_step"],
                                                  np.log(DT_KEPT)).astype(np.float32)
    for layer in stats["encoder"].values():
        st = layer["normalize"]
        st["mean"] = rng.normal(0.0, 0.3, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    want = np.asarray(jax.jit(jeval.apply)({"params": params, "batch_stats": stats}, x))
    _, model, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_launch_trains_and_analyses_pathfinder_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on ``pathfinder-s4.yaml`` cut to 2 layers, d_model 16,
    state 8, 1 epoch of 4 steps (batch 8 of 32 synthetic images): the
    checkpoint and the 12 artifacts are written, the (8, 2) spectra finite
    and inside the unit disc."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / "pathfinder" /
                          "pathfinder-s4.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / "pathfinder-s4")
    cfg["dataset"].update(synthetic_train=32, synthetic_test=16)
    cfg["train"].update(num_epochs=1, batch_size=8, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=8)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 8, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PathFinder | res 32 | train 32 test 16" in out
    assert "step 4:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith("PathFinderdmodel16")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, 2) and np.isfinite(eig).all() and np.all(np.abs(eig) < 1)


def test_chip_smoke_path_26_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.synthetic_splits`` and ``classifier_path`` on
    ``PATHFINDER_S4_FULL`` at 2 layers, d_model 16, state 8, 16 + 8
    synthetic images at batch 4 (2 epochs of 4 steps), the card's timers
    and profiler stubbed and every kernel replaced by a counting plain
    version: the forward, training, the spectra, the card step against
    float64 and the timing all run, and no kernel launches."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True, scan_kernels=True)
    monkeypatch.setattr(cs, "CIFAR_STEP_EXAMPLES", 2)
    cut = copy.deepcopy(PATHFINDER_S4_FULL)
    cut["train"].update(batch_size=4, train_size=16)
    cut["model"].update(num_layers=2, hidden_dim=16, state_dim=8)
    splits, data = cs.synthetic_splits(cut, "pathfinder_s4", 16, 8)
    assert splits[0][0].shape == (16, 1024, 1) and data.l_max == 1024
    launches = cs.classifier_path(torch.device("cpu"), ARTIFACT_FILES, cut, "pathfinder_s4",
                                  splits, 2, 4, 2, torch.zeros(4))
    assert not any(launches.values())
