"""The port's Speech Commands (``tlie_tpu_torch/data/speechcommands.py``)
and its S5 classifier against tlie_tpu on the CPU: the synthetic keyword
corpus as raw waveforms, as MFCC frames, with the drop mask and over all
35 classes, bit for bit; the MFCC and the mel filterbank on the same
waveform; a Speech Commands wav tree written under ``tmp_path``; the
config's S5 logits on MFCC frames; ``launch`` end to end on a cut of
``configs/sc-s5-mfcc.yaml``; and a rehearsal of ``chip_smoke``'s path 28,
the scan kernels replaced by counting plain versions.

Models run at 2 layers, d_model 16, state 8 (S5: 2 blocks); JAX runs
jitted at HIGHEST matmul precision (tests/conftest.py).  Tolerances:
arrays bit for bit, logits within 2e-5 of their max."""

import copy
import os
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.data import SpeechCommands as JaxSpeechCommands
from tlie_tpu.data import speechcommands as jax_sc
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.config import SC_S5_MFCC_FULL
from tlie_tpu_torch.data import DATASETS, SpeechCommands
from tlie_tpu_torch.data import speechcommands as sc
from tlie_tpu_torch.models import build_models
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _both(**cfg):
    ours = SpeechCommands(**cfg)
    ours.setup()
    theirs = JaxSpeechCommands(_name_="sc", **cfg)
    theirs.setup()
    return ours, theirs


def _assert_same_splits(ours, theirs):
    for name in ("train_inputs", "train_labels", "test_inputs", "test_labels"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("d_input", "d_output", "l_max"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("kw", [
    {"mfcc": True},
    {"length": 2000},
    {"length": 1000, "dropped_rate": 0.2},
    {"mfcc": True, "dropped_rate": 0.1, "all_classes": True, "seed": 3},
], ids=["mfcc", "raw", "raw_dropped", "mfcc_dropped_35"])
def test_synthetic_corpus_equals_tlie_tpus_bit_for_bit(kw):
    ours, theirs = _both(synthetic=True, synthetic_train=12, synthetic_test=6, **kw)
    _assert_same_splits(ours, theirs)
    x, y = ours.split("test")
    d_in = (20 if kw.get("mfcc") else 1) + (1 if kw.get("dropped_rate") else 0)
    assert x.shape == (6, 161 if kw.get("mfcc") else kw["length"], d_in) and x.dtype == np.float32
    assert ours.d_output == (35 if kw.get("all_classes") else 10)
    assert DATASETS["sc"] is SpeechCommands


def test_mfcc_and_the_filterbank_equal_tlie_tpus():
    """One random waveform of 16,000 samples: 161 × 20 frames bit for bit,
    the filterbank (built once and kept) too, and the cut and the padding of
    ``fix_length``."""
    x = np.random.default_rng(0).normal(0, 0.3, 16000).astype(np.float32)
    got, want = sc.mfcc(x), jax_sc.mfcc(x)
    assert got.shape == (161, 20) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sc.mel_filterbank(64, 400, 16000),
                                  jax_sc._mel_filterbank(64, 400, 16000))
    assert sc.mel_filterbank(64, 400, 16000) is sc.mel_filterbank(64, 400, 16000)
    for n in (900, 1000, 1200):
        np.testing.assert_array_equal(sc.fix_length(x[:n], 1000), jax_sc._fix_length(x[:n], 1000))


def _write_tree(root: Path):
    """Three classes of three 16-bit clips of 600 samples (one of them
    stereo), the third of each listed for the test split."""
    rng = np.random.default_rng(0)
    listed = []
    for cls in sc.SC10[:3]:
        (root / cls).mkdir()
        for i in range(3):
            channels = 2 if (cls, i) == ("yes", 1) else 1
            x = (rng.normal(0, 0.2, 600 * channels) * 32767).astype("<i2")
            with wave.open(str(root / cls / f"u{i}.wav"), "wb") as w:
                w.setnchannels(channels)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(x.tobytes())
        listed.append(f"{cls}/u2.wav")
    (root / "testing_list.txt").write_text("\n".join(listed) + "\n")


@pytest.mark.parametrize("mfcc", [False, True], ids=["raw", "mfcc"])
def test_a_wav_tree_is_read_as_tlie_tpu_reads_it(tmp_path, mfcc, capsys):
    """The tree's train (u0, u1) and test (u2, from testing_list.txt) clips,
    padded from 600 to 800 samples (raw) or taken at 16,000 (MFCC): the
    same arrays, no fallback line."""
    _write_tree(tmp_path)
    kw = {"mfcc": True} if mfcc else {"length": 800}
    ours, theirs = _both(data_dir=str(tmp_path), **kw)
    _assert_same_splits(ours, theirs)
    assert ours.train_inputs.shape[0] == 6 and ours.test_inputs.shape[0] == 3
    assert sorted(np.unique(ours.test_labels)) == [0, 1, 2]
    assert "synthetic" not in capsys.readouterr().out
    np.testing.assert_array_equal(sc.read_wav(tmp_path / "yes" / "u1.wav"),
                                  jax_sc._read_wav(tmp_path / "yes" / "u1.wav"))


def test_sc_s5_logits_match_jax():
    """The config's S5 at 2 layers, d_model 16, state 8, 2 blocks in eval
    mode on 3 synthetic clips of 161 MFCC frames, JAX's weights (BatchNorm
    statistics moved off their init) carried by ``compat``: logits within
    2e-5 of their max."""
    cfg = dict(SC_S5_MFCC_FULL["model"], num_layers=2, hidden_dim=16, state_dim=8,
               num_blocks=2)
    x = SpeechCommands(mfcc=True, synthetic=True, synthetic_train=3,
                       synthetic_test=3).split("test")[0]
    _, jeval, _ = jax_build_models(dict(cfg), padded=False)
    variables = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), x[:1]))
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(1)
    for layer in stats["encoder"].values():
        st = layer["normalize"]
        st["mean"] = rng.normal(0.0, 0.3, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    want = np.asarray(jax.jit(jeval.apply)({"params": params, "batch_stats": stats}, x))
    _, model, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_launch_trains_and_analyses_speech_commands_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on ``sc-s5-mfcc.yaml`` cut to 2 layers, d_model 16,
    state 8, 2 blocks, 1 epoch of 4 steps (batch 8 of 32 synthetic clips):
    with no corpus it prints tlie_tpu's line; the checkpoint and the 12
    artifacts are written, the (4, 2) spectra inside the unit disc."""
    cfg = yaml.safe_load((ROOT / "configs" / "sc-s5-mfcc.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / "sc-s5-mfcc")
    cfg["dataset"].update(synthetic_train=32, synthetic_test=16)
    cfg["train"].update(num_epochs=1, batch_size=8, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=8, num_blocks=2)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 8, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "using the synthetic harmonic-keyword generator" in out
    assert "SpeechCommands | mfcc L=161 classes=10 | train 32 test 16" in out
    assert "step 4:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith("SCdmodel16")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (4, 2) and np.all(np.abs(eig) < 1)


def test_chip_smoke_path_28_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.synthetic_splits`` and ``classifier_path`` on
    ``SC_S5_MFCC_FULL`` at 2 layers, d_model 16, state 16 (P 8), 2 blocks,
    16 + 8 synthetic clips at batch 4 (2 epochs of 4 steps), the card's
    timers and profiler stubbed and the scan's kernels replaced by counting
    plain versions: 2 + 2 launches a training step (exact inside the
    path), the spectra, the card step against float64, the timing, and the
    scan phase at (4, 161, 8) against the plain versions and float64."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True, scan_kernels=True)
    monkeypatch.setattr(cs, "CIFAR_STEP_EXAMPLES", 2)
    cut = copy.deepcopy(SC_S5_MFCC_FULL)
    cut["train"].update(batch_size=4, train_size=16)
    cut["model"].update(num_layers=2, hidden_dim=16, state_dim=16, num_blocks=2)
    splits, data = cs.synthetic_splits(cut, "sc_s5", 16, 8)
    assert splits[0][0].shape == (16, 161, 20) and data.d_input == 20
    out = {}
    launches = cs.classifier_path(torch.device("cpu"), ARTIFACT_FILES, cut, "sc_s5", splits, 2,
                                  4, 2, torch.zeros(4), out=out)
    # training alone is held exactly inside the path: 8 steps, 2 evals of 2 batches
    assert launches["diag_scan_bwd"] == 2 * 8 and launches["diag_scan"] > 2 * (8 + 2 * 2)
    assert not any(v for k, v in launches.items() if not k.startswith("diag_scan"))
    times, errs = out["scan"]
    assert set(times) == {"diag_scan", "diag_scan_rev", "diag_scan_bwd"}
    assert set(errs) == {"fwd", "rev"}
