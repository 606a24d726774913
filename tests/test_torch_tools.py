"""The port's host-side tools against the root ones and ``tlie_tpu``'s: the
run logger's JSONL records (the same file name, keys and steps as
``tlie_tpu``'s for the same tiny run), a config's ``wandb`` section logged
locally, ``profile_trace`` writing a Chrome trace on the CPU,
``python -m tlie_tpu_torch.tools.run_truncated`` training, checkpointing and
eigen-analysing a cut of the bf16 WikiText LRU LM through the fused head on
the CPU, and ``python -m tlie_tpu_torch.tools.plot_spectra`` writing the
root tool's file names on ``tests/test_plot_spectra.py``'s artifacts."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu.data import SequenceDataset
from tlie_tpu.training import train as jax_train
from tlie_tpu_torch import launch
from tlie_tpu_torch.config import derive_runtime_fields, load_yaml
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.ops import fused_xent as fx
from tlie_tpu_torch.tools import plot_spectra, run_truncated
from tlie_tpu_torch.training import train
from tlie_tpu_torch.utils import RunLogger, StepTimer, annotate, profile_trace
from torch_parity import ARTIFACT_FILES

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LRU_YAML = ROOT / "configs" / "mqar-lru-small.yaml"
WT_LRU_YAML = ROOT / "configs" / "wikitext-lru-short.yaml"


def _tiny_lru(raw):
    """configs/mqar-lru-small.yaml cut to d 16 on 64 + 32 examples, 4 steps
    with an eval every 2."""
    raw["model"].update(hidden_dim=16, state_dim=16)
    raw["dataset"].update(num_train_examples=64, num_test_examples=32)
    raw["train"].update(total_steps=4, eval_every=2, batch_size=8)
    raw["save"] = None
    return raw


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_logger_records_match_tlie_tpus(tmp_path, monkeypatch):
    """The same tiny MQAR LRU run in both packages, each from its own
    ``tmp_path`` directory: the same ``logs/<run name>.jsonl`` file name
    (``tlie_tpu``'s run name), the same records in order (the parameter
    counts first, without a step, then each eval's at its step) with the
    same keys, and the same parameter counts."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    cfg = jax_load_experiment(LRU_YAML)
    _tiny_lru(cfg.raw)
    ds = SequenceDataset.registry["mqar"](**cfg.dataset)
    ds.setup()
    cfg.derive_runtime_fields(ds)
    bsz = cfg.train["batch_size"]
    jax_train(cfg, ds.train_dataloader(batch_size=bsz, shuffle=True),
              ds.test_dataloader(batch_size=bsz, shuffle=False), ds.get_metrics(layer="lru"), None)

    monkeypatch.chdir(tmp_path / "port")
    raw = _tiny_lru(load_yaml(LRU_YAML))
    data = MQAR(**raw["dataset"])
    tr, te = data.split("train"), data.split("test")
    train(derive_runtime_fields(raw, data.l_max, len(tr[0])), tr, te, device="cpu")

    (jname,) = os.listdir(tmp_path / "jax" / "logs")
    (pname,) = os.listdir(tmp_path / "port" / "logs")
    assert pname == jname and jname.startswith("lru-dmodel16-seed")
    want = _records(tmp_path / "jax" / "logs" / jname)
    got = _records(tmp_path / "port" / "logs" / pname)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [None, 2, 4]
    for key in ("params", "params without encoder"):
        assert got[0][key] == want[0][key]
    assert all(np.isfinite(r["train loss"]) and r["t"] > 0 for r in got[1:])


def test_a_wandb_section_logs_locally(tmp_path, monkeypatch, capsys):
    """``launch`` of a config with a ``wandb`` section trains: the section
    names the run (``tlie_tpu``'s run name), the records go to
    ``logs/<name>...jsonl``, and the run says that W&B is unavailable;
    ``finish`` closes the file, and the logger
    turns tensors into floats."""
    raw = _tiny_lru(load_yaml(LRU_YAML))
    raw["wandb"] = {"name": "tiny", "project": "p", "entity": "e"}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(raw))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(tmp_path / "tiny.yaml"), "--device", "cpu"]) == 0
    assert "[logging] W&B unavailable" in capsys.readouterr().out
    (name,) = os.listdir(tmp_path / "logs")
    assert name.startswith("tiny-dmodel16-seed") and name.endswith(".jsonl")
    assert [r["step"] for r in _records(tmp_path / "logs" / name)] == [None, 2, 4]
    log = RunLogger(None, "a/b", log_dir=str(tmp_path / "other"))
    log.log({"x": torch.tensor(2.5), "tag": "t"}, step=3)
    log.finish()
    (rec,) = _records(tmp_path / "other" / "a_b.jsonl")
    assert rec["x"] == 2.5 and rec["tag"] == "t" and rec["step"] == 3


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, capsys):
    """A traced region holding an ``annotate`` region and a small model
    step writes one Chrome trace into the directory, naming the region; a
    trace asked for inside a running one cannot start, says why, and lets
    its region run; ``StepTimer`` gives steps/s."""
    timer = StepTimer()
    lin = torch.nn.Linear(8, 8)
    with profile_trace(str(tmp_path)):
        with annotate("tiny_step"):
            lin(torch.ones(4, 8)).sum().backward()
        with profile_trace(str(tmp_path / "inner")):
            y = lin(torch.ones(2, 8))
    assert y.shape == (2, 8)
    (trace,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    events = json.loads((tmp_path / trace).read_text())["traceEvents"]
    assert any(e.get("name") == "tiny_step" for e in events)
    assert not (tmp_path / "inner").exists()
    assert "trace unavailable" in capsys.readouterr().out
    assert timer.first_window and timer.rate(10) > 0 and not timer.first_window


def test_launch_profile_traces_the_whole_run(tmp_path, monkeypatch):
    """``launch --profile DIR``, as the root launcher's flag: the run
    trains inside one trace, written into ``DIR`` as a Chrome trace that
    holds the training's ops."""
    raw = _tiny_lru(load_yaml(LRU_YAML))
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(raw))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(tmp_path / "tiny.yaml"), "--device", "cpu",
                        "--profile", str(tmp_path / "prof")]) == 0
    (trace,) = os.listdir(tmp_path / "prof")
    events = json.loads((tmp_path / "prof" / trace).read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_run_truncated_trains_checkpoints_and_analyses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``python -m tlie_tpu_torch.tools.run_truncated`` on a cut of
    ``configs/wikitext-lru-short.yaml`` in bf16 with the fused head (2
    layers of d 32, block 64, the full vocabulary of 50,257): ``--steps 4``
    trains four steps through the fused head (one eval), writes the
    checkpoint and eval_eig's artifacts of the trained weights
    (``--analysis_batch 2``) into ``--save_path``; ``--epochs`` and
    ``--train_examples`` set an epoch-driven config's budget; the
    parameters stay float32."""
    raw = load_yaml(WT_LRU_YAML)
    raw["model"].update(num_layers=2, hidden_dim=32, state_dim=32, compute_dtype="bfloat16")
    raw["dataset"].update(block_size=64, synthetic_train_tokens=64 * 12,
                          synthetic_test_tokens=64 * 4)
    raw["train"].update(batch_size=2, fused_xent=True)
    raw["save"] = str(tmp_path / "checkpoint" / "wt-lru")
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(raw))
    launches = []
    real = fx.FusedXentFn.apply
    monkeypatch.setattr(fx.FusedXentFn, "apply",
                        lambda h, w, b, labels: launches.append(h.dtype) or real(h, w, b, labels))
    monkeypatch.chdir(tmp_path)
    assert run_truncated.main(["--config", str(tmp_path / "tiny.yaml"), "--steps", "4",
                               "--analysis_batch", "2", "--save_path",
                               str(tmp_path / "analysis"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[truncated] ckpt" in out and out.count("step 4: train loss") == 1
    assert launches == [torch.bfloat16] * 4
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("wt-lru") and ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith("WikiText")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    assert np.load(tmp_path / "analysis" / run / "eig.npy").shape == (32, 2)

    # an epoch-driven config: the ListOps S5 on the repository's fixtures,
    # 2 epochs of train_examples // batch_size steps
    ep = load_yaml(ROOT / "configs" / "tasks" / "listops" / "listops-s5.yaml")
    ep["model"].update(hidden_dim=8, state_dim=8, num_blocks=1, num_layers=1)
    ep["dataset"].update(data_dir=str(ROOT / "tests" / "fixtures" / "listops"), l_max=32)
    ep["train"].update(batch_size=4)
    ep["train"].pop("checkpoint_every", None)
    ep["save"] = None
    result, arrays = run_truncated.run(ep, epochs=2, train_examples=8, device="cpu")
    assert arrays is None and [h["step"] for h in result.history] == [2, 4]
    assert all(p.dtype == torch.float32 for p in result.model.parameters())


def _attention_artifacts(d):
    rng = np.random.default_rng(0)
    bins, B, H, L = 7, 4, 2, 3
    for name, n in (("percentage", bins), ("percentage_init", bins), ("percentage_phase", 6),
                    ("percentage_phase_init", 6)):
        np.save(d / f"{name}.npy", rng.uniform(0, 100, (n, B, H, L)))


def _ssm_artifacts(d):
    rng = np.random.default_rng(1)
    bins, L, N = 7, 2, 16
    np.save(d / "percentage.npy", rng.uniform(0, 100, (bins, L)))
    np.save(d / "percentage_init.npy", rng.uniform(0, 100, (bins, L)))
    lam = (rng.normal(size=(N, L)) + 1j * rng.normal(size=(N, L))).astype(np.complex64)
    np.save(d / "eig.npy", lam)
    np.save(d / "eig_init.npy", 0.9 * lam)


@pytest.mark.parametrize("kind,extra", [("attention", []), ("attention", ["--phase"]),
                                        ("ssm", []), ("attention", ["--heads", "1", "--layers",
                                                                    "0", "2"])],
                         ids=["attention", "attention_phase", "ssm", "attention_subset"])
def test_plot_spectra_writes_the_root_tools_files(tmp_path, kind, extra):
    """On ``tests/test_plot_spectra.py``'s artifacts (attention (bins, B,
    H, layers) and SSM (bins, layers) with a complex ``eig.npy``), the
    port's tool and the root tool, each writing to its own ``--out``, write
    the same file names, every file a non-empty PNG."""
    art = tmp_path / "art"
    art.mkdir()
    (_attention_artifacts if kind == "attention" else _ssm_artifacts)(art)
    root = subprocess.run([sys.executable, str(ROOT / "tools" / "plot_spectra.py"), str(art),
                           "--out", str(tmp_path / "root"), *extra],
                          capture_output=True, text=True, timeout=300)
    assert root.returncode == 0, root.stderr[-2000:]
    assert plot_spectra.main([str(art), "--out", str(tmp_path / "port"), *extra]) == 0
    want = sorted(os.listdir(tmp_path / "root"))
    assert sorted(os.listdir(tmp_path / "port")) == want and want
    for name in want:
        data = (tmp_path / "port" / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
