"""Train → checkpoint → eval_eig in the port, held against tlie_tpu's
extractor and binning on the port's trained weights, and the launch entry
point.

The port trains the small MQAR LRU for a few dozen steps on the CPU and
writes its checkpoint; ``eval_eig`` reads the checkpoint back.  The trained
spectra and percentages must equal what ``tlie_tpu``'s own ``eval_eig``
gives for ``params_to_jax`` of the same ``state_dict`` within 1e-5 (the
BASELINE.json tolerance; both compute λ in float32 from the same ν, θ).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import checkpoint_name, derive_runtime_fields, load_yaml, train_fields
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import restore_checkpoint, train
from torch_parity import SMALL_YAML, jax_weights, small_config

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _short_config(save, steps=40, every=20, n_train=1024, n_test=128):
    cfg = load_yaml(ROOT / SMALL_YAML)
    cfg["save"] = str(save)
    cfg["train"].update(total_steps=steps, eval_every=every)
    cfg["dataset"].update(num_train_examples=n_train, num_test_examples=n_test)
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    cfg = _short_config(tmp / "ckpt" / "mqar-lru-small")
    data = MQAR(**cfg["dataset"])
    train_split, test_split = data.split("train"), data.split("test")
    cfg = derive_runtime_fields(cfg, data.l_max, len(train_split[0]))
    init, _, _ = build_models(cfg["model"], generator=torch.Generator().manual_seed(cfg["seed"]),
                              device="cpu")  # the weights train() starts from
    init = init.state_dict()
    result = train(cfg, train_split, test_split, device="cpu")
    return cfg, result, init, tmp


def test_train_writes_the_checkpoint_and_moves_every_parameter(trained):
    cfg, result, init, _ = trained
    path, perf = result
    assert path == os.path.abspath(checkpoint_name(cfg) + f"-perf{perf:0.3f}.pth")
    ckpt = restore_checkpoint(path)  # weights_only load
    assert set(ckpt["config"]) == {"model", "train", "data"}
    assert ckpt["config"]["train"]["total_steps"] == 40
    live = result.model.state_dict()
    assert set(ckpt["model"]) == set(live)
    for name, value in ckpt["model"].items():
        assert torch.equal(value, live[name]), name
        assert torch.isfinite(value).all(), name
        assert not torch.equal(value, init[name]), f"{name} did not move"
    assert 0.0 <= perf <= 1.0


def test_checkpoint_eval_eig_matches_jax(trained, tmp_path):
    cfg, result, _, _ = trained
    path, perf = result
    got = eval_eig(cfg, {"save_path": str(tmp_path / "port")}, perf, path, device="cpu")
    params, _ = params_to_jax(restore_checkpoint(path)["model"])
    want = jax_eval_eig(cfg, {"save_path": str(tmp_path / "jax")}, None, cfg["dataset"], None,
                        "unused", perf, params=params)
    for i in (0, 2, 4):  # eig, radius and phase percentages of the trained weights
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-5)
    (run,) = os.listdir(tmp_path / "port")
    np.testing.assert_allclose(np.load(tmp_path / "port" / run / "eig.npy"), want[0],
                               rtol=0, atol=1e-5)
    # the trained spectra are those of the live weights
    live = eval_eig(cfg, {"save_path": str(tmp_path / "live")}, perf, result.model, device="cpu")
    np.testing.assert_array_equal(live[0], got[0])


def test_params_to_jax_inverts_params_from_jax():
    cfg = small_config()["model"]
    _, params, stats = jax_weights(cfg, seed=3)
    sd = params_from_jax(params, stats)
    back_params, back_stats = params_to_jax(sd)
    flat = lambda t, p=(): [x for k, v in sorted(t.items())  # noqa: E731
                            for x in (flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)])]
    for a, b in ((params, back_params), (stats, back_stats)):
        fa, fb = flat(a), flat(b)
        assert [k for k, _ in fa] == [k for k, _ in fb]
        for (_, x), (_, y) in zip(fa, fb):
            assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)
    again = params_from_jax(back_params, back_stats)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def test_train_fields_refuse_what_is_not_ported():
    cfg = small_config()
    cfg["lang_model"] = True
    assert train_fields(cfg)["warmup"] == 60
    # tensor parallelism is ported: model_parallel is taken, with the sparse
    # and fused heads off, and a model group that does not divide the
    # vocabulary raises where the leaves are split
    tp = train_fields(dict(cfg, train=dict(cfg["train"], model_parallel=2)))
    assert tp["model_parallel"] == 2 and not tp["sparse_head"] and not tp["fused_xent"]
    assert train_fields(cfg)["model_parallel"] == 1
    from tlie_tpu_torch.parallel import Shard, shard_vocab_parallel

    model = build_models(cfg["model"], generator=torch.Generator(), device="cpu")[0]
    assert cfg["model"]["output_dim"] % 3
    with pytest.raises(ValueError, match="divisible by 3"):
        shard_vocab_parallel(model, Shard(0, 3, vocab=True))
    # sequence parallelism is ported: the LRU takes it where it divides the
    # length, and refuses it beside model_parallel or where it does not
    sp = dict(cfg, train=dict(cfg["train"], sequence_parallel=2))
    assert train_fields(sp)["sequence_parallel"] == 2
    assert train_fields(cfg)["sequence_parallel"] == 1
    for train_cfg in (dict(sp["train"], model_parallel=2),
                      dict(sp["train"], sequence_parallel=cfg["model"]["seq_len"] + 1)):
        with pytest.raises(ValueError, match="sequence_parallel"):
            train_fields(dict(cfg, train=train_cfg))
    # the fused head, resume snapshots and epoch-driven runs are ported: taken
    assert train_fields(dict(cfg, train=dict(cfg["train"], fused_xent=True)))["warmup"] == 60
    snap = train_fields(dict(cfg, train=dict(cfg["train"], checkpoint_every=100, resume=True)))
    assert snap["checkpoint_every"] == 100 and snap["resume"] is True
    bsz = cfg["train"]["batch_size"]
    epochs = dict(cfg, lang_model=False, dataset=dict(cfg["dataset"], _name_="cifar"),
                  train=dict(cfg["train"], num_epochs=3, warmup=1, train_size=10 * bsz + 1))
    f = train_fields(epochs)
    assert (f["eval_every"], f["total_steps"], f["warmup"]) == (10, 30, 10)


def test_launch_trains_and_analyses_on_the_cpu(tmp_path):
    cfg = _short_config("./checkpoint/mqar-lru-small", steps=10, every=5, n_train=256, n_test=64)
    (tmp_path / "small.yaml").write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "tlie_tpu_torch.launch", "--config", str(tmp_path / "small.yaml"),
         "--analysis_config", str(ROOT / "configs/analysis/mqar.yaml"), "--device", "cpu"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "step 10: train loss" in proc.stdout and "Finished!" in proc.stdout
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("mqar-lru-small-seed-1919-layers-2") and ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis_results")
    assert np.load(tmp_path / "analysis_results" / run / "eig.npy").shape == (64, 2)


def test_launch_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--config", SMALL_YAML])
    # the stacked sweep of the LRU (whose scan kernels it once refused) too
    # runs on the card unless asked for the CPU
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text(yaml.safe_dump({"base_config": str(ROOT / SMALL_YAML),
                                     "sweep": {"seed": [1919, 2222]}}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--config", str(sweep), "--sweep_parallel"])
