"""The port's Mamba-2 on padded input against tlie_tpu's on the CPU: the
ListOps and IMDB configs' classifier on ``(tokens, lengths)`` from the
ListOps fixture (``tests/fixtures/listops``), its logits and every gradient
through the pooled loss under each pooling (the pool runs over the padding,
as in tlie_tpu), the lengths changing nothing, eval_eig's artifacts of a
padded checkpoint on the analysis batch's tokens, ``launch`` end to end on
the CPU for a tiny IMDB and ListOps Mamba-2, and a rehearsal of
``chip_smoke``'s paths 24 and 25.

The model is the config's at 2 layers, d_model 32, 2 heads of 16, N 16 and
chunks of 16 over L 64 (four chunks: the SSD's inter-chunk arm).  JAX runs
jitted at HIGHEST matmul precision (tests/conftest.py).  Tolerances: logits
within 2e-5 of their max, each gradient within 1e-4 of its leaf's max (a
leaf that tlie_tpu's float32 itself misses by more: see F64_FACTOR), the
loss 1e-5 relative, spectra 1e-5 relative, percentages 1e-5."""

import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.data import imdb as jax_imdb
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import IMDB_MAMBA2_FULL, LISTOPS_MAMBA2_FULL
from tlie_tpu_torch.data import ListOps
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D, HEADS, N, L, CHUNK = 32, 2, 16, 64, 16
OUT_RTOL_OF_MAX, GRAD_RTOL_OF_MAX, EIG_RTOL = 2e-5, 1e-4, 1e-5
# A_log and dt_bias are one number a head summed over every position through
# dcs = dcs_i + dcs_j, two sums that cancel: under the max pool their
# gradients fall to 1e-5 of their terms, and float32 misses the float64 value
# by 1e-2 of the leaf's max on both sides (tlie_tpu 1.83e-7, the port 1.85e-7
# on blocks_0's A_log, the two 4e-9 apart).  Such a leaf is held to the
# float64 gradient within F64_FACTOR times tlie_tpu's own error instead (the
# card run's GRAD_F64_FACTOR rule, tighter)
F64_FACTOR = 2.0


def small(full=LISTOPS_MAMBA2_FULL, **over):
    return dict(full["model"], num_layers=2, hidden_dim=D, num_heads=HEADS, state_dim=N,
                seq_len=L, chunk_size=CHUNK, **over)


def fixture_batch(split="train"):
    """The ListOps fixture's tokens (n, 64) int64, labels and float32
    lengths, padded with <pad> (0) past each row's length."""
    x, y, lengths = ListOps(data_dir="tests/fixtures/listops", l_max=L).split(split)
    return x, y, lengths.astype(np.float32)


def _jax_model(model_cfg, inputs):
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=True)
    return jeval, to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), inputs)["params"])


def _port(model_cfg, params):
    model, eval_model, family = build_models(model_cfg, True, generator=torch.Generator(),
                                             device="cpu")
    assert family == "mamba"
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


@pytest.mark.parametrize("full", [LISTOPS_MAMBA2_FULL, IMDB_MAMBA2_FULL],
                         ids=["listops", "imdb"])
@pytest.mark.parametrize("pooling", ["mean", "max", "last"])
def test_padded_logits_and_every_gradient_match_jax(pooling, full):
    """The 8 fixture rows (lengths 7-33 of 64) as ``(tokens, lengths)``:
    the logits equal those of the tokens alone bit for bit (the lengths are
    dropped, on both sides), within 2e-5 of tlie_tpu's max; the mean CE
    within 1e-5 relative, every leaf's gradient within 1e-4 of its max, or
    where tlie_tpu's float32 misses the float64 gradient by more than that,
    within F64_FACTOR × its error of the float64 gradient.
    ``last`` pools the last position, which is padding for every row: the
    reference's unmasked pool, kept."""
    model_cfg = small(full, pooling=pooling)
    x, y, lengths = fixture_batch()
    y = y % model_cfg["output_dim"]
    assert lengths.max() < L
    jeval, params = _jax_model(model_cfg, (x, lengths))

    def jloss(params):
        logits = jeval.apply({"params": params}, (x, lengths))
        return jax_scan_loop.cross_entropy_loss(logits, y), logits

    (jl, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want = np.asarray(want)
    japply = jax.jit(jeval.apply)
    np.testing.assert_array_equal(np.asarray(japply({"params": params}, x)),
                                  np.asarray(japply({"params": params}, (x, lengths))))
    model, eval_model = _port(model_cfg, params)
    tokens = torch.from_numpy(x)
    with torch.no_grad():
        plain = eval_model(tokens)
        torch.testing.assert_close(eval_model.features((tokens, torch.from_numpy(lengths))),
                                   eval_model.features(tokens), rtol=0, atol=0)
    logits = model((tokens, torch.from_numpy(lengths)))
    assert logits.shape == want.shape == (len(y), model_cfg["output_dim"])
    torch.testing.assert_close(logits.detach(), plain, rtol=0, atol=0)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=OUT_RTOL_OF_MAX * np.abs(want).max())
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(to_numpy(jgrads))
    assert len(jax.tree_util.tree_leaves(got)) == len(leaves)
    m64 = _port(model_cfg, params)[0].double()
    cross_entropy_loss(m64((tokens, torch.from_numpy(lengths))), torch.from_numpy(y)).backward()
    f64, _ = params_to_jax({n: p.grad for n, p in m64.named_parameters()})
    f64_leaves = jax.tree_util.tree_leaves(f64)
    for (path, g), (jpath, ref), g64 in zip(jax.tree_util.tree_leaves_with_path(got), leaves,
                                           f64_leaves):
        assert path == jpath
        if np.abs(g - ref).max() > GRAD_RTOL_OF_MAX * np.abs(ref).max():
            # a leaf tlie_tpu's float32 cannot resolve to that band either:
            # held to the float64 gradient within F64_FACTOR × tlie_tpu's error
            jax_err = np.abs(ref - g64).max()
            assert jax_err > GRAD_RTOL_OF_MAX * np.abs(g64).max(), path
            assert np.abs(g - g64).max() <= F64_FACTOR * jax_err, path


def test_eval_eig_artifacts_of_a_padded_mamba2_match_tlie_tpu(tmp_path):
    """From one port checkpoint (the small ListOps Mamba-2 after two steps
    on the padded fixture rows), both packages write the same 12 artifacts
    under the same name from the 4 test rows: tlie_tpu's loader batch
    carries the lengths and its ``prep_batch(..., lang_model=True)`` drops
    them, the port takes the tokens, as ``launch`` hands them.  λ (4, 64, 2,
    2) within 1e-5 relative and in (0, 1], the percentages within 1e-5, the
    report's trained lines equal, λ from the live model equal."""
    model_cfg = small()
    args = copy.deepcopy(LISTOPS_MAMBA2_FULL)
    args["model"] = model_cfg
    x, y, lengths = fixture_batch()
    model, _, _ = build_models(model_cfg, True, generator=torch.Generator().manual_seed(2),
                               device="cpu")
    opt, clip = make_family_optimizer(model, "mamba", model_cfg, args["train"],
                                      {"lr": 0.05, "wd": 0.01, "betas": (0.9, 0.999)})
    for _ in range(2):
        train_step(model, opt, (torch.from_numpy(x), torch.from_numpy(lengths)),
                   torch.from_numpy(y), {"regular": 0.05}, None, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    tx, ty, tl = fixture_batch("test")
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=tx)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(tx.astype(np.int32), ty, {"lengths": tl})], ckpt, 0.5,
                           params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and pdir.startswith(f"LISTOPSdmodel{D}")
    assert sorted(os.listdir(tmp_path / "port" / pdir)) == sorted(
        os.listdir(tmp_path / "jax" / jdir)) == ARTIFACT_FILES
    eig, eig_init = port_out[0], port_out[1]
    assert eig.shape == eig_init.shape == (len(tx), L, HEADS, 2) and eig.dtype == np.float32
    assert np.all((eig > 0) & (eig <= 1)) and np.all((eig_init > 0) & (eig_init <= 1))
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=EIG_RTOL, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    with torch.no_grad():
        live = extract_attention_family(model.eval(), torch.from_numpy(tx), model_cfg)
    np.testing.assert_array_equal(live, eig)


@pytest.mark.parametrize("name", ["imdb-mamba2", "listops-mamba2"])
def test_launch_trains_and_analyses_a_padded_mamba2_on_the_cpu(tmp_path, monkeypatch, capsys,
                                                               name):
    """``launch.main`` on the YAML cut to 2 layers, d_model 32, 2 heads, N
    16, chunks of 16, 1 epoch of 4 steps at batch 6: IMDB on the synthetic
    char corpus (24 / 12 reviews, l_max 256, min_freq 1; with no files the
    loader prints tlie_tpu's line), ListOps on the fixture's TSVs (l_max
    64); the padded splits train, the checkpoint and the 12 artifacts are
    written, λ in (0, 1] on the analysis batch's tokens."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / name.split("-")[0] /
                          f"{name}.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / name)
    if name.startswith("imdb"):
        l_max = 256
        cfg["dataset"].update(l_max=l_max, synthetic_train=24, synthetic_test=12, min_freq=1,
                              data_dir=str(tmp_path / "none"))
    else:
        l_max = L
        cfg["dataset"].update(l_max=l_max, data_dir=str(ROOT / "tests" / "fixtures" / "listops"))
    cfg["train"].update(num_epochs=1, batch_size=6 if name.startswith("imdb") else 2, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=D, num_heads=HEADS, state_dim=N,
                        chunk_size=CHUNK)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 4, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 4:" in out and "Finished!" in out
    if name.startswith("imdb"):
        assert "downloads are disabled" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith(f"{cfg['dataset']['name']}dmodel{D}")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (4, l_max, HEADS, 2) and np.all((eig > 0) & (eig <= 1))


# -- the card run's paths 24 and 25, rehearsed ----------------------------------------------

@pytest.mark.parametrize("tag,full", [("listops_mamba2", LISTOPS_MAMBA2_FULL),
                                      ("imdb_mamba2", IMDB_MAMBA2_FULL)])
def test_chip_smoke_paths_24_and_25_run_on_the_cpu(monkeypatch, tmp_path, tag, full):
    """``chip_smoke.classifier_path`` on the padded splits of
    ``chip_smoke.lra_mamba2_splits`` at 2 layers, d_model 16, 2 heads, N 8,
    L 256 and chunks of 128 (ListOps generated natively, 16 + 8 examples;
    IMDB's synthetic corpus, 16 + 8 reviews), batch 4, 2 epochs of 4 steps,
    the card's timers and profiler stubbed and the decay attention's kernels
    replaced by counting plain versions: 2 + 2 + 2 launches a training
    step, exact inside the path; the chunk-256 forward, the spectra, the
    kernels at the trained weights, the card step against float64 and the
    timing all run; nothing is written under ``data_dir``."""
    monkeypatch.setattr(jax_imdb, "_load_hf_imdb", lambda data_dir: None)
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True)
    for name, value in (("LISTOPS_TRAIN", 16), ("LISTOPS_TEST", 8), ("IMDB_TRAIN", 16),
                        ("IMDB_TEST", 8), ("CIFAR_STEP_CHUNK", 128)):
        monkeypatch.setattr(cs, name, value)
    cut = copy.deepcopy(full)
    seq = 256
    if tag.startswith("listops"):
        cut["dataset"].update(l_max=seq, min_length=50, max_length=seq - 1,
                              data_dir=str(tmp_path))
    else:
        cut["dataset"].update(l_max=seq, min_freq=1, data_dir=str(tmp_path))
    cut["train"].update(batch_size=4, train_size=16)
    cut["model"].update(num_layers=2, hidden_dim=16, state_dim=8, num_heads=2, seq_len=seq,
                        chunk_size=128)
    splits = cs.lra_mamba2_splits(cut, tag)
    assert len(splits[0]) == 3 and splits[0][0].shape == (16, seq)
    launches = cs.classifier_path(torch.device("cpu"), ARTIFACT_FILES, cut, tag, splits, 2, 4, 2,
                                  torch.zeros(4))
    # training alone is held exactly inside the path: 8 steps, 2 evals of 2 batches
    assert launches["decay_attention_bwd_j"] == launches["decay_attention_bwd_i"] == 2 * 8
    assert launches["decay_attention_fwd"] > 2 * (8 + 2 * 2)
    assert not any(v for k, v in launches.items() if not k.startswith("decay_attention_")
                   or k.endswith("_bf16"))
    assert os.listdir(tmp_path) == []
