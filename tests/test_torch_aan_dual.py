"""The port's AAN retrieval (``tlie_tpu_torch/data/aan.py``) and the dual
(``MATCH``) heads of the transformer and the Mamba-2 against tlie_tpu on
the CPU: the synthetic pair corpus, its vocabulary and a pair TSV bit for
bit; each dual model's log-probs and every gradient with JAX's weights
carried by ``compat`` (round-tripped both ways, and through tlie_tpu's own
``torch_state_dict_to_flax``); the port's unpadded pair batch against
tlie_tpu's on its ``prep_batch``-padded one; eval_eig's spectra of a dual
checkpoint from the pair-folded analysis batch; ``launch`` end to end on a
cut of ``configs/tasks/aan/aan-transformer.yaml``; and a rehearsal of
``chip_smoke``'s path 27.

The models run at L 64, 2 layers: the transformer at d_model 16, 2 heads,
linear attention, the GLU mixer, the classifier MLP of 8; the Mamba-2 at
``LISTOPS_MAMBA2_FULL``'s layout with d_model 32, 2 heads, N 16, chunks of
16.  JAX runs jitted at HIGHEST matmul precision (tests/conftest.py), at
dropout 0.  Tolerances: arrays bit for bit, log-probs within 2e-5 of their
max, each gradient within 1e-4 of its leaf's max, the loss 1e-5 relative,
spectra 1e-5 relative, percentages 1e-5."""

import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.compat import torch_state_dict_to_flax
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.data import AAN as JaxAAN
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.steps import prep_batch as jax_prep_batch
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import AAN_TRANSFORMER_FULL, LISTOPS_MAMBA2_FULL
from tlie_tpu_torch.data import AAN, DATASETS
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import cross_entropy_loss, prep_batch, save_checkpoint, train_step
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
L = 64
OUT_RTOL_OF_MAX, GRAD_RTOL_OF_MAX, EIG_RTOL = 2e-5, 1e-4, 1e-5
# a Mamba-2 leaf that tlie_tpu's float32 itself misses the float64 gradient
# by more than GRAD_RTOL_OF_MAX (A_log, dt_bias: sums that cancel) is held to
# the float64 gradient within F64_FACTOR × tlie_tpu's error instead
# (tests/test_torch_mamba2_padded.py)
F64_FACTOR = 2.0


def pairs(n=6, seed=42):
    """(tokens (n, 2, L) int64, labels (n,)) of the synthetic corpus, and
    its vocabulary size."""
    data = AAN(synthetic=True, synthetic_train=n, synthetic_test=2, l_max=L, seed=seed)
    x, y = data.split("train")
    return x, y, data.vocab_size


def dual_config(family: str, vocab_size: int):
    if family == "transformer":
        return dict(AAN_TRANSFORMER_FULL["model"], num_layers=2, hidden_dim=16, state_dim=16,
                    num_heads=2, mixer_dim=8, max_pos_embed=L, seq_len=L, dropout=0.0,
                    vocab_size=vocab_size)
    return dict(LISTOPS_MAMBA2_FULL["model"], num_layers=2, hidden_dim=32, num_heads=2,
                state_dim=16, chunk_size=16, seq_len=L, dual=True, output_dim=2,
                vocab_size=vocab_size)


def _jax_model(model_cfg, x, seed=0):
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=False)
    return jeval, to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(seed), x)["params"])


def _port(model_cfg, params):
    model, eval_model, _ = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


# -- the data --------------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"append_bos": True}, {"append_eos": False, "seed": 3},
                                {"l_max": 4000}], ids=["eos", "bos_eos", "none", "l4000"])
def test_synthetic_pairs_and_vocabulary_equal_tlie_tpus(kw):
    """The pairs (cut to l_max less the specials where longer), the
    vocabulary in its order, the pad id and the labels, bit for bit."""
    cfg = dict(dict(synthetic=True, synthetic_train=6, synthetic_test=3, l_max=L), **kw)
    ours, theirs = AAN(**cfg), JaxAAN(_name_="aan", **cfg)
    ours.setup()
    theirs.setup()
    assert ours.vocab == theirs.vocab and list(ours.vocab) == list(theirs.vocab)
    assert ours.pad_id == theirs.pad_id and ours.vocab_size == theirs.vocab_size
    for name in ("train_inputs", "train_labels", "test_inputs", "test_labels"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype == np.int64 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ours.train_inputs.shape == (6, 2, cfg["l_max"]) and DATASETS["aan"] is AAN


def test_a_pairs_tsv_is_read_as_tlie_tpu_reads_it(tmp_path, capsys):
    """lra_release's layout (label, id1, id2, text1, text2) with characters
    past ASCII and a test character no train document has (``<unk>``), one
    document longer than l_max: the same arrays and vocabulary, no fallback
    line."""
    rows = {"train": [("1.0", "a", "b", "Über café — naïve", "café Über"),
                      ("0.0", "c", "d", "x" * 80, "plain text")],
            "test": [("1", "e", "f", "zeta ζ", "café")]}
    for split, lines in rows.items():
        (tmp_path / f"new_aan_pairs.{split}.tsv").write_text(
            "".join("\t".join(r) + "\n" for r in lines), encoding="utf-8")
    ours, theirs = AAN(data_dir=str(tmp_path), l_max=L), JaxAAN(data_dir=str(tmp_path), l_max=L)
    ours.setup()
    theirs.setup()
    assert ours.vocab == theirs.vocab and list(ours.vocab) == list(theirs.vocab)
    for name in ("train_inputs", "train_labels", "test_inputs", "test_labels"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    assert "synthetic" not in capsys.readouterr().out
    assert (ours.test_inputs == ours.vocab["<unk>"]).sum() == 2  # z and ζ


# -- the dual models ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["transformer", "mamba"])
def test_dual_log_probs_and_every_gradient_match_jax(family):
    """Six synthetic pairs through each dual model, JAX's weights carried by
    ``compat``: log-probs (6, 2) within 2e-5 of their max, the mean CE within
    1e-5 relative, every leaf's gradient (the MATCH head's among them)
    nonzero and within 1e-4 of its max; ``params_to_jax`` gives the flax tree back bit for bit
    and so does tlie_tpu's ``torch_state_dict_to_flax``."""
    x, y, vocab = pairs()
    model_cfg = dual_config(family, vocab)
    jeval, params = _jax_model(model_cfg, x.astype(np.int32))
    # MATCH's biases moved to 0.5, so its ReLUs are live on every pair: at
    # init the Mamba-2's 2 → 1 → 2 head often has its one middle unit dead,
    # and then no gradient reaches the backbone
    for layer in params["match"].values():
        layer["bias"] = np.full_like(layer["bias"], 0.5)

    def jloss(params):
        logits = jeval.apply({"params": params}, x.astype(np.int32))
        return jax_scan_loop.cross_entropy_loss(logits, y), logits

    (jl, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want = np.asarray(jax.nn.log_softmax(want))
    model, _ = _port(model_cfg, params)
    sd = model.state_dict()
    assert {f"match.{m}.{k}" for m in ("encoder", "middle", "decoder")
            for k in ("weight", "bias")} <= set(sd)
    mine, _ = params_to_jax(sd)
    theirs = torch_state_dict_to_flax(sd, family)
    for a, b, c in zip(jax.tree_util.tree_leaves_with_path(mine),
                       jax.tree_util.tree_leaves_with_path(theirs),
                       jax.tree_util.tree_leaves_with_path(params)):
        assert a[0] == b[0] == c[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[1])
    back = params_from_jax(mine)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)

    logits = model(torch.from_numpy(x))
    got = torch.log_softmax(logits, -1).detach().numpy()
    assert got.shape == want.shape == (6, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL_OF_MAX * np.abs(want).max())
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    grads, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    m64 = _port(model_cfg, params)[0].double()
    cross_entropy_loss(m64(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    f64, _ = params_to_jax({n: p.grad for n, p in m64.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(to_numpy(jgrads))
    assert len(jax.tree_util.tree_leaves(grads)) == len(leaves)
    for (path, g), (jpath, ref), g64 in zip(jax.tree_util.tree_leaves_with_path(grads), leaves,
                                           jax.tree_util.tree_leaves(f64)):
        assert path == jpath and np.abs(ref).max() > 0, path
        if np.abs(g - ref).max() > GRAD_RTOL_OF_MAX * np.abs(ref).max():
            jax_err = np.abs(ref - g64).max()
            assert jax_err > GRAD_RTOL_OF_MAX * np.abs(g64).max(), path
            assert np.abs(g - g64).max() <= F64_FACTOR * jax_err, path


@pytest.mark.parametrize("family", ["transformer", "mamba"])
def test_the_unpadded_pair_batch_gives_tlie_tpus_logits_on_its_padded_one(family):
    """tlie_tpu's ``prep_batch`` pads a (B, 2, L) pair batch along its pair
    axis to (B, seq_len, L); the port's leaves it (B, 2, L) as the loader
    gave it, and the dual model's logits on it equal tlie_tpu's on the
    padded batch within 2e-5 of their max."""
    x, y, vocab = pairs(4)
    model_cfg = dual_config(family, vocab)
    batch = (x.astype(np.int32), y, {"lengths": L})
    j_in, _ = jax_prep_batch(batch, model_cfg["seq_len"], model_cfg["input_dim"])
    assert j_in.shape == (4, L, L)  # the pair axis padded to seq_len
    jeval, params = _jax_model(model_cfg, x.astype(np.int32))
    want = np.asarray(jax.jit(jeval.apply)({"params": params}, j_in))
    inputs, labels = prep_batch(batch, model_cfg["seq_len"], model_cfg["input_dim"],
                                device="cpu")
    assert inputs.shape == (4, 2, L) and torch.equal(inputs, torch.from_numpy(x).int())
    _, eval_model = _port(model_cfg, params)
    with torch.no_grad():
        got = eval_model(inputs.long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL_OF_MAX * np.abs(want).max())
    assert torch.equal(labels, torch.from_numpy(y))


@pytest.mark.parametrize("family", ["transformer", "mamba"])
def test_eval_eig_of_a_dual_checkpoint_matches_tlie_tpu(family, tmp_path):
    """From one port checkpoint (the dual model after two steps on six
    pairs), both packages write the same 12 artifacts under the same name
    from 3 test pairs: tlie_tpu pads them along the pair axis and folds rows
    0 and 1, the port folds the pairs it is given.  The spectra have 6
    document rows (η (6, 63, 2, 2), λ (6, 64, 2, 2)), within 1e-5
    relative, the percentages within 1e-5, the live model's the same."""
    x, y, vocab = pairs()
    model_cfg = dual_config(family, vocab)
    args = copy.deepcopy(AAN_TRANSFORMER_FULL)
    args["model"] = model_cfg
    model, _, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(2),
                               device="cpu")
    opt, clip = make_family_optimizer(model, family, model_cfg, args["train"],
                                      {"lr": 0.002, "wd": 0.01, "betas": (0.9, 0.999)})
    for _ in range(2):
        train_step(model, opt, torch.from_numpy(x), torch.from_numpy(y), {"regular": 0.002},
                   None, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    tx, ty, _ = pairs(3, seed=43)
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=tx)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(tx.astype(np.int32), ty, {"lengths": L})], ckpt, 0.5,
                           params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and pdir.startswith("AANdmodel")
    assert sorted(os.listdir(tmp_path / "port" / pdir)) == sorted(
        os.listdir(tmp_path / "jax" / jdir)) == ARTIFACT_FILES
    eig = port_out[0]
    assert eig.shape == (6, L - 1 if family == "transformer" else L, 2, 2)
    assert eig.dtype == np.float32 and np.all(eig > 0)
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=EIG_RTOL, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    with torch.no_grad():
        live = extract_attention_family(model.eval(), torch.from_numpy(tx), model_cfg)
    np.testing.assert_array_equal(live, eig)


# -- launch ------------------------------------------------------------------------------------

def test_launch_trains_and_analyses_aan_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on ``aan-transformer.yaml`` cut to l_max 64, 2 layers,
    d_model 16, 2 heads, the classifier MLP of 8, 1 epoch of 4 steps (batch 4
    of 16 synthetic pairs), analysis batch 4 pairs: the pairs train through
    the MATCH head, the checkpoint and the 12 artifacts are written, η (8,
    63, 2, 2) positive on the 8 folded documents."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / "aan" / "aan-transformer.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / "aan-transformer")
    cfg["dataset"].update(l_max=L, synthetic_train=16, synthetic_test=8)
    cfg["train"].update(num_epochs=1, batch_size=4, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=16, num_heads=2, mixer_dim=8,
                        max_pos_embed=L)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 4, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "AAN | vocab size" in out and "step 4:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith("AANdmodel16")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, L - 1, 2, 2) and np.all(eig > 0) and np.isfinite(eig).all()


# -- the card run's path 27, rehearsed ---------------------------------------------------------

def test_chip_smoke_path_27_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.aan_path`` with the AAN transformer at l_max 256, 2
    layers, d_model 16, 2 heads, and the dual Mamba-2 at 2 layers, d_model
    16, 2 heads, N 8, chunks of 128 on documents cut to 128 tokens; 16 + 8
    pairs at batch 4 (4 steps an epoch; the Mamba-2 on 8 pairs, 2 steps),
    analysis batch 2 pairs, the Mamba-2's weights from seed 1 (where this
    small model's MATCH units are live, as 7 is for the card's); the card's
    timers and profiler stubbed and every kernel replaced by a counting
    plain version: no kernel launches on the transformer, 2 + 2 + 2 a step
    on the Mamba-2 (exact inside the path)."""
    import tlie_tpu_torch.config as config

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True, scan_kernels=True)
    for name, value in (("AAN_TRAIN", 16), ("AAN_TEST", 8), ("AAN_ANALYSIS_BATCH", 2),
                        ("AAN_MAMBA_TRAIN", 8), ("AAN_MAMBA_L", 128), ("CIFAR_STEP_EXAMPLES", 2),
                        ("CIFAR_STEP_CHUNK", 128), ("AAN_MAMBA_SEED", 1)):
        monkeypatch.setattr(cs, name, value)
    tf = copy.deepcopy(AAN_TRANSFORMER_FULL)
    tf["dataset"]["l_max"] = 256
    tf["train"].update(batch_size=4, train_size=16)
    tf["model"].update(num_layers=2, hidden_dim=16, state_dim=16, num_heads=2, mixer_dim=8,
                       max_pos_embed=256, seq_len=256)
    mamba = copy.deepcopy(LISTOPS_MAMBA2_FULL)
    mamba["model"].update(num_layers=2, hidden_dim=16, num_heads=2, state_dim=8, chunk_size=128)
    monkeypatch.setattr(config, "AAN_TRANSFORMER_FULL", tf)
    monkeypatch.setattr(config, "LISTOPS_MAMBA2_FULL", mamba)
    out = cs.aan_path(torch.device("cpu"), ARTIFACT_FILES, torch.zeros(4))
    assert set(out) == {"aan_transformer", "aan_mamba2_dual"}
    assert not any(out["aan_transformer"].values())
    m = out["aan_mamba2_dual"]
    # training alone is held exactly inside the path: 2 steps, 1 eval of 2 batches
    assert m["decay_attention_bwd_i"] == m["decay_attention_bwd_j"] == 2 * 2
    assert not any(v for k, v in m.items() if not k.startswith("decay_attention_")
                   or k.endswith("_bf16"))
