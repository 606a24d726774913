"""Sequential CIFAR-10 (and MNIST) in the port against tlie_tpu on the CPU:
the loader's arrays bit for bit (grayscale and RGB, tokens, every
permutation, the augmentation pass with and without cutout, the synthetic
fallback and its printed line), the readers of the files torchvision reads
(CIFAR-10's pickled batches, MNIST's idx files) on files the tests write,
``put_dataset`` and ``prep_batch`` on a float split, the resolved CIFAR
configs, the S4, S5 and LRU classifiers' forward on a CIFAR batch, ``launch``
end to end, and a rehearsal of ``chip_smoke``'s paths 19-21.

Splits are the loader's synthetic images at a few per split; models run at
2 layers, d_model 16 and state 8 on the full 1,024 pixels.  JAX runs jitted
at HIGHEST matmul precision (tests/conftest.py).  Tolerances are stated
where they are used."""

import copy
import os
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu.data import cifar as jax_cifar
from tlie_tpu.data import permutations as jax_perm
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.steps import prep_batch as jax_prep_batch
from tlie_tpu_torch import launch
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.config import (
    CIFAR_LRU_FULL, CIFAR_MAMBA2_FULL, CIFAR_MAMBA2_LTI_FULL, CIFAR_S4_FULL, CIFAR_S5_FULL,
)
from tlie_tpu_torch.data import CIFAR10, DATASETS, MNIST
from tlie_tpu_torch.data import permutations as perm
from tlie_tpu_torch.data.cifar import read_cifar_batches, read_mnist_idx
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import prep_batch
from tlie_tpu_torch.training.scan_loop import gather_batch, put_dataset
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the ITU-R 601 weights and the normalisation are float32 numpy on both
# sides: the arrays are compared bit for bit
SMALL = {"synthetic": True, "synthetic_train": 12, "synthetic_test": 6, "seed": 3}


# -- the loader -------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("bitreversal", (1024,)), ("bitreversal", (64,)), ("transpose", (32, 32)),
    ("transpose", (4, 6)), ("snake", (32, 32)), ("snake", (5, 3)), ("hilbert", (32,)),
    ("hilbert", (8,))])
def test_permutations_equal_tlie_tpus(name, args):
    got = getattr(perm, f"{name}_permutation")(*args)
    want = getattr(jax_perm, f"{name}_permutation")(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(len(got)))  # a bijection


CIFAR_CASES = {
    "gray": {"grayscale": True},
    "rgb": {},
    "gray_tokens": {"grayscale": True, "tokenize": True},
    "gray_br": {"grayscale": True, "permute": "br"},
    "gray_snake": {"grayscale": True, "permute": "snake"},
    "gray_hilbert": {"grayscale": True, "permute": "hilbert"},
    "gray_transpose": {"grayscale": True, "permute": "transpose"},
    "rgb_hilbert": {"permute": "hilbert"},
    "rgb_transpose": {"permute": "transpose"},
    "tokens_snake": {"grayscale": True, "tokenize": True, "permute": "snake"},
    "gray_augment": {"grayscale": True, "augment": True},
    "gray_augment_cutout": {"grayscale": True, "augment": True, "cutout": True},
    "rgb_augment_cutout_br": {"augment": True, "cutout": True, "permute": "br"},
}


@pytest.mark.parametrize("case", sorted(CIFAR_CASES))
def test_cifar_arrays_equal_tlie_tpus_bit_for_bit(case):
    """Train and test inputs and labels, the same dtype, shape and bits;
    d_input, l_max and d_output as tlie_tpu's."""
    cfg = dict(SMALL, **CIFAR_CASES[case])
    ours = CIFAR10(_name_="cifar", **cfg)
    theirs = jax_cifar.CIFAR10(_name_="cifar", **cfg)
    theirs.setup()
    for split in ("train", "test"):
        x, y = ours.split(split)
        want_x, want_y = getattr(theirs, f"{split}_inputs"), getattr(theirs, f"{split}_labels")
        assert x.dtype == want_x.dtype and x.shape == want_x.shape
        np.testing.assert_array_equal(x, want_x)
        np.testing.assert_array_equal(y, want_y)
        assert y.dtype == np.int64
    assert (ours.d_input, ours.l_max, ours.d_output) == (theirs.d_input, theirs.l_max,
                                                         theirs.d_output)


def test_cifar_registers_and_its_defaults_are_tlie_tpus():
    assert DATASETS["cifar"] is CIFAR10 and DATASETS["mnist"] is MNIST
    assert CIFAR10(_name_="cifar").init_defaults == jax_cifar.CIFAR10(_name_="cifar").init_defaults
    assert MNIST(_name_="mnist").init_defaults == jax_cifar.MNIST(_name_="mnist").init_defaults
    with pytest.raises(ValueError):
        CIFAR10(_name_="mnist")


def test_mnist_arrays_equal_tlie_tpus_and_its_default_permute_raises_as_there():
    """Unpermuted MNIST bit for bit; the default ``permute: true`` asks for
    the bit-reversal of 784, no power of two, and both packages raise."""
    cfg = dict(SMALL, permute=False)
    ours, theirs = MNIST(**cfg), jax_cifar.MNIST(**cfg)
    theirs.setup()
    for split in ("train", "test"):
        x, y = ours.split(split)
        np.testing.assert_array_equal(x, getattr(theirs, f"{split}_inputs"))
        np.testing.assert_array_equal(y, getattr(theirs, f"{split}_labels"))
        assert x.shape[1:] == (784, 1) and x.dtype == np.float32
    with pytest.raises(AssertionError):
        MNIST(**SMALL).split("train")
    with pytest.raises(AssertionError):
        jax_cifar.MNIST(**SMALL).setup()


def _write_cifar_batches(root: Path, rng) -> tuple:
    """Two rows in each of the six pickled batches torchvision reads:
    (train rows, train labels, test rows, test labels) as written."""
    folder = root / "cifar-10-batches-py"
    folder.mkdir(parents=True)
    written = {}
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        rows = rng.integers(0, 256, (2, 3072), dtype=np.uint8)
        labels = [int(v) for v in rng.integers(0, 10, 2)]
        with open(folder / name, "wb") as f:
            pickle.dump({"batch_label": name, "data": rows, "labels": labels}, f)
        written[name] = (rows, labels)
    train = [written[f"data_batch_{i}"] for i in range(1, 6)]
    return (np.vstack([r for r, _ in train]), sum((lb for _, lb in train), []),
            written["test_batch"][0], written["test_batch"][1])


def _as_images(rows):
    """torchvision's CIFAR10.data layout, / 255 as tlie_tpu reads it."""
    return rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0


@pytest.mark.parametrize("grayscale", [True, False], ids=["gray", "rgb"])
def test_the_pickle_reader_reads_a_two_row_batch(tmp_path, grayscale, capsys):
    """The port reads the batches it is given (10 train rows, 2 test rows)
    as torchvision's ``.data`` / 255, and its sequences are tlie_tpu's
    ``_preprocess`` of those images bit for bit; no fallback line."""
    tr_rows, tr_y, te_rows, te_y = _write_cifar_batches(tmp_path, np.random.default_rng(0))
    tr_img, got_tr_y, te_img, got_te_y = read_cifar_batches(tmp_path)
    np.testing.assert_array_equal(tr_img, _as_images(tr_rows))
    np.testing.assert_array_equal(te_img, _as_images(te_rows))
    assert got_tr_y.tolist() == tr_y and got_te_y.tolist() == te_y
    data = CIFAR10(_name_="cifar", data_dir=str(tmp_path), grayscale=grayscale)
    x, y = data.split("train")
    assert "falling back" not in capsys.readouterr().out
    ref = jax_cifar.CIFAR10(_name_="cifar", grayscale=grayscale)
    np.testing.assert_array_equal(x, ref._preprocess(_as_images(tr_rows)))
    np.testing.assert_array_equal(data.split("test")[0], ref._preprocess(_as_images(te_rows)))
    assert y.tolist() == tr_y and x.shape == (10, 1024, 1 if grayscale else 3)
    os.remove(tmp_path / "cifar-10-batches-py" / "data_batch_3")
    assert read_cifar_batches(tmp_path) is None


def test_missing_files_fall_back_to_the_synthetic_split_with_tlie_tpus_line(tmp_path, capsys):
    """No CIFAR-10 files and ``synthetic`` unset: the line tlie_tpu prints,
    then the synthetic split, as with ``synthetic: true``."""
    cfg = {"_name_": "cifar", "data_dir": str(tmp_path), "grayscale": True,
           "synthetic_train": 12, "synthetic_test": 6}
    theirs = jax_cifar.CIFAR10(**cfg)
    theirs.setup()
    want = capsys.readouterr().out.splitlines()
    x, _ = CIFAR10(**cfg).split("train")
    got = capsys.readouterr().out.splitlines()
    assert got == want and got[0].startswith("CIFAR-10 | torchvision binaries not found")
    np.testing.assert_array_equal(x, theirs.train_inputs)
    np.testing.assert_array_equal(x, CIFAR10(**dict(cfg, synthetic=True)).split("train")[0])


def test_the_mnist_idx_reader(tmp_path):
    """MNIST's idx files (magic, big-endian dims, bytes) under MNIST/raw."""
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(1)
    arrays = {}
    for split, (img_name, lab_name) in (("train", ("train-images-idx3-ubyte",
                                                   "train-labels-idx1-ubyte")),
                                        ("test", ("t10k-images-idx3-ubyte",
                                                  "t10k-labels-idx1-ubyte"))):
        img = rng.integers(0, 256, (3, 28, 28), dtype=np.uint8)
        lab = rng.integers(0, 10, 3, dtype=np.uint8)
        (raw / img_name).write_bytes(bytes([0, 0, 8, 3]) + b"".join(
            d.to_bytes(4, "big") for d in img.shape) + img.tobytes())
        (raw / lab_name).write_bytes(bytes([0, 0, 8, 1]) + (3).to_bytes(4, "big") + lab.tobytes())
        arrays[split] = (img, lab)
    tr_x, tr_y, te_x, te_y = read_mnist_idx(tmp_path)
    np.testing.assert_array_equal(tr_x, arrays["train"][0].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(te_y, arrays["test"][1].astype(np.int64))
    x, y = MNIST(data_dir=str(tmp_path), permute=False).split("train")
    np.testing.assert_array_equal(x[..., 0], tr_x.reshape(3, 784))
    assert read_mnist_idx(tmp_path / "elsewhere") is None


# -- the data on the device ---------------------------------------------------------------

def test_put_dataset_takes_float_splits_and_prep_batch_passes_them_through():
    """A (n, 1024, 1) float split lives on the device as float32 (tokens as
    int64), labels int64; a gathered batch through ``prep_batch`` keeps its
    shape and values (no one-hot, no padding), as tlie_tpu's does; float
    labels raise."""
    data = CIFAR10(_name_="cifar", grayscale=True, **SMALL)
    x, y = data.split("train")
    dev = put_dataset(x, y, "cpu")
    assert dev.inputs.dtype == torch.float32 and dev.labels.dtype == torch.int64
    assert dev.lengths is None and tuple(dev.inputs.shape) == x.shape
    xb, yb = gather_batch(dev, torch.tensor([3, 0, 5]))
    np.testing.assert_array_equal(xb.numpy(), x[[3, 0, 5]])
    got, labels = prep_batch((xb.numpy(), yb.numpy(), {"lengths": 1024}), 1024, 1, device="cpu")
    want, _ = jax_prep_batch((x[[3, 0, 5]], y[[3, 0, 5]], {"lengths": 1024}), 1024, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1024, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(labels.numpy(), y[[3, 0, 5]])
    jdev = jax_scan_loop.put_dataset(x, y)
    np.testing.assert_array_equal(dev.inputs.numpy(), np.asarray(jdev.inputs))
    tokens = CIFAR10(_name_="cifar", grayscale=True, tokenize=True, **SMALL).split("train")
    assert put_dataset(*tokens, "cpu").inputs.dtype == torch.int64
    with pytest.raises(TypeError):
        put_dataset(x, y.astype(np.float32), "cpu")


# -- the configs --------------------------------------------------------------------------

@pytest.mark.parametrize("name,full", [
    ("cifar-mamba2", CIFAR_MAMBA2_FULL), ("cifar-mamba2-pseudoLTI", CIFAR_MAMBA2_LTI_FULL),
    ("cifar-s4", CIFAR_S4_FULL), ("cifar-s5", CIFAR_S5_FULL), ("cifar-lru", CIFAR_LRU_FULL)])
def test_full_config_dicts_are_the_yamls_as_tlie_tpu_resolves_them(name, full):
    """Each dict is its YAML after tlie_tpu's derive_runtime_fields with the
    CIFAR-10 dataset it names: l_max 1024 and the 2,048 images of the
    synthetic split, the one there is without the CIFAR-10 files."""
    exp = jax_load_experiment(ROOT / "configs" / "tasks" / "cifar" / f"{name}.yaml")
    data = jax_cifar.CIFAR10(**dict(exp.dataset, synthetic=True))

    class _Shape:
        l_max = data.l_max
        train_inputs = range(data.synthetic_train)

    exp.derive_runtime_fields(_Shape())
    assert full == exp.raw


# -- the SSM classifiers on a CIFAR batch ---------------------------------------------------

DT_KEPT = 0.002  # tlie_tpu's S4 keeps its Nyquist frequency from here up (test_torch_s4.py)


@pytest.mark.parametrize("full", [CIFAR_S4_FULL, CIFAR_S5_FULL, CIFAR_LRU_FULL],
                         ids=["s4", "s5", "lru"])
def test_ssm_classifier_forward_on_a_cifar_batch_matches_jax(full):
    """The eval-mode forward of the config at 2 layers, d_model 16, state 8
    (S5: 2 blocks) on 3 synthetic images of 1,024 pixels, JAX's weights
    (BatchNorm statistics moved off their init) carried by ``compat``:
    logits within 2e-5 of their max (S4 at every Δ ≥ 0.002)."""
    cfg = dict(full["model"], num_layers=2, hidden_dim=16, state_dim=8,
               **({"num_blocks": 2} if full["model"]["layer"] == "s5" else {}))
    x = CIFAR10(_name_="cifar", grayscale=True, **SMALL).split("test")[0][:3]
    _, jeval, _ = jax_build_models(dict(cfg), padded=False)
    variables = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), x[:1]))
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(1)
    for key, layer in params["encoder"].items():
        if key.startswith("layers_") and "log_step" in layer["seq"]:
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
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


# -- launch ------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cifar-mamba2", "cifar-s4"])
def test_launch_trains_and_analyses_cifar_on_the_cpu(tmp_path, monkeypatch, capsys, name):
    """``launch.main`` on the YAML cut to 2 layers, d_model 16, state 8 (the
    Mamba-2: 2 heads, chunks of 256), 1 epoch of 4 steps (batch 8 of 32
    images), analysis batch 8: with no
    CIFAR-10 files it prints tlie_tpu's fallback line and trains on the
    synthetic split; the checkpoint and the 12 artifacts are written, the
    spectra finite (the Mamba-2's (8, 1024, 2, 2) λ in (0, 1])."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / "cifar" / f"{name}.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / name)
    cfg["dataset"].update(synthetic_train=32, synthetic_test=16, data_dir=str(tmp_path / "none"))
    cfg["train"].update(num_epochs=1, batch_size=8, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=8)
    if name == "cifar-mamba2":
        cfg["model"].update(num_heads=2, chunk_size=256)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 8, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "torchvision binaries not found" in out and "step 4:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith("CIFAR-10dmodel16")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    if name == "cifar-mamba2":
        assert eig.shape == (8, 1024, 2, 2) and np.all((eig > 0) & (eig <= 1))
    else:
        assert eig.shape == (8, 2) and np.isfinite(eig).all()


# -- the card run's paths 19-21, rehearsed -------------------------------------------------

@pytest.mark.parametrize("tag,full", [("cifar_mamba2", CIFAR_MAMBA2_FULL),
                                      ("cifar_mamba2_lti", CIFAR_MAMBA2_LTI_FULL),
                                      ("cifar_s4", CIFAR_S4_FULL)])
def test_chip_smoke_paths_19_to_21_run_on_the_cpu(monkeypatch, tag, full):
    """``chip_smoke.cifar_path`` at 2 layers, d_model 16, state 8 (the
    Mamba-2: 2 heads, chunks of 128) on 16 + 8 synthetic images at batch 4 (4 steps an
    epoch), the card's timers and profiler stubbed and the decay
    attention's kernels replaced by counting plain versions: 2 + 2 + 2
    launches a Mamba-2 training step (exact, inside the path), none for
    S4; the chunk-256 forward, the spectra, the kernels at the trained
    weights, the card step against float64 and the timing all run."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True)
    for name, value in (("CIFAR_EPOCHS", {tag: 2}), ("CIFAR_ANALYSIS_BATCH", 4),
                        ("CIFAR_STEP_EXAMPLES", 2)):
        monkeypatch.setattr(cs, name, value)
    cut = copy.deepcopy(full)
    cut["dataset"].update(synthetic_train=16, synthetic_test=8)
    cut["train"].update(batch_size=4, train_size=16)
    cut["model"].update(num_layers=2, hidden_dim=16, state_dim=8)
    if "num_heads" in cut["model"]:  # chunks of 128: the plain decay attention on (Q, Q) tiles
        cut["model"].update(num_heads=2, chunk_size=128)
    launches = cs.cifar_path(torch.device("cpu"), ARTIFACT_FILES, cut, tag, torch.zeros(4))
    if full["model"]["layer"] == "mamba":
        # training alone is held exactly inside the path: 8 steps, 2 evals of 2 batches
        assert launches["decay_attention_bwd_j"] == 2 * 8
        assert launches["decay_attention_fwd"] > 2 * (8 + 2 * 2)
    assert not any(v for k, v in launches.items() if not k.startswith("decay_attention_")
                   or k.endswith("_bf16"))
    if full["model"]["layer"] == "s4":
        assert not any(launches.values())
