"""The port's ListOps data against tlie_tpu's on the CPU: the native
generator's binding, and the dataset's tokens, lengths, labels and
vocabulary from every source (the LRA TSV fixtures, a generated split of 64
+ 16 examples at lengths 8-200 from the native and the Python generator,
and the caches tlie_tpu writes), the loaders' batches and the metric.

Both sides get their own ``data_dir`` under ``tmp_path``: tlie_tpu writes
its caches there, the port writes nothing anywhere.  Equality is exact."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tlie_tpu.data import ListOps as JaxListOps
from tlie_tpu.data.base import argmax_accuracy as jax_argmax_accuracy
from tlie_tpu.data.listops import generate_listops_split as jax_generate_split
from tlie_tpu.data.listops import listops_tokenizer as jax_tokenizer
from tlie_tpu.native import LISTOPS_TOKENS as JAX_TOKENS
from tlie_tpu.native import listops_generate_native as jax_generate_native
from tlie_tpu_torch.data import DATASETS, ListOps, argmax_accuracy
from tlie_tpu_torch.data.listops import generate_listops_split, listops_tokenizer
from tlie_tpu_torch.data.native import LISTOPS_TOKENS, listops_generate_native

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "listops"
# the generated split of the tracked cache data/listops/gen-n64-16-seed0-len8-200.npz
SMALL = dict(num_train=64, num_test=16, min_length=8, max_length=200, seed=0)

needs_cxx = pytest.mark.skipif(jax_generate_native(1, seed=0) is None,
                               reason="no C++ compiler builds csrc/listops_gen.cpp")


def _pair(tmp_path, **cfg):
    """tlie_tpu's ListOps set up on its own directory, and the port's on
    another."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    ref = JaxListOps(_name_="listops", data_dir=str(jdir), **cfg)
    ref.setup()
    port = ListOps(_name_="listops", data_dir=str(pdir), **cfg)
    port.setup()
    return ref, port


def _assert_same(ref, port):
    assert port.vocab == ref.vocab and list(port.vocab) == list(ref.vocab)
    assert port.vocab_size == ref.vocab_size and port.pad_id == ref.pad_id
    for split in ("train", "test"):
        for field in ("inputs", "labels", "lengths"):
            got, want = getattr(port, f"{split}_{field}"), getattr(ref, f"{split}_{field}")
            assert got.dtype == np.int64 and np.asarray(want).dtype == np.int64, (split, field)
            np.testing.assert_array_equal(got, want, err_msg=f"{split}_{field}")
        x, y, lengths = port.split(split)
        assert x is getattr(port, f"{split}_inputs") and lengths is getattr(port, f"{split}_lengths")


def test_tokens_and_tokenizer_are_tlie_tpus():
    assert LISTOPS_TOKENS == JAX_TOKENS
    s = "[MAX 2 9 [MIN 4 7 ] 0 ] (x)"
    assert listops_tokenizer(s) == jax_tokenizer(s)


@needs_cxx
@pytest.mark.parametrize("n, seed, lo, hi, l_max", [(64, 0, 8, 200, 256), (40, 42, 500, 2000, 2048),
                                                    (16, 3, 8, 60, 64)])
def test_native_binding_gives_tlie_tpus_arrays(n, seed, lo, hi, l_max):
    """Tokens (padded with -1), lengths and targets of the C++ generator
    through the port's binding, bit for bit, whatever the thread count."""
    want = jax_generate_native(n, seed, lo, hi, l_max=l_max)
    for threads in (0, 1, 3):
        got = listops_generate_native(n, seed, lo, hi, l_max=l_max, threads=threads)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_python_generator_is_tlie_tpus():
    got = generate_listops_split(12, 7, 8, 120)
    want = jax_generate_split(12, 7, 8, 120)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@needs_cxx
def test_native_split_equals_tlie_tpus(tmp_path):
    """The 64 + 16 split at lengths 8-200 from the native generator: the
    same arrays and vocabulary; tlie_tpu caches it, the port writes nothing."""
    ref, port = _pair(tmp_path, l_max=256, **SMALL)
    assert port.source == "native"
    _assert_same(ref, port)
    assert os.listdir(tmp_path / "jax") and not (tmp_path / "port").exists()
    # the appended <eos> ends every sequence and is counted in its length
    rows = np.arange(len(port.train_inputs))
    assert (port.train_inputs[rows, port.train_lengths - 1] == port.vocab["<eos>"]).all()


def test_python_split_equals_tlie_tpus(tmp_path):
    """The same split from the Python generator (``use_native: false``)."""
    ref, port = _pair(tmp_path, l_max=256, use_native=False, **SMALL)
    assert port.source == "python"
    _assert_same(ref, port)
    assert not (tmp_path / "port").exists()


@pytest.mark.parametrize("native", [True, False])
def test_tlie_tpus_caches_are_read(tmp_path, native):
    """A directory holding tlie_tpu's cache of a split (the native one's or
    the string one's) gives the port that split, and the port adds no file."""
    if native and jax_generate_native(1, seed=0) is None:
        pytest.skip("no C++ compiler builds csrc/listops_gen.cpp")
    cfg = dict(l_max=256, use_native=native, **SMALL)
    ref = JaxListOps(_name_="listops", data_dir=str(tmp_path), **cfg)
    ref.setup()
    files = sorted(os.listdir(tmp_path))
    port = ListOps(_name_="listops", data_dir=str(tmp_path), **cfg)
    port.setup()
    assert port.source == ("native-cache" if native else "cache")
    _assert_same(ref, port)
    assert sorted(os.listdir(tmp_path)) == files


def test_tracked_cache_is_read_from_the_default_directory(monkeypatch):
    """With no data_dir both read ./data/listops, where the repository keeps
    tlie_tpu's cache of the 64 + 16 split."""
    monkeypatch.chdir(ROOT)
    ref = JaxListOps(l_max=256, **SMALL)
    ref.setup()
    port = ListOps(l_max=256, **SMALL)
    port.setup()
    assert port.source == "cache"
    _assert_same(ref, port)


@pytest.mark.parametrize("l_max", [2048, 12])
def test_tsv_fixtures_equal_tlie_tpus(l_max):
    """The LRA release format (basic_{train,test}.tsv): the same arrays; at
    l_max 12 the long expressions are cut to 11 tokens before their <eos>."""
    cfg = dict(data_dir=str(FIXTURES), l_max=l_max)
    ref = JaxListOps(_name_="listops", **cfg)
    ref.setup()
    port = DATASETS["listops"](_name_="listops", **cfg)
    port.setup()
    assert port.source == "tsv"
    _assert_same(ref, port)
    if l_max == 12:
        assert port.train_lengths.max() == 12


def test_loaders_give_tlie_tpus_batches(tmp_path):
    """The train and test loaders' (x, y, aux) batches, the per-example
    lengths in aux, equal to tlie_tpu's, shuffled from the same seed."""
    ref, port = _pair(tmp_path, l_max=256, use_native=False, **SMALL)
    for make in ("train_dataloader", "test_dataloader"):
        for (gx, gy, ga), (wx, wy, wa) in zip(getattr(port, make)(8), getattr(ref, make)(8)):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert set(ga) == set(wa) == {"lengths"}
            np.testing.assert_array_equal(ga["lengths"], wa["lengths"])


def test_argmax_accuracy_is_tlie_tpus():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 50)
    got = argmax_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(jax_argmax_accuracy(logits, labels)), abs=0)
    assert DATASETS["listops"].get_metrics() is argmax_accuracy


def test_unknown_split_raises():
    with pytest.raises(ValueError, match="unknown split"):
        ListOps(data_dir=str(FIXTURES)).split("val")
