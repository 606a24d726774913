"""The port's copies of framework-neutral code against the originals: the
full-width MQAR LRU config dict, YAML loading and runtime fields, and the
MQAR generators, native and numpy, with their separate test streams
(byte-equal arrays)."""

import glob

import numpy as np
import pytest
import torch

from tlie_tpu.config import load_experiment
from tlie_tpu.data.mqar import MQAR as JaxMQAR
from tlie_tpu.data.mqar import multiquery_ar as jax_multiquery_ar
from tlie_tpu_torch.config import MQAR_LRU_FULL, derive_runtime_fields, load_yaml
from tlie_tpu_torch.data import MQAR, multiquery_ar

torch.set_num_threads(1)
FULL_YAML = "configs/tasks/mqar/mqar-lru.yaml"


class _DatasetShape:
    """What derive_runtime_fields reads from a dataset: l_max and the length
    of the train split (MQAR's default 100 000 examples)."""

    def __init__(self, l_max, n_train):
        self.l_max = l_max
        self.train_inputs = range(n_train)


def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    exp = load_experiment(FULL_YAML)
    data = JaxMQAR(**exp.dataset)
    exp.derive_runtime_fields(_DatasetShape(data.l_max, data.num_train_examples))
    assert MQAR_LRU_FULL == exp.raw


@pytest.mark.parametrize("path", sorted(glob.glob("configs/*lru*.yaml"))
                         + [FULL_YAML])
def test_load_yaml_and_runtime_fields_match(path):
    exp = load_experiment(path)
    assert load_yaml(path) == exp.raw
    shape = _DatasetShape(300, 1234)
    got = derive_runtime_fields(load_yaml(path), shape.l_max, 1234)
    exp.derive_runtime_fields(shape)
    assert got == exp.raw


@pytest.mark.parametrize("seed", [1919, 1920])
def test_multiquery_ar_is_byte_equal(seed):
    kw = dict(vocab_size=8192, num_examples=24, input_seq_len=512, num_kv_pairs=64)
    got = multiquery_ar(seed=seed, **kw)
    want = jax_multiquery_ar(seed=seed, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_mqar_splits_use_their_own_streams():
    cfg = dict(input_seq_length=64, num_kv_pairs=8, vocab_size=256,
               num_train_examples=40, num_test_examples=16, seed=1919)
    ref = JaxMQAR(_name_="mqar", use_native=False, **cfg)
    ref.setup()
    port = MQAR(_name_="mqar", use_native=False, **cfg)
    assert port.generator == "numpy"
    for split in ("train", "test"):
        x, y = port.split(split)
        np.testing.assert_array_equal(x, getattr(ref, f"{split}_inputs"))
        np.testing.assert_array_equal(y, getattr(ref, f"{split}_labels"))
    assert port.l_max == 64 and port.d_output == 256
    assert not np.array_equal(port.split("train")[0][:16], port.split("test")[0])


def test_default_mqar_is_the_references_native_draw():
    """Both packages draw with the C++ generator by default, where ``c++``
    builds it (here it does): the same bytes for the same config and seed."""
    cfg = dict(input_seq_length=128, num_kv_pairs=8, vocab_size=512,
               num_train_examples=48, num_test_examples=16, seed=1919)
    ref = JaxMQAR(_name_="mqar", **cfg)
    ref.setup()
    port = MQAR(_name_="mqar", **cfg)
    assert port.generator == "native"
    numpy_draw = MQAR(_name_="mqar", use_native=False, **cfg)
    for split in ("train", "test"):
        x, y = port.split(split)
        for got, want in ((x, getattr(ref, f"{split}_inputs")), (y, getattr(ref, f"{split}_labels"))):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        assert not np.array_equal(x, numpy_draw.split(split)[0])  # the two generators differ
    assert not np.array_equal(port.split("train")[0][:16], port.split("test")[0])
