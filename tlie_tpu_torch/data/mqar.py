"""MQAR, multi-query associative recall: the numpy generator of
``tlie_tpu/data/mqar.py`` copied as it is, and a dataset holder with its
train and test streams and its metric, the masked accuracy.

``MQAR`` draws as ``tlie_tpu``'s ``MQAR.setup`` does: with the native C++
generator (``csrc/mqar_gen.cpp``, built by :mod:`.native`) unless
``use_native`` is False or no compiler builds it, and with numpy then.  The
two generators give different arrays for one seed; ``MQAR.generator`` says
which one draws.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import SequenceDataset, masked_accuracy
from .native import mqar_generate_native


def _check_shape(vocab_size: int, input_seq_len: int, num_kv_pairs: int) -> None:
    """The shapes either generator takes."""
    if input_seq_len % 2 != 0:
        raise ValueError("input_seq_len must be even")
    if vocab_size <= input_seq_len:
        raise ValueError("vocab_size must exceed input_seq_len")
    if num_kv_pairs * 4 > input_seq_len:
        raise ValueError("num_kv_pairs * 4 must not exceed input_seq_len")


def multiquery_ar(
    vocab_size: int,
    num_examples: int,
    input_seq_len: int,
    seed: int,
    power_a: float = 0.01,
    num_kv_pairs: int = 8,
    random_non_queries: bool = True,
    **kwargs,
):
    """Generate (inputs, labels) int64 arrays of shape (num_examples, L)."""
    _check_shape(vocab_size, input_seq_len, num_kv_pairs)

    rng = np.random.default_rng(seed)
    context_size = num_kv_pairs * 2
    key_vocab_size = vocab_size // 2

    # unique keys / values per example: slice per-row permutations
    def unique_choice(lo, hi, k):
        u = rng.random((num_examples, hi - lo))
        return lo + np.argsort(u, axis=1)[:, :k]

    keys = unique_choice(1, key_vocab_size, num_kv_pairs)
    values = unique_choice(key_vocab_size, vocab_size, num_kv_pairs)

    kvs = np.zeros((num_examples, context_size), dtype=np.int64)
    kvs[:, 0::2] = keys
    kvs[:, 1::2] = values

    # power-law gap distribution over the query region
    space = (input_seq_len - context_size) // 2
    p = power_a * np.arange(1, space + 1) ** (power_a - 1)
    p = p / p.sum()
    # weighted sampling without replacement per row: Gumbel-top-k
    gumbel = -np.log(-np.log(rng.random((num_examples, space))))
    gaps = np.argsort(-(np.log(p)[None, :] + gumbel), axis=1)[:, :num_kv_pairs]

    queries = np.zeros((num_examples, input_seq_len - context_size + 1), dtype=np.int64)
    np.put_along_axis(queries, gaps * 2, keys, axis=1)
    examples = np.concatenate([kvs, queries], axis=1)

    labels = np.full((num_examples, input_seq_len + 1), -100, dtype=np.int64)
    np.put_along_axis(labels, gaps * 2 + context_size + 1, values, axis=1)

    inputs, labels = examples[:, :-1], labels[:, 1:]

    if random_non_queries:
        zeros = inputs == 0
        inputs = np.where(zeros, rng.integers(0, vocab_size, size=inputs.shape), inputs)
    return inputs, labels


class MQAR(SequenceDataset):
    """MQAR splits as ``tlie_tpu.data.mqar.MQAR`` draws them: the train split
    from ``seed``, the test split from its own stream ``seed + 1``, with the
    native generator unless ``use_native`` is False (``generator``)."""

    _name_ = "mqar"
    # ref dataloaders/mqar.py:143-155
    init_defaults = {
        "seed": 42,
        "vocab_size": 8_192,
        "num_train_examples": 100_000,
        "num_test_examples": 3_000,
        "input_seq_length": 64,
        "num_kv_pairs": 8,
        "train_power_a": 0.01,
        "test_power_a": 0.01,
        "random_non_queries": True,
    }

    def __init__(self, _name_: str = "mqar", data_dir=None, use_native: bool = True, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self.use_native = use_native

    @property
    def generator(self) -> str:
        """``"native"`` or ``"numpy"``: the generator that draws the splits
        (numpy where ``use_native`` is False or no compiler builds the
        native one, as in the reference)."""
        from .native import _load

        return "native" if self.use_native and _load() is not None else "numpy"

    @property
    def l_max(self) -> int:
        return self.input_seq_length

    @property
    def d_output(self) -> int:
        return self.vocab_size

    @staticmethod
    def get_metrics():
        return masked_accuracy

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, labels) of the ``"train"`` or ``"test"`` split."""
        if name not in ("train", "test"):
            raise ValueError(f"unknown split {name!r}")
        train = name == "train"
        kw = dict(
            vocab_size=self.vocab_size,
            num_examples=self.num_train_examples if train else self.num_test_examples,
            input_seq_len=self.input_seq_length,
            seed=self.seed if train else self.seed + 1,  # distinct stream from train
            power_a=self.train_power_a if train else self.test_power_a,
            num_kv_pairs=self.num_kv_pairs,
            random_non_queries=self.random_non_queries,
        )
        if self.generator == "native":
            _check_shape(kw["vocab_size"], kw["input_seq_len"], kw["num_kv_pairs"])
            return mqar_generate_native(**kw)
        return multiquery_ar(**kw)
