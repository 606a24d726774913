"""LRA ListOps: nested list-operation expressions classified by their value,
copied from ``tlie_tpu/data/listops.py`` (numpy only).

The splits come from the first of these that exists, in ``tlie_tpu``'s
order:
  1. the LRA release TSVs (``basic_{train,test}.tsv`` under ``data_dir``);
  2. a cache of a split that ``tlie_tpu``'s Python generator wrote
     (``gen-n<train>-<test>-seed<s>-len<min>-<max>.npz`` under ``data_dir``);
  3. the native generator (``csrc/listops_gen.cpp``, built by :mod:`.native`),
     or a cache of its split (``gen-native-...-l<l_max>.npz``) where one is
     there;
  4. the Python generator (:func:`generate_listops_split`), where no
     compiler builds the native one or ``use_native`` is False.
Both generators grow MIN/MAX/MED/SM trees to a drawn length, with the same
vocabulary, semantics, length window and depth cap; for one seed they give
different splits.  The dataset reads caches and writes none: a split it
generates lives in memory only.  ``source`` says where the split came from.

Tokenization matches the LRA pipeline: ``]`` becomes ``X``, parentheses are
dropped, whitespace splits; the vocabulary is ``<pad>``, ``<unk>``
(``<bos>``), ``<eos>``, then the train tokens by ``Counter.most_common``
(insertion order breaks ties); sequences are cut to ``l_max`` less the
specials, ``<eos>`` is appended and ``<pad>`` fills the rest.  The lengths
count the ``<eos>``.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import SequenceDataset, argmax_accuracy
from .native import LISTOPS_TOKENS, listops_generate_native

OPS = ("MIN", "MAX", "MED", "SM")


def listops_tokenizer(s: str) -> List[str]:
    return s.translate({ord("]"): ord("X"), ord("("): None, ord(")"): None}).split()


def _evaluate(op: str, vals: List[int]) -> int:
    if op == "MIN":
        return min(vals)
    if op == "MAX":
        return max(vals)
    if op == "MED":
        return int(np.median(vals))
    if op == "SM":
        return sum(vals) % 10
    raise ValueError(op)


class _Abort(Exception):
    """Tree exceeded the token budget: rejected early."""


def generate_listops_example(rng: np.random.Generator, max_depth: int = 10, max_args: int = 10,
                             value_p: float = 0.25, max_tokens: int = 1 << 62
                             ) -> Optional[Tuple[str, int]]:
    """One expression string and its value by the LRA recipe (a branching
    process with a value leaf at probability ``value_p``), or None once
    the tree passes ``max_tokens``: the accepted distribution is unchanged,
    a tree the length filter would reject is only rejected earlier."""
    budget = [max_tokens]

    def tree(depth: int) -> Tuple[str, int]:
        r = rng.random() if depth < max_depth else 1.0
        if r > 1.0 - value_p or depth >= max_depth:
            budget[0] -= 1
            if budget[0] < 0:
                raise _Abort
            v = int(rng.integers(0, 10))
            return str(v), v
        op = OPS[rng.integers(0, len(OPS))]
        n_args = int(rng.integers(2, max_args + 1))
        budget[0] -= 2  # the opening [OP and the closing ]
        if budget[0] < 0:
            raise _Abort
        parts, vals = [], []
        for _ in range(n_args):
            s, v = tree(depth + 1)
            parts.append(s)
            vals.append(v)
        return f"[{op} " + " ".join(parts) + " ]", _evaluate(op, vals)

    try:
        return tree(0)
    except _Abort:
        return None


def generate_listops_by_growth(rng: np.random.Generator, target_tokens: int, max_depth: int = 10,
                               max_args: int = 10) -> Tuple[str, int]:
    """Grow a tree to about ``target_tokens`` tokens by expanding random
    value leaves into operator nodes: the scheme both packages' splits use
    (the LRA recipe's rejection accepts next to nothing in the [500, 2000]
    window), with the recipe's vocabulary, semantics and depth cap."""
    # node := int leaf | [op, children...]
    root: List = ["[" + OPS[rng.integers(0, len(OPS))]]
    n0 = int(rng.integers(2, max_args + 1))
    root.extend(int(rng.integers(0, 10)) for _ in range(n0))
    tokens = 2 + n0
    # candidate leaves: (parent, index, depth)
    leaves = [(root, i, 1) for i in range(1, len(root))]
    while tokens < target_tokens and leaves:
        li = int(rng.integers(0, len(leaves)))
        parent, idx, depth = leaves.pop(li)
        if depth >= max_depth:
            continue
        k = int(rng.integers(2, max_args + 1))
        node: List = ["[" + OPS[rng.integers(0, len(OPS))]]
        node.extend(int(rng.integers(0, 10)) for _ in range(k))
        parent[idx] = node
        tokens += 1 + k  # +[OP +] +k values, -1 replaced leaf
        leaves.extend((node, i, depth + 1) for i in range(1, len(node)))

    def render(node) -> Tuple[str, int]:
        if isinstance(node, int):
            return str(node), node
        parts, vals = [], []
        for child in node[1:]:
            s, v = render(child)
            parts.append(s)
            vals.append(v)
        op = node[0][1:]
        return node[0] + " " + " ".join(parts) + " ]", _evaluate(op, vals)

    return render(root)


def generate_listops_split(n: int, seed: int, min_length: int = 500, max_length: int = 2000,
                           max_depth: int = 10, max_args: int = 10
                           ) -> Tuple[List[str], np.ndarray]:
    """n (expression, value) pairs with token lengths in [min_length,
    max_length]."""
    rng = np.random.default_rng(seed)
    sources, targets = [], []
    while len(sources) < n:
        target = int(rng.integers(min_length, max_length + 1))
        s, v = generate_listops_by_growth(rng, target, max_depth, max_args)
        if min_length <= len(listops_tokenizer(s)) <= max_length:
            sources.append(s)
            targets.append(v)
    return sources, np.asarray(targets, dtype=np.int64)


def _read_tsv(path: Path) -> Tuple[List[str], np.ndarray]:
    sources, targets = [], []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        src_i, tgt_i = header.index("Source"), header.index("Target")
        for line in f:
            cols = line.rstrip("\n").split("\t")
            sources.append(cols[src_i])
            targets.append(int(cols[tgt_i]))
    return sources, np.asarray(targets, dtype=np.int64)


class ListOps(SequenceDataset):
    """The ListOps splits as ``tlie_tpu.data.listops.ListOps.setup`` builds
    them: ``split(name)`` gives (inputs (n, l_max) int64, labels (n,)
    int64, lengths (n,) int64)."""

    _name_ = "listops"
    d_output = 10
    # ref dataloaders/lra.py:243-252, and the generator's settings
    init_defaults = {
        "l_max": 2048,
        "fixed_size": False,
        "append_bos": False,
        "append_eos": True,
        "seed": 42,
        "num_train": 96_000,
        "num_test": 2_000,
        "min_length": 500,
        "max_length": 2_000,
        "use_native": True,
    }

    def __init__(self, _name_: str = "listops", data_dir=None, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self.source: Optional[str] = None  # filled by setup()

    @staticmethod
    def get_metrics():
        return argmax_accuracy

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if name not in ("train", "test"):
            raise ValueError(f"unknown split {name!r}")
        self.setup()
        return (getattr(self, f"{name}_inputs"), getattr(self, f"{name}_labels"),
                getattr(self, f"{name}_lengths"))

    def setup(self) -> None:
        if self.source is None:
            self._build()

    def _cache(self, native: bool) -> Path:
        stem = (f"gen-native-n{self.num_train}-{self.num_test}-seed{self.seed}"
                f"-len{self.min_length}-{self.max_length}-l{self.l_max}" if native else
                f"gen-n{self.num_train}-{self.num_test}-seed{self.seed}"
                f"-len{self.min_length}-{self.max_length}")
        return Path(self.data_dir or "./data/listops") / f"{stem}.npz"

    def _specials(self) -> List[str]:
        return ["<pad>", "<unk>"] + ["<bos>"] * bool(self.append_bos) + \
            ["<eos>"] * bool(self.append_eos)

    def _build(self) -> None:
        have_tsv = self.data_dir and (Path(self.data_dir) / "basic_train.tsv").is_file()
        cache = self._cache(native=False)
        if not have_tsv and not cache.is_file() and self.use_native and self._build_native():
            return
        if have_tsv:
            train_src, train_y = _read_tsv(Path(self.data_dir) / "basic_train.tsv")
            test_src, test_y = _read_tsv(Path(self.data_dir) / "basic_test.tsv")
            self.source = "tsv"
        elif cache.is_file():
            blob = np.load(cache, allow_pickle=True)
            train_src, train_y = list(blob["train_src"]), blob["train_y"]
            test_src, test_y = list(blob["test_src"]), blob["test_y"]
            self.source = "cache"
        else:
            train_src, train_y = generate_listops_split(
                self.num_train, self.seed, self.min_length, self.max_length)
            test_src, test_y = generate_listops_split(
                self.num_test, self.seed + 1, self.min_length, self.max_length)
            self.source = "python"

        train_tokens = [listops_tokenizer(s) for s in train_src]
        counter: Counter = Counter()
        for toks in train_tokens:
            counter.update(toks)
        ordered = [t for t, _ in counter.most_common()]
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self._specials() + ordered)}
        self.vocab_size = len(self.vocab)
        self.pad_id = self.vocab["<pad>"]
        unk = self.vocab["<unk>"]

        def encode(tokens: List[str]) -> List[int]:
            body = [self.vocab.get(t, unk) for t in tokens]
            if self.append_bos:
                body = [self.vocab["<bos>"]] + body
            if self.append_eos:
                body = body + [self.vocab["<eos>"]]
            return body

        def pack(token_lists: List[List[str]]) -> Tuple[np.ndarray, np.ndarray]:
            budget = self.l_max - int(self.append_bos) - int(self.append_eos)
            ids = [encode(t[:budget]) for t in token_lists]
            lengths = np.asarray([len(x) for x in ids], dtype=np.int64)
            out = np.full((len(ids), self.l_max), self.pad_id, dtype=np.int64)
            for i, x in enumerate(ids):
                out[i, : len(x)] = x
            return out, lengths

        self.train_inputs, self.train_lengths = pack(train_tokens)
        self.train_labels = train_y
        self.test_inputs, self.test_lengths = pack([listops_tokenizer(s) for s in test_src])
        self.test_labels = test_y

    def _build_native(self) -> bool:
        """The split from the C++ generator (canonical token ids straight
        into arrays), or from its cache under ``data_dir``; False where no
        compiler builds the generator (or with ``append_bos``, which keeps
        the string pipeline, as in ``tlie_tpu``)."""
        if self.append_bos:
            return False
        cache = self._cache(native=True)
        if cache.is_file():
            blob = np.load(cache)
            tr = (blob["train_tokens"], blob["train_lengths"], blob["train_targets"])
            te = (blob["test_tokens"], blob["test_lengths"], blob["test_targets"])
            source = "native-cache"
        else:
            tr = listops_generate_native(self.num_train, self.seed, self.min_length,
                                         self.max_length, l_max=self.l_max)
            if tr is None:
                return False
            te = listops_generate_native(self.num_test, self.seed + 1, self.min_length,
                                         self.max_length, l_max=self.l_max)
            source = "native"

        # the string path's vocabulary: specials, then the train tokens by
        # frequency (Counter's insertion order, canonical id order, breaks ties)
        counts = np.bincount(tr[0][tr[0] >= 0].ravel(), minlength=len(LISTOPS_TOKENS))
        counter: Counter = Counter(
            {tok: int(c) for tok, c in zip(LISTOPS_TOKENS, counts) if c > 0})
        ordered = [t for t, _ in counter.most_common()]
        self.vocab = {t: i for i, t in enumerate(self._specials() + ordered)}
        self.vocab_size = len(self.vocab)
        self.pad_id = self.vocab["<pad>"]
        lut = np.full(len(LISTOPS_TOKENS), self.vocab["<unk>"], np.int64)
        for ci, tok in enumerate(LISTOPS_TOKENS):
            if tok in self.vocab:
                lut[ci] = self.vocab[tok]

        def pack(tokens, lengths):
            budget = self.l_max - int(self.append_eos)
            lens = np.minimum(lengths.astype(np.int64), budget)
            out = np.full(tokens.shape, self.pad_id, np.int64)
            valid = tokens >= 0
            out[valid] = lut[tokens[valid]]
            cols = np.arange(out.shape[1])[None, :]
            out = np.where(cols < lens[:, None], out, self.pad_id)
            if self.append_eos:
                out[np.arange(len(out)), lens] = self.vocab["<eos>"]
                lens = lens + 1
            return out, lens

        self.train_inputs, self.train_lengths = pack(tr[0], tr[1])
        self.train_labels = tr[2].astype(np.int64)
        self.test_inputs, self.test_lengths = pack(te[0], te[1])
        self.test_labels = te[2].astype(np.int64)
        self.source = source
        return True
