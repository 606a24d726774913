"""LRA AAN document retrieval: do two papers cite-match?  Copied from
``tlie_tpu/data/aan.py`` (numpy only).

The pairs come from the first of these that exists:
  1. lra_release's ``new_aan_pairs.{train,test}.tsv`` under ``data_dir``
     (tab-separated: label, id1, id2, text1, text2);
  2. the synthetic topic-matched pair corpus (``synthetic: true``, or no
     files: the loader prints ``tlie_tpu``'s line): each document draws its
     words from one of ten disjoint five-word topics, a matched pair (label
     1) shares its topic, drawn bit for bit as ``tlie_tpu`` draws it
     (``seed`` for the train split, ``seed + 1`` for the test split).
Documents are tokenized by character.  The vocabulary is ``<pad>``,
``<unk>`` (``<bos>``) (``<eos>``), then the characters of the train
documents, each cut to ``l_max`` less the specials, by
``Counter.most_common`` (first appearance breaks ties).  Each document is
cut so, ``<bos>`` prepended and ``<eos>`` appended where asked, and padded
with ``<pad>`` to ``l_max``: ``split(name)`` gives (inputs (n, 2, l_max)
int64, the pair on axis 1, labels (n,) int64).  The dual models fold the
pair axis into the batch.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .base import SequenceDataset, argmax_accuracy


def synthetic_pairs(n: int, seed: int, l_max: int = 4096) -> Tuple[List[str], List[str],
                                                                    np.ndarray]:
    """``n`` pairs of documents and their labels, as ``tlie_tpu``'s
    ``_synthetic_pairs`` draws them: the ten topics are one fixed partition
    (seed 1234) of 50 words, shared by both splits; a document holds 80-100
    % of ``l_max // 4`` words (about four characters a word) of its topic."""
    rng = np.random.default_rng(seed)
    vocab_words = [f"w{i}" for i in range(50)]
    topic_size, num_topics = 5, 10
    n_words_max = max(8, l_max // 4)
    perm = np.random.default_rng(1234).permutation(50)
    topics = [perm[i * topic_size: (i + 1) * topic_size] for i in range(num_topics)]

    def doc(topic: np.ndarray, n_words: int) -> str:
        return " ".join(vocab_words[i] for i in rng.choice(topic, size=n_words))

    t1, t2, ys = [], [], []
    for _ in range(n):
        y = int(rng.integers(0, 2))
        i1 = int(rng.integers(0, num_topics))
        i2 = i1 if y else int((i1 + 1 + rng.integers(0, num_topics - 1)) % num_topics)
        t1.append(doc(topics[i1], int(rng.integers(int(0.8 * n_words_max), n_words_max))))
        t2.append(doc(topics[i2], int(rng.integers(int(0.8 * n_words_max), n_words_max))))
        ys.append(y)
    return t1, t2, np.asarray(ys, dtype=np.int64)


def read_pairs_tsv(path) -> Tuple[List[str], List[str], np.ndarray]:
    """(texts 1, texts 2, labels) of an lra_release pair TSV."""
    t1, t2, ys = [], [], []
    with open(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            ys.append(int(float(cols[0])))
            t1.append(cols[3])
            t2.append(cols[4])
    return t1, t2, np.asarray(ys, dtype=np.int64)


def char_ids(text: str, lut: np.ndarray, unk: int) -> np.ndarray:
    """The vocabulary ids of ``text``'s characters as int64: ``lut`` maps a
    code point to its id, and a code point past it or unknown gives
    ``unk`` (``vocab.get(ch, unk)`` a character at a time)."""
    cp = np.frombuffer(text.encode("utf-32-le", "surrogatepass"), dtype="<u4")
    ids = np.full(len(cp), unk, dtype=np.int64)
    inside = cp < len(lut)
    ids[inside] = lut[cp[inside]]
    return ids


class AAN(SequenceDataset):
    """The AAN pairs as ``tlie_tpu.data.aan.AAN.setup`` builds them."""

    _name_ = "aan"
    d_output = 2
    # ref dataloaders/lra.py:548-557
    init_defaults = {
        "l_max": 4096,
        "fixed_size": False,
        "append_bos": False,
        "append_eos": True,
        "seed": 42,
        "synthetic": False,
        "synthetic_train": 512,
        "synthetic_test": 128,
    }

    def __init__(self, _name_: str = "aan", data_dir=None, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self.vocab: Dict[str, int] = {}  # filled by setup()

    @staticmethod
    def get_metrics():
        return argmax_accuracy

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        if name not in ("train", "test"):
            raise ValueError(f"unknown split {name!r}")
        self.setup()
        return getattr(self, f"{name}_inputs"), getattr(self, f"{name}_labels")

    def setup(self) -> None:
        if not self.vocab:
            self._build()

    def _build(self) -> None:
        root = Path(self.data_dir) if self.data_dir else None
        if root and (root / "new_aan_pairs.train.tsv").is_file():
            tr1, tr2, tr_y = read_pairs_tsv(root / "new_aan_pairs.train.tsv")
            te1, te2, te_y = read_pairs_tsv(root / "new_aan_pairs.test.tsv")
        else:
            if not self.synthetic:
                print(
                    f"AAN | no lra_release TSVs under {self.data_dir!r}; using a "
                    "synthetic pair corpus (set dataset.synthetic: true to silence)"
                )
            tr1, tr2, tr_y = synthetic_pairs(self.synthetic_train, self.seed, self.l_max)
            te1, te2, te_y = synthetic_pairs(self.synthetic_test, self.seed + 1, self.l_max)

        budget = self.l_max - int(self.append_bos) - int(self.append_eos)
        counter: Counter = Counter()
        for t in tr1 + tr2:
            counter.update(t[:budget])
        specials = (["<pad>", "<unk>"] + (["<bos>"] if self.append_bos else [])
                    + (["<eos>"] if self.append_eos else []))
        vocab = {t: i for i, t in enumerate(specials + [t for t, _ in counter.most_common()])}
        self.vocab_size = len(vocab)
        self.pad_id = vocab["<pad>"]
        unk = vocab["<unk>"]
        chars = {ord(t): i for t, i in vocab.items() if len(t) == 1}
        lut = np.full(max(chars, default=-1) + 1, unk, dtype=np.int64)
        lut[list(chars)] = list(chars.values())
        head = np.asarray([vocab["<bos>"]] if self.append_bos else [], dtype=np.int64)
        tail = np.asarray([vocab["<eos>"]] if self.append_eos else [], dtype=np.int64)

        def pack_pairs(a: List[str], b: List[str]) -> np.ndarray:
            out = np.full((len(a), 2, self.l_max), self.pad_id, dtype=np.int64)
            for i, pair in enumerate(zip(a, b)):
                for j, text in enumerate(pair):
                    ids = np.concatenate([head, char_ids(text[:budget], lut, unk), tail])
                    out[i, j, : len(ids)] = ids
            return out

        self.train_inputs, self.train_labels = pack_pairs(tr1, tr2), tr_y
        self.test_inputs, self.test_labels = pack_pairs(te1, te2), te_y
        self.vocab = vocab
        print(f"AAN | vocab size {self.vocab_size} | train {len(tr_y)} test {len(te_y)}")
