"""IMDB sentiment classification, char and word level (the LRA text task),
copied from ``tlie_tpu/data/imdb.py`` (numpy only).

Char- or word-level tokens with a min-frequency vocabulary built on the
train split, ``<eos>`` appended (``<bos>`` prepended where asked), padded
to ``l_max``, binary labels; the metric is accuracy.  Word level uses
torchtext's ``basic_english`` rules (:func:`basic_english_tokenize`) and
torchtext's vocabulary order (:func:`build_vocab`), as ``tlie_tpu`` does in
place of the reference's spacy tokenizer.

The reviews come from the first of these that exists:
  1. plain-text folders ``{train,test}/{pos,neg}/*.txt`` under ``data_dir``
     (the aclImdb layout; ``tests/fixtures/aclImdb`` is a small one);
  2. a generated corpus with class-dependent words (``synthetic: true``, or
     no files: the loader prints ``tlie_tpu``'s line and uses it).
``tlie_tpu`` first tries a Hugging Face ``imdb`` cache, which loads through
the ``datasets`` package and may download; the port has no such path, so a
run reads the files or the synthetic corpus.
"""

from __future__ import annotations

import re
from collections import Counter
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .base import SequenceDataset, argmax_accuracy

# torchtext ``basic_english`` normalisation rules (pattern → replacement),
# applied in order after lowercasing; tokens are the whitespace splits.
_BASIC_ENGLISH_RULES = [
    (re.compile(p), r)
    for p, r in (
        (r"\'", " '  "),
        (r"\"", ""),
        (r"\.", " . "),
        (r"<br \/>", " "),
        (r",", " , "),
        (r"\(", " ( "),
        (r"\)", " ) "),
        (r"\!", " ! "),
        (r"\?", " ? "),
        (r"\;", " "),
        (r"\:", " "),
        (r"\s+", " "),
    )
]


def basic_english_tokenize(text: str) -> List[str]:
    """torchtext ``get_tokenizer("basic_english")`` equivalent."""
    text = text.lower()
    for pattern, repl in _BASIC_ENGLISH_RULES:
        text = pattern.sub(repl, text)
    return text.split()


def build_vocab(token_lists, min_freq: int, specials: List[str]) -> dict:
    """``torchtext.vocab.build_vocab_from_iterator`` ordering: specials
    first (special_first=True), then tokens with count ≥ min_freq by
    frequency descending, lexicographic tie-break."""
    counter: Counter = Counter()
    for toks in token_lists:
        counter.update(toks)
    items = sorted(counter.items())  # lexicographic
    items.sort(key=lambda kv: kv[1], reverse=True)  # stable: freq desc
    kept = [t for t, c in items if c >= min_freq]
    return {t: i for i, t in enumerate(specials + kept)}


def _load_acl_imdb(data_dir) -> Optional[Tuple[List[str], np.ndarray, List[str], np.ndarray]]:
    """(train texts, train labels, test texts, test labels) from the aclImdb
    folders under ``data_dir``, positive reviews first, each folder in name
    order; None where there are none."""
    if not data_dir:
        return None
    root = Path(data_dir)
    if not (root / "train" / "pos").is_dir():
        return None
    out = []
    for split in ("train", "test"):
        texts, labels = [], []
        for label, sub in ((1, "pos"), (0, "neg")):
            for p in sorted((root / split / sub).glob("*.txt")):
                texts.append(p.read_text(errors="ignore"))
                labels.append(label)
        out.extend([texts, np.asarray(labels, dtype=np.int64)])
    return tuple(out)  # type: ignore[return-value]


def _synthetic_reviews(n: int, seed: int) -> Tuple[List[str], np.ndarray]:
    """``n`` reviews of 40-400 words: neutral words and, twice as likely
    each, the positive or the negative words of the drawn label."""
    rng = np.random.default_rng(seed)
    pos_words = ["great", "wonderful", "excellent", "superb", "loved", "amazing"]
    neg_words = ["terrible", "awful", "boring", "horrible", "hated", "bland"]
    neutral = ["movie", "film", "plot", "actor", "scene", "the", "a", "was", "and", "very"]
    texts, labels = [], []
    for _ in range(n):
        y = int(rng.integers(0, 2))
        pool = neutral + (pos_words if y else neg_words) * 2
        k = int(rng.integers(40, 400))
        words = [pool[rng.integers(0, len(pool))] for _ in range(k)]
        texts.append(" ".join(words))
        labels.append(y)
    return texts, np.asarray(labels, dtype=np.int64)


class IMDB(SequenceDataset):
    """The IMDB splits as ``tlie_tpu.data.imdb.IMDB.setup`` builds them:
    ``split(name)`` gives (inputs (n, l_max) int64, labels (n,) int64,
    lengths (n,) int64), the lengths counting the specials."""

    _name_ = "imdb"
    d_output = 2
    # ref dataloaders/lra.py:33-46
    init_defaults = {
        "l_max": 4096,
        "fixed_size": False,
        "level": "char",
        "min_freq": 15,
        "seed": 42,
        "append_bos": False,
        "append_eos": True,
        "synthetic": False,
        "synthetic_train": 2048,
        "synthetic_test": 512,
    }

    def __init__(self, _name_: str = "imdb", data_dir=None, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self.vocab: Optional[dict] = None  # filled by setup()

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
        if self.vocab is None:
            self._build()

    def _build(self) -> None:
        data = None
        if not self.synthetic:
            data = _load_acl_imdb(self.data_dir)
            if data is None:
                print(
                    f"IMDB | no local dataset under {self.data_dir!r} and "
                    "downloads are disabled; using a synthetic stand-in "
                    "corpus (set dataset.synthetic: true to silence)"
                )
        if data is None:
            tr_t, tr_y = _synthetic_reviews(self.synthetic_train, self.seed)
            te_t, te_y = _synthetic_reviews(self.synthetic_test, self.seed + 1)
        else:
            tr_t, tr_y, te_t, te_y = data

        if self.level not in ("char", "word"):
            raise ValueError(f"level {self.level} not supported")
        tokenizer = list if self.level == "char" else basic_english_tokenize

        budget = self.l_max - int(self.append_bos) - int(self.append_eos)
        tr_tokens = [tokenizer(t)[:budget] for t in tr_t]
        te_tokens = [tokenizer(t)[:budget] for t in te_t]

        specials = ["<pad>", "<unk>"]
        if self.append_bos:
            specials.append("<bos>")
        if self.append_eos:
            specials.append("<eos>")
        vocab = build_vocab(tr_tokens, self.min_freq, specials)
        self.vocab_size = len(vocab)
        self.pad_id = vocab["<pad>"]
        unk = vocab["<unk>"]

        def pack(token_lists) -> Tuple[np.ndarray, np.ndarray]:
            out = np.full((len(token_lists), self.l_max), self.pad_id, dtype=np.int64)
            lengths = np.zeros(len(token_lists), dtype=np.int64)
            for i, toks in enumerate(token_lists):
                ids = [vocab.get(t, unk) for t in toks]
                if self.append_bos:
                    ids = [vocab["<bos>"]] + ids
                if self.append_eos:
                    ids = ids + [vocab["<eos>"]]
                out[i, : len(ids)] = ids
                lengths[i] = len(ids)
            return out, lengths

        self.train_inputs, self.train_lengths = pack(tr_tokens)
        self.train_labels = tr_y
        self.test_inputs, self.test_lengths = pack(te_tokens)
        self.test_labels = te_y
        self.vocab = vocab
        print(
            f"IMDB {self.level} | min_freq {self.min_freq} | vocab size "
            f"{self.vocab_size} | train {len(tr_y)} test {len(te_y)}"
        )
