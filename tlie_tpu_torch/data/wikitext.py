"""WikiText language modelling, the numpy parts of ``tlie_tpu/data/wikitext.py``:
concatenate-and-chunk into fixed ``block_size`` blocks, labels the
next-token-shifted ids with a −100 tail, metric perplexity.

The token streams come from a pre-tokenized cache (``tokens_{train,test}.npy``
under ``data_dir``) when it holds both files, else, with ``synthetic: true``,
from the reference's Zipf stream over the GPT-2 vocabulary, drawn from
``seed`` (train first, then test, from one generator), so the arrays are
byte-equal to ``tlie_tpu``'s.  The port does not tokenize: with
``synthetic: false`` and no cache it raises, where ``tlie_tpu`` would try the
HF dataset and then fall back to the synthetic stream.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .base import SequenceDataset, perplexity

GPT2_VOCAB_SIZE = 50257


class WikiText(SequenceDataset):
    """WikiText splits as ``tlie_tpu.data.WikiText`` builds them."""

    _name_ = "wikitext"
    # ref dataloaders/wikitext.py:28-35
    init_defaults = {
        "version": 2,
        "block_size": 1024,
        "seed": 42,
        "synthetic": False,
        "synthetic_train_tokens": 2_000_000,
        "synthetic_test_tokens": 200_000,
    }

    def __init__(self, _name_: str = "wikitext", data_dir: Optional[str] = None, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self._splits = None

    @property
    def l_max(self) -> int:
        return self.block_size

    @property
    def d_output(self) -> int:
        return GPT2_VOCAB_SIZE

    @staticmethod
    def get_metrics():
        return perplexity

    def _token_streams(self) -> Tuple[np.ndarray, np.ndarray]:
        data_dir = Path(self.data_dir) if self.data_dir else None
        if data_dir:
            tr, te = data_dir / "tokens_train.npy", data_dir / "tokens_test.npy"
            if tr.is_file() and te.is_file():
                return np.load(tr), np.load(te)
        if not self.synthetic:
            raise FileNotFoundError(
                f"WikiText-{self.version}: no tokens_{{train,test}}.npy under data_dir "
                f"{self.data_dir!r}; the port does not tokenize (set dataset.synthetic: true "
                "or place the pre-tokenized streams there)")
        rng = np.random.default_rng(self.seed)

        def zipf_stream(n):
            # Zipf-ish rank distribution over the GPT-2 vocab
            u = rng.random(n)
            return np.minimum(
                (1.0 / (u + 1e-6) ** 1.1).astype(np.int64), GPT2_VOCAB_SIZE - 1
            )

        return (zipf_stream(self.synthetic_train_tokens),
                zipf_stream(self.synthetic_test_tokens))

    def _chunk(self, stream: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Concat-and-chunk + shifted labels (ref wikitext.py:114-149)."""
        bs = self.block_size
        total = (len(stream) // bs) * bs
        inputs = stream[:total].reshape(-1, bs).astype(np.int64)
        labels = np.full_like(inputs, -100)
        labels[:, :-1] = inputs[:, 1:]
        return inputs, labels

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, labels) of the ``"train"`` or ``"test"`` split; both
        streams are drawn on the first call."""
        if name not in ("train", "test"):
            raise ValueError(f"unknown split {name!r}")
        if self._splits is None:
            train_stream, test_stream = self._token_streams()
            self._splits = {"train": self._chunk(train_stream), "test": self._chunk(test_stream)}
            print(f"WikiText-{self.version} | block {self.block_size} | train blocks "
                  f"{len(self._splits['train'][0])} test {len(self._splits['test'][0])}")
        return self._splits[name]
