"""The dataset contract and the metrics of ``tlie_tpu/data/base.py``.

:class:`SequenceDataset` is the reference's registry contract (ref
dataloaders/base.py:159-231), numpy-only: a subclass with a ``_name_``
registers itself, ``SequenceDataset.registry[_name_](**cfg)`` builds it with
its ``init_defaults`` under the config's keys, ``setup()`` fills the
``{train,test}_{inputs,labels}`` arrays (and ``{train,test}_lengths`` for a
padded dataset such as ListOps), and ``l_max`` and ``d_output`` are what the
launcher reads.  The port's datasets give their splits with
``split(name)``, which ``setup`` calls: (inputs, labels), or (inputs,
labels, lengths) where the sequences are padded.  Batches come from
``train_dataloader`` and ``test_dataloader`` as (x, y, aux) numpy triples,
with the per-example lengths in ``aux["lengths"]`` where the split has them;
the trainer itself puts whole splits on the device.  The metrics are torch
functions.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Batch = Tuple[np.ndarray, np.ndarray, Dict[str, Any]]


class HostArrayLoader:
    """Minibatches of contiguous host arrays, (x, y, aux) as the reference's
    collated loaders yield them (``HostArrayLoader`` without the device
    sharding); a short last batch is dropped unless ``drop_last`` is
    False."""

    def __init__(self, inputs: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0, lengths: Optional[np.ndarray] = None,
                 aux_static: Optional[Dict[str, Any]] = None, drop_last: bool = True):
        self.inputs, self.labels, self.lengths = inputs, labels, lengths
        self.batch_size, self.shuffle = batch_size, shuffle
        self.aux_static = aux_static or {}
        self._rng = np.random.default_rng(seed)
        n = len(inputs)
        self._n_batches = n // batch_size if drop_last else -(-n // batch_size)

    def __len__(self) -> int:
        return self._n_batches

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.inputs))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(self._n_batches):
            idx = order[i * self.batch_size: (i + 1) * self.batch_size]
            aux = dict(self.aux_static)
            if self.lengths is not None:
                aux["lengths"] = self.lengths[idx]
            yield self.inputs[idx], self.labels[idx], aux


class SequenceDataset:
    """Registry base (``SequenceDataset``): subclasses with a ``_name_``
    register themselves on definition."""

    registry: Dict[str, type] = {}
    _name_: str = ""
    #: subclasses override; merged under the constructor's keyword arguments
    init_defaults: Dict[str, Any] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls._name_:
            SequenceDataset.registry[cls._name_] = cls

    def __init__(self, _name_: Optional[str] = None, data_dir: Optional[str] = None, **cfg):
        if _name_ is not None and _name_ != self._name_:
            raise ValueError(f"Dataset name mismatch: {_name_} != {self._name_}")
        self.data_dir = data_dir or None
        merged = dict(self.init_defaults)
        merged.update(cfg)
        for k, v in merged.items():
            setattr(self, k, v)
        # filled by setup()
        self.train_inputs: Optional[np.ndarray] = None
        self.train_labels: Optional[np.ndarray] = None
        self.test_inputs: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        self.train_lengths: Optional[np.ndarray] = None
        self.test_lengths: Optional[np.ndarray] = None

    #: subclasses provide l_max (the sequence length) and d_output (the
    #: number of classes or the vocabulary)
    l_max: int = None  # type: ignore[assignment]
    d_output: int = None  # type: ignore[assignment]

    def split(self, name: str) -> Tuple[np.ndarray, ...]:
        """(inputs, labels) of the ``"train"`` or ``"test"`` split, and the
        per-example lengths third where the sequences are padded."""
        raise NotImplementedError

    def setup(self) -> None:
        for name in ("train", "test"):
            inputs, labels, *lengths = self.split(name)
            setattr(self, f"{name}_inputs", inputs)
            setattr(self, f"{name}_labels", labels)
            setattr(self, f"{name}_lengths", lengths[0] if lengths else None)

    @staticmethod
    def get_metrics():
        """The metric ``f(logits, labels) -> scalar`` of the task."""
        raise NotImplementedError

    def _loader(self, split: str, batch_size: int, shuffle: bool, **kw) -> HostArrayLoader:
        inputs = getattr(self, f"{split}_inputs")
        if inputs is None:
            raise RuntimeError(f"Dataset {self._name_}: call setup() first")
        lengths = getattr(self, f"{split}_lengths")
        return HostArrayLoader(inputs, getattr(self, f"{split}_labels"), batch_size,
                               shuffle=shuffle, seed=getattr(self, "seed", 0), lengths=lengths,
                               aux_static={} if lengths is not None else {"lengths": self.l_max},
                               **kw)

    def train_dataloader(self, batch_size: int, shuffle: bool = True, **kw) -> HostArrayLoader:
        return self._loader("train", batch_size, shuffle, **kw)

    def test_dataloader(self, batch_size: int, shuffle: bool = False, **kw) -> HostArrayLoader:
        return self._loader("test", batch_size, shuffle, **kw)

    def val_dataloader(self, batch_size: int, shuffle: bool = False, **kw) -> HostArrayLoader:
        return self.test_dataloader(batch_size, shuffle, **kw)

    @property
    def dataset_train(self):
        """The train inputs, whose length the launcher records."""
        return self.train_inputs

    def __str__(self) -> str:
        return self._name_


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, ignore_idx: int = -100):
    """Accuracy over positions whose label != ignore_idx (MQAR metric,
    ref dataloaders/mqar.py:171)."""
    pred = torch.argmax(logits, dim=-1)
    mask = labels != ignore_idx
    correct = (mask & (pred == labels)).sum()
    return correct / mask.sum().clamp_min(1)


def argmax_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    """Share of rows whose argmax is the label (the ListOps metric, one
    label a sequence)."""
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def perplexity(logits: torch.Tensor, labels: torch.Tensor, ignore_idx: int = -100):
    """exp(mean CE) over non-ignored positions (ref dataloaders/wikitext.py:51-55)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp_min(0)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = labels != ignore_idx
    ce = -torch.where(mask, ll, torch.zeros_like(ll)).sum() / mask.sum().clamp_min(1)
    return torch.exp(ce)
