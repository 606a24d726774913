"""LRA PathFinder: are two dots joined by a dashed path?  Copied from
``tlie_tpu/data/pathfinder.py`` (numpy only).

The images come from the first of these that exists:
  1. lra_release's ``pathfinder32`` tree under ``data_dir``
     (``curv_contour_length_14/metadata/<n>.npy``, text files whose lines
     name an image and its label; ``tests/fixtures/pathfinder`` is a small
     one), read with PIL, which is imported where the tree is read: without
     PIL the loader takes the next source, as ``tlie_tpu`` does;
  2. the synthetic generator (``synthetic: true``, or no tree: the loader
     prints ``tlie_tpu``'s line): a dashed random walk between two end dots
     on a 32×32 canvas, connected (label 1) or split into two arcs (label
     0), with two distractor arcs, drawn bit for bit as ``tlie_tpu`` draws
     it (``seed`` for the train split, ``seed + 1`` for the test split).
The read tree is split into train and test by a permutation from ``seed``.
Each image becomes a sequence of ``resolution²`` float32 pixels in [0, 1],
less 0.5 with ``center``: ``split(name)`` gives (inputs (n, L, 1) float32,
labels (n,) int64).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .base import SequenceDataset, argmax_accuracy


def _draw_walk(rng, canvas, start, n_steps, dash=3):
    """A dashed random walk on ``canvas`` from ``start``; returns its end."""
    pos = np.array(start, dtype=np.int64)
    direction = rng.integers(0, 4)
    for step in range(n_steps):
        if rng.random() < 0.3:
            direction = rng.integers(0, 4)
        d = [(0, 1), (1, 0), (0, -1), (-1, 0)][direction]
        pos = np.clip(pos + d, 1, canvas.shape[0] - 2)
        if (step // dash) % 2 == 0:  # dashes
            canvas[pos[0], pos[1]] = 1.0
    return pos


def synthetic_pathfinder(n: int, seed: int, size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` images (n, size, size) float32 and their labels (n,) int64, as
    ``tlie_tpu``'s ``_synthetic_pathfinder`` draws them."""
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, size, size), dtype=np.float32)
    ys = np.zeros(n, dtype=np.int64)
    for i in range(n):
        connected = int(rng.integers(0, 2))
        canvas = xs[i]
        start = rng.integers(2, size - 2, size=2)
        if connected:
            end = _draw_walk(rng, canvas, start, n_steps=60)
            canvas[start[0], start[1]] = 1.0
            canvas[end[0], end[1]] = 1.0
        else:
            mid1 = _draw_walk(rng, canvas, start, n_steps=25)
            other = rng.integers(2, size - 2, size=2)
            _draw_walk(rng, canvas, other, n_steps=25)
            canvas[start[0], start[1]] = 1.0
            canvas[mid1[0], mid1[1]] = 1.0
        # distractor arcs
        for _ in range(2):
            _draw_walk(rng, canvas, rng.integers(2, size - 2, size=2), n_steps=15)
        ys[i] = connected
    return xs, ys


def read_lra_pathfinder(data_dir, resolution: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(images (n, resolution, resolution) float32 in [0, 1], labels (n,)
    int64) from lra_release's metadata layout under ``data_dir``, the
    metadata files in numeric order; None where the tree or PIL is
    missing."""
    try:
        from PIL import Image
    except ImportError:
        return None
    diff = Path(data_dir) / "curv_contour_length_14"
    meta_dir = diff / "metadata"
    if not meta_dir.is_dir():
        return None
    samples: List[Tuple[Path, int]] = []
    for metadata_file in sorted(meta_dir.glob("*.npy"), key=lambda p: int(p.stem)):
        for line in metadata_file.read_text().splitlines():
            parts = line.split()
            samples.append((diff / parts[0] / parts[1], int(parts[3])))
    xs = np.zeros((len(samples), resolution, resolution), dtype=np.float32)
    ys = np.zeros(len(samples), dtype=np.int64)
    for i, (path, label) in enumerate(samples):
        with open(path, "rb") as f:
            xs[i] = np.asarray(Image.open(f).convert("L"), dtype=np.float32) / 255.0
        ys[i] = label
    return xs, ys


class PathFinder(SequenceDataset):
    """The PathFinder splits as ``tlie_tpu.data.pathfinder.PathFinder.setup``
    builds them."""

    _name_ = "pathfinder"
    d_input = 1
    d_output = 2
    # ref dataloaders/lra.py:463-475
    init_defaults = {
        "resolution": 32,
        "sequential": True,
        "center": True,
        "val_split": 0.1,
        "test_split": 0.1,
        "seed": 42,
        "synthetic": False,
        "synthetic_train": 1024,
        "synthetic_test": 256,
    }

    def __init__(self, _name_: str = "pathfinder", data_dir=None, **cfg):
        super().__init__(_name_, data_dir, **cfg)
        self._built = False

    @property
    def l_max(self) -> int:
        return self.resolution * self.resolution

    @staticmethod
    def get_metrics():
        return argmax_accuracy

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        if name not in ("train", "test"):
            raise ValueError(f"unknown split {name!r}")
        self.setup()
        return getattr(self, f"{name}_inputs"), getattr(self, f"{name}_labels")

    def setup(self) -> None:
        if not self._built:
            self._build()
            self._built = True

    def _build(self) -> None:
        loaded = None
        if self.data_dir and not self.synthetic:
            loaded = read_lra_pathfinder(self.data_dir, self.resolution)
        if loaded is None:
            if not self.synthetic:
                print(
                    f"PathFinder | no lra_release data under {self.data_dir!r}; "
                    "using the synthetic connected-path generator"
                )
            tr_x, tr_y = synthetic_pathfinder(self.synthetic_train, self.seed, self.resolution)
            te_x, te_y = synthetic_pathfinder(self.synthetic_test, self.seed + 1,
                                              self.resolution)
        else:
            xs, ys = loaded
            order = np.random.default_rng(self.seed).permutation(len(xs))
            n_test = int(len(xs) * self.test_split)
            te_idx, tr_idx = order[:n_test], order[n_test:]
            tr_x, tr_y = xs[tr_idx], ys[tr_idx]
            te_x, te_y = xs[te_idx], ys[te_idx]

        def seq(x):
            x = x.reshape(len(x), -1, 1)
            return x - 0.5 if self.center else x

        self.train_inputs, self.train_labels = seq(tr_x), tr_y
        self.test_inputs, self.test_labels = seq(te_x), te_y
        print(f"PathFinder | res {self.resolution} | train {len(tr_y)} test {len(te_y)}")
