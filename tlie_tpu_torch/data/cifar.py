"""Sequential CIFAR-10 and sequential MNIST: images as 1-D sequences,
counterparts of ``tlie_tpu/data/cifar.py`` (``CIFAR10``, ``MNIST``), numpy
only.

The whole split is converted once (grayscale by the ITU-R 601 weights,
normalised, flattened, permuted) into a contiguous array, which the trainer
puts on the device (:func:`tlie_tpu_torch.training.scan_loop.put_dataset`):
CIFAR-10 gives float32 (n, 1024, d_input) pixels, or (n, 1024) integer
tokens with ``grayscale`` and ``tokenize``.

The images come from the files ``torchvision`` reads, read here without
it: CIFAR-10's pickled batches (``cifar-10-batches-py/data_batch_1`` to
``_5`` and ``test_batch`` under ``data_dir``, default ``./data/cifar``;
rows of 3,072 uint8 in channel-major order, made (n, 32, 32, 3) / 255 as
``torchvision.datasets.CIFAR10.data`` gives them) and MNIST's idx files
(``MNIST/raw/{train,t10k}-{images-idx3,labels-idx1}-ubyte`` under
``data_dir``, default ``./data/mnist``).  The batches are pickles: put only
trusted files there.  Unlike torchvision, no checksum is taken.  Where the
files are missing, or ``synthetic`` is set, the class-conditional
synthetic images of ``tlie_tpu`` stand in, drawn bit for bit as it draws
them (``seed`` for the train split, ``seed + 1`` for the test split,
``seed + 7`` for the augmentation pass); CIFAR-10 prints the line
``tlie_tpu`` prints when it falls back without being asked to.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .augmentations import cutout, random_crop, random_hflip
from .base import SequenceDataset, argmax_accuracy
from .permutations import (
    bitreversal_permutation,
    hilbert_permutation,
    snake_permutation,
    transpose_permutation,
)

# ITU-R 601 luma weights — torchvision.transforms.Grayscale convention
_LUMA = np.array([0.2989, 0.587, 0.114], dtype=np.float32)

CIFAR_FOLDER = "cifar-10-batches-py"
CIFAR_TRAIN_BATCHES = tuple(f"data_batch_{i}" for i in range(1, 6))
CIFAR_TEST_BATCH = "test_batch"
MNIST_FILES = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
               "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

Images = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def read_cifar_batches(root) -> Optional[Images]:
    """(train images, train labels, test images, test labels) from the
    pickled CIFAR-10 batches under ``root/cifar-10-batches-py``: images
    (n, 32, 32, 3) float32 in [0, 1], labels int64; None where a file is
    missing."""
    folder = Path(root) / CIFAR_FOLDER
    if not all((folder / name).is_file() for name in CIFAR_TRAIN_BATCHES + (CIFAR_TEST_BATCH,)):
        return None

    def read(names):
        xs, ys = [], []
        for name in names:
            with open(folder / name, "rb") as f:
                entry = pickle.load(f, encoding="latin1")
            xs.append(np.asarray(entry["data"], dtype=np.uint8).reshape(-1, 3, 32, 32))
            ys.extend(entry["labels"])
        x = np.vstack(xs).transpose(0, 2, 3, 1)  # (n, 32, 32, 3), torchvision's .data
        return x.astype(np.float32) / 255.0, np.asarray(ys, dtype=np.int64)

    return read(CIFAR_TRAIN_BATCHES) + read((CIFAR_TEST_BATCH,))


def _read_idx(path: Path) -> np.ndarray:
    """An idx file of unsigned bytes (MNIST's format) as an array."""
    data = path.read_bytes()
    magic = int.from_bytes(data[:4], "big")
    ndim, kind = magic % 256, magic // 256
    if kind != 0x08:
        raise ValueError(f"{path}: not an idx file of unsigned bytes (magic {magic:#x})")
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim).reshape(dims)


def read_mnist_idx(root) -> Optional[Images]:
    """(train images, train labels, test images, test labels) from MNIST's
    idx files under ``root/MNIST/raw``: images (n, 28, 28) float32 in [0,
    1], labels int64; None where a file is missing."""
    folder = Path(root) / "MNIST" / "raw"
    paths = [folder / name for pair in MNIST_FILES.values() for name in pair]
    if not all(p.is_file() for p in paths):
        return None
    tr_x, tr_y, te_x, te_y = (_read_idx(p) for p in paths)
    return (tr_x.astype(np.float32) / 255.0, tr_y.astype(np.int64),
            te_x.astype(np.float32) / 255.0, te_y.astype(np.int64))


def _class_templates(size: int, channels: int, num_classes: int = 10) -> np.ndarray:
    """Deterministic per-class cosine-grating templates in [0, 1]
    (``_class_templates``): class c gets the spatial frequency pair (1 + c %
    5, 1 + 2·(c // 5)), so the classes stay separable under every
    permutation."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    out = np.zeros((num_classes, size, size, channels), dtype=np.float32)
    for c in range(num_classes):
        fx, fy = 1 + c % 5, 1 + 2 * (c // 5)
        for ch in range(channels):
            phase = 2.0 * np.pi * (c + ch) / num_classes
            out[c, ..., ch] = 0.5 + 0.5 * np.cos(
                2.0 * np.pi * (fx * xx + fy * yy) / size + phase
            )
    return out


def _synthetic_images(
    n: int, seed: int, size: int = 32, channels: int = 3
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional synthetic images (``_synthetic_images``): a class
    template blended with per-sample noise, 0.55 and 0.45, clipped to [0,
    1]; labels uniform over the 10 classes."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n).astype(np.int64)
    noise = rng.random((n, size, size, channels), dtype=np.float32)
    templates = _class_templates(size, channels)
    x = np.clip(0.55 * templates[y] + 0.45 * noise, 0.0, 1.0).astype(np.float32)
    return x, y


class _ImageSequences(SequenceDataset):
    """``split(name)`` builds the arrays on first use and gives (inputs,
    labels) of the ``"train"`` or ``"test"`` split."""

    def __init__(self, _name_: Optional[str] = None, data_dir=None, **cfg):
        super().__init__(_name_ or self._name_, data_dir, **cfg)
        self._built = False

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
        raise NotImplementedError


class CIFAR10(_ImageSequences):
    """Sequential CIFAR-10 as ``tlie_tpu.data.cifar.CIFAR10`` builds it."""

    _name_ = "cifar"
    d_output = 10
    l_max = 32 * 32
    # ref dataloaders/basic.py:73-85
    init_defaults = {
        "permute": None,        # br | snake | hilbert | transpose | None
        "grayscale": False,
        "tokenize": False,
        "augment": False,
        "cutout": False,
        "val_split": 0.1,
        "seed": 42,
        "synthetic": False,
        "synthetic_train": 2048,
        "synthetic_test": 512,
    }

    @property
    def d_input(self) -> int:
        if self.grayscale:
            return 256 if self.tokenize else 1
        return 3

    def _preprocess(self, images: np.ndarray) -> np.ndarray:
        """(N, 32, 32, 3) floats in [0,1] → (N, 1024, d_input) sequences;
        ``transpose`` puts the transposed copy beside the image on the
        feature axis."""
        n = images.shape[0]
        if self.grayscale:
            x = images @ _LUMA  # (N, 32, 32)
            x = x.reshape(n, 1024, 1)
            if self.tokenize:
                x = np.round(x * 255.0).astype(np.int64)[..., 0]  # (N, L) tokens
            else:
                x = (x - 122.6 / 255.0) / (61.0 / 255.0)
        else:
            mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
            std = np.array([0.247, 0.243, 0.261], np.float32)
            x = (images - mean) / std
            x = x.reshape(n, 1024, 3)

        if self.permute in ("br", "snake", "hilbert"):
            perm = {
                "br": lambda: bitreversal_permutation(1024),
                "snake": lambda: snake_permutation(32, 32),
                "hilbert": lambda: hilbert_permutation(32),
            }[self.permute]()
            x = x[:, perm]
        elif self.permute == "transpose":
            perm = transpose_permutation(32, 32)
            x = np.concatenate([x, x[:, perm]], axis=-1)
        return x

    def _build(self) -> None:
        loaded = None if self.synthetic else read_cifar_batches(self.data_dir or "./data/cifar")
        if loaded is None:
            if not self.synthetic:
                print(
                    "CIFAR-10 | torchvision binaries not found under "
                    f"{self.data_dir!r} and downloads are disabled; "
                    "falling back to synthetic images (set dataset.synthetic: "
                    "true to silence this)"
                )
            tr_x, tr_y = _synthetic_images(self.synthetic_train, self.seed)
            te_x, te_y = _synthetic_images(self.synthetic_test, self.seed + 1)
        else:
            tr_x, tr_y, te_x, te_y = loaded

        if self.augment:
            # one pass over the training split, drawn once (tlie_tpu's
            # deviation from the reference's per-epoch redraw)
            rng = np.random.default_rng(self.seed + 7)
            tr_x = random_hflip(random_crop(tr_x, rng), rng)
            if self.cutout:
                tr_x = cutout(tr_x, rng, n_holes=1, length=16)

        self.train_inputs = self._preprocess(tr_x)
        self.train_labels = tr_y
        self.test_inputs = self._preprocess(te_x)
        self.test_labels = te_y
        print(
            f"CIFAR-10 | {'gray' if self.grayscale else 'rgb'} | permute "
            f"{self.permute} | train {len(tr_y)} test {len(te_y)}"
        )


class MNIST(_ImageSequences):
    """Sequential (and bit-reversal permuted) MNIST as
    ``tlie_tpu.data.cifar.MNIST`` builds it: (n, 784, 1) float32 pixels in
    [0, 1].  ``permute: true``, the default, asks for the bit-reversal of
    784, which is no power of two: it raises, as in ``tlie_tpu``."""

    _name_ = "mnist"
    d_output = 10
    l_max = 28 * 28
    d_input = 1
    init_defaults = {
        "permute": True,
        "val_split": 0.1,
        "seed": 42,
        "synthetic": False,
        "synthetic_train": 2048,
        "synthetic_test": 512,
    }

    def _build(self) -> None:
        data = None if self.synthetic else read_mnist_idx(self.data_dir or "./data/mnist")
        if data is None:
            tr_x, tr_y = _synthetic_images(self.synthetic_train, self.seed,
                                           size=28, channels=1)
            te_x, te_y = _synthetic_images(self.synthetic_test, self.seed + 1,
                                           size=28, channels=1)
            data = (tr_x[..., 0], tr_y, te_x[..., 0], te_y)
        tr_x, tr_y, te_x, te_y = data

        def seq(x):
            x = x.reshape(len(x), 784, 1)
            if self.permute:
                perm = bitreversal_permutation(784)
                x = x[:, perm]
            return x

        self.train_inputs, self.train_labels = seq(tr_x), tr_y
        self.test_inputs, self.test_labels = seq(te_x), te_y
