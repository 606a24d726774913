"""Image augmentations for the CIFAR pipeline as whole-batch numpy ops,
copied from ``tlie_tpu/data/augmentations.py``: ``random_crop`` (symmetric
pad), ``random_hflip``, ``cutout``, ``random_erasing`` and
``np_normalize``, each on a full (N, H, W, C) array, drawing from the
``np.random.Generator`` it is given in the same order as the original, so
the same generator gives the same arrays.
"""

from __future__ import annotations

import numpy as np


def random_crop(images: np.ndarray, rng: np.random.Generator, padding: int = 4) -> np.ndarray:
    """Symmetric-pad then randomly crop back to the original size."""
    n, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (padding, padding), (padding, padding), (0, 0)),
                    mode="symmetric")
    ys = rng.integers(0, 2 * padding + 1, size=n)
    xs = rng.integers(0, 2 * padding + 1, size=n)
    out = np.empty_like(images)
    for i in range(n):
        out[i] = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
    return out


def random_hflip(images: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    flip = rng.random(len(images)) < p
    out = images.copy()
    out[flip] = out[flip, :, ::-1]
    return out


def cutout(images: np.ndarray, rng: np.random.Generator, n_holes: int = 1,
           length: int = 16) -> np.ndarray:
    """Zero out n_holes random length×length squares per image
    (ref cifar_augmentations.py Cutout)."""
    n, h, w, _ = images.shape
    out = images.copy()
    for i in range(n):
        for _ in range(n_holes):
            cy = int(rng.integers(0, h))
            cx = int(rng.integers(0, w))
            y0, y1 = max(0, cy - length // 2), min(h, cy + length // 2)
            x0, x1 = max(0, cx - length // 2), min(w, cx + length // 2)
            out[i, y0:y1, x0:x1] = 0.0
    return out


def random_erasing(images: np.ndarray, rng: np.random.Generator, p: float = 0.5,
                   area_range=(0.02, 0.33), aspect_range=(0.3, 3.3)) -> np.ndarray:
    """Replace a random rectangle with noise (ref cifar_augmentations.py
    RandomErasing)."""
    n, h, w, c = images.shape
    out = images.copy()
    for i in range(n):
        if rng.random() > p:
            continue
        for _ in range(10):  # retry until the box fits
            area = rng.uniform(*area_range) * h * w
            aspect = rng.uniform(*aspect_range)
            eh = int(round(np.sqrt(area * aspect)))
            ew = int(round(np.sqrt(area / aspect)))
            if eh < h and ew < w:
                y = int(rng.integers(0, h - eh))
                x = int(rng.integers(0, w - ew))
                out[i, y : y + eh, x : x + ew] = rng.normal(size=(eh, ew, c))
                break
    return out


def np_normalize(images: np.ndarray, mean, std) -> np.ndarray:
    """(ref cifar_augmentations.py NpNormalize)"""
    return (images - np.asarray(mean)) / np.asarray(std)
