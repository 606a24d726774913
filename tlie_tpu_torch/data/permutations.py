"""Sequence-order permutations for image-as-sequence tasks, copied from
``tlie_tpu/data/permutations.py`` (numpy only): bit-reversal, snake
(boustrophedon), transpose and Hilbert-curve orderings, each an index array
applied to the flattened (row-major) sequence.
"""

from __future__ import annotations

import numpy as np


def bitreversal_permutation(n: int) -> np.ndarray:
    """Indices in bit-reversed order; n must be a power of two."""
    m = int(np.log2(n))
    assert 2**m == n, "bitreversal needs a power-of-two length"
    perm = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for bit in range(m):
        rev |= ((perm >> bit) & 1) << (m - 1 - bit)
    return rev


def transpose_permutation(h: int, w: int) -> np.ndarray:
    """Column-major (transposed) traversal of an h×w grid."""
    return np.arange(h * w).reshape(h, w).T.reshape(-1)


def snake_permutation(h: int, w: int) -> np.ndarray:
    """Boustrophedon traversal: every other row reversed."""
    idx = np.arange(h * w).reshape(h, w)
    idx[1::2] = idx[1::2, ::-1]
    return idx.reshape(-1)


def _hilbert_d2xy(order: int, d: np.ndarray):
    """Distance-along-curve → (x, y) for a 2^order × 2^order Hilbert curve
    (iterative Lam–Shapiro construction)."""
    n = 2**order
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    t = d.copy()
    s = 1
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(swap, y_f, x)
        y = np.where(swap, x_f, y)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        x = x + s * rx
        y = y + s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert_permutation(side: int) -> np.ndarray:
    """Hilbert-curve traversal order of a side×side grid (side = 2^k)."""
    order = int(np.log2(side))
    assert 2**order == side, "hilbert needs a power-of-two side"
    d = np.arange(side * side)
    x, y = _hilbert_d2xy(order, d)
    return (y * side + x).astype(np.int64)
