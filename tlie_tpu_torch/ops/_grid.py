"""The grid axis of ``torch.func.vmap`` at the kernels' ``autograd.Function``\\ s.

A stacked sweep (``parallel/sweep.py``) runs each point's step under
``vmap(grad_and_value(...))``.  Each kernel's Function has a ``vmap`` rule
that takes its operands with the grid dim wherever vmap holds it (or none,
for an operand shared by the grid), moves it to the front (:func:`to_front`),
folds it into the kernel's batch axis, calls the Function once for the
whole grid (one launch of each kernel) and unfolds the result.  Its
backward is a second Function with a rule of its own, so that the backward
kernels, too, see plain tensors and launch once for the grid.
"""

from __future__ import annotations

from typing import Optional

import torch


def to_front(x: torch.Tensor, bdim: Optional[int], size: int) -> torch.Tensor:
    """``x`` with its grid dim at 0: moved there, or ``x`` expanded over a
    new leading dim of ``size`` where it has none (no copy)."""
    return x.expand(size, *x.shape) if bdim is None else x.movedim(bdim, 0)


def fold(x: torch.Tensor, bdim: Optional[int], size: int) -> torch.Tensor:
    """``x`` (per point (B, ...)) as (size·B, ...): the grid folded into the
    batch axis, a view where the strides allow it, else a contiguous copy."""
    x = to_front(x, bdim, size)
    return x.reshape(size * x.shape[1], *x.shape[2:])


def unfold(x: torch.Tensor, size: int) -> torch.Tensor:
    """The inverse of :func:`fold` on a kernel's output: (size·B, ...) →
    (size, B, ...)."""
    return x.reshape(size, x.shape[0] // size, *x.shape[1:])
