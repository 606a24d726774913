"""Sweeps on one GPU (``sweep.py``): the counterpart of ``tlie_tpu/parallel/``
for a single device.  The mesh, tensor, sequence and ring parallelism of
``tlie_tpu/parallel/`` are not ported yet (ROADMAP Queue 1 item 17)."""

from .sweep import check_stackable, run_sweep

__all__ = ["check_stackable", "run_sweep"]
