"""Sweeps on one GPU (``sweep.py``): the counterpart of ``tlie_tpu/parallel/``
for a single device, every family stacked.  The mesh, tensor, sequence and
ring parallelism of ``tlie_tpu/parallel/`` are not ported yet (ROADMAP
Queue 1 item 17)."""

from .sweep import run_sweep

__all__ = ["run_sweep"]
