"""The port's counterpart of ``tlie_tpu/parallel/``: sweeps stacked on a
device and spread over the ranks of a process group (``sweep.py``), and
data parallelism over processes (``mesh.py``; ROADMAP Queue 1 item 17a).
The sequence, ring and tensor parallelism of ``tlie_tpu/parallel/``
(``sp.py``, ``ring.py``, ``tp.py``; items 17b and 17c) are not ported yet."""

from .mesh import Shard, data_shard, init_process_group, is_main, process_shard, spawn

__all__ = ["Shard", "data_shard", "init_process_group", "is_main", "process_shard", "run_sweep",
           "spawn"]


def __getattr__(name):
    # the sweep imports the training loop, which imports the mesh: load it
    # on first use, so that importing the mesh alone does not go round
    if name == "run_sweep":
        from .sweep import run_sweep

        return run_sweep
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
