"""The port's counterpart of ``tlie_tpu/parallel/``: sweeps stacked on a
device and spread over the ranks of a process group (``sweep.py``), data
parallelism over processes (``mesh.py``; ROADMAP Queue 1 item 17a), and
sequence parallelism over processes (``sp.py``, ``ring.py`` and the
collectives of ``mesh.py``, entered through ``sequence_parallel``; item
17b), and vocab tensor parallelism on a (data, model) layout of the group
(``tp.py`` and ``mesh.py::mesh_2d``; item 17c)."""

from ..ops.scan import sequence_parallel
from .mesh import (
    Shard, data_shard, init_process_group, is_main, mesh_2d, process_shard, seq_shard, spawn,
)
from .ring import ring_causal_attention
from .sp import sp_diag_linear_scan, sp_linear_attention
from .tp import shard_vocab_parallel, vocab_partition_specs

__all__ = ["Shard", "data_shard", "init_process_group", "is_main", "mesh_2d", "process_shard",
           "ring_causal_attention", "run_sweep", "seq_shard", "sequence_parallel",
           "shard_vocab_parallel", "sp_diag_linear_scan", "sp_linear_attention", "spawn",
           "vocab_partition_specs"]


def __getattr__(name):
    # the sweep imports the training loop, which imports the mesh: load it
    # on first use, so that importing the mesh alone does not go round
    if name == "run_sweep":
        from .sweep import run_sweep

        return run_sweep
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
