"""Data parallelism over processes: the port's counterpart of
``tlie_tpu/parallel/mesh.py`` and of the 1-D ``data`` mesh that
``tlie_tpu/training/loop.py::_data_mesh`` (``:47-55``) lays over every
local device.

Where ``tlie_tpu`` shards each gathered batch over the devices of one
program and lets XLA insert the collectives, the port runs one process per
device in a ``torch.distributed`` group: NCCL on cards, gloo where the
caller asks for the CPU or names gloo (:func:`init_process_group`).  Nothing
falls back: a card run whose NCCL cannot start fails with NCCL's error.

A :class:`Shard` is one process's place in the group.  Every rank draws the
same global batch indices and takes its own rows (:meth:`Shard.rows`), so
the data order is the one-process run's; the masked CE and the fused head
divide by the valid count summed over the group (:meth:`Shard.sum`), the
BatchNorm statistics are the global batch's (:meth:`Shard.sum_with_grad`,
autograd through the all-reduce), and the gradients are summed over the
group before the clip (:meth:`Shard.sum_grads`).  Each rank's loss is its
rows' share of the global mean, so the summed gradient is the one-process
gradient whatever valid count each shard holds.  The dropout masks are the
one-process run's too: each rank draws the mask of the whole batch from the
same generator state and keeps its rows (``models/layers.py::Dropout``).

:func:`spawn` starts the processes of a group on this machine, as
``torchrun`` would (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); :func:`init_process_group` reads that
environment, ``torchrun``'s own included.

Sequence parallelism (ROADMAP Queue 1 item 17b) splits time instead of
rows: a :class:`Shard` with ``axis=1`` holds the contiguous time steps
``[rank·L/n, (rank+1)·L/n)`` of every activation (:meth:`Shard.steps`),
and the collectives the route needs have autograd:
:meth:`Shard.all_gather` (``lax.all_gather``), :meth:`Shard.ring_shift`
(``lax.ppermute`` to rank + 1) and :meth:`Shard.halo` (the time steps
before the shard, for a causal convolution).  Every collective here is one
that gloo takes for CUDA tensors (an all-reduce) or, for the ring's
point-to-point messages, staged through the host under gloo; under NCCL the
tensors go directly.

Tensor parallelism (ROADMAP Queue 1 item 17c) lays the group out in two
dimensions (:func:`mesh_2d`): a data shard whose collectives run over the
ranks of one model index, and a model shard over the ranks of one data
index, which split the vocabulary (:mod:`.tp`).  Every collective of a
:class:`Shard` runs on its own ``group`` (the default group where it has
none).

A collective's backward is a collective too, so it must run on every rank:
the callers keep every rank's autograd graph the same, selecting by rank
with masks and slices, never by leaving a gathered tensor unused on some
rank.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class Shard:
    """One process's place in a process group: its ``rank`` of ``world``
    in ``group`` (None: the default group), and the axis of a global batch
    it holds a part of: its rows (``axis`` 0, data parallelism) or its time
    steps (``axis`` 1, sequence parallelism).  ``vocab`` marks the model
    group of tensor parallelism (:func:`mesh_2d`), whose ranks hold the
    same rows and split the vocabulary (:mod:`.tp`)."""

    rank: int
    world: int
    axis: int = 0
    group: Any = None
    vocab: bool = False

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a global batch (its leading axis,
        which the world size divides)."""
        n = t.shape[0] // self.world
        return t[self.rank * n:(self.rank + 1) * n]

    def steps(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous time steps ``[rank·L/n, (rank+1)·L/n)`` of a
        global tensor whose time axis is ``dim``; raises where the world
        size does not divide L."""
        L = t.shape[dim]
        if L % self.world:
            raise ValueError(f"time length {L} not divisible by sequence_parallel {self.world}")
        n = L // self.world
        return t.narrow(dim, self.rank * n, n)

    def part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a global tensor along the shard's axis."""
        return self.steps(t, self.axis) if self.axis else self.rows(t)

    def whole(self, shape) -> tuple:
        """The global shape of which ``shape`` is one rank's part."""
        shape = list(shape)
        shape[self.axis] *= self.world
        return tuple(shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order, (world, *t.shape),
        differentiable: the backward gives each rank the sum over the group
        of the gradients of its own slot (``lax.all_gather``'s transpose).
        Both passes are one all-reduce, which gloo takes for CUDA tensors
        as well (it has no reduce-scatter for the backward)."""
        return _GatherOverGroup.apply(t, self)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of which every rank holds its rows ``t``."""
        return torch.cat(self.all_gather(t).unbind(0), dim=0)

    def gather_steps(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The global tensor of which every rank holds its time steps ``t``:
        the ranks' parts concatenated along ``dim``."""
        return torch.cat(self.all_gather(t).unbind(0), dim=dim)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` sent to rank + 1 and rank − 1's received (a ring,
        ``lax.ppermute`` with ``(i, i + 1 mod n)``), differentiable: the
        backward sends the gradient the other way round."""
        return _RingShift.apply(t, self)

    def halo(self, x: torch.Tensor, k: int, dim: int = 1) -> torch.Tensor:
        """The ``k`` time steps just before this rank's shard ``x`` (time at
        ``dim``), zeros before the sequence's start: the left context of a
        causal convolution of width k + 1.  Differentiable: the gradient of
        each step goes back to the rank that holds it.  Built on
        :meth:`all_gather` of each rank's last min(k, L/n) steps, so a
        shard shorter than k takes its steps from as many ranks as it
        needs."""
        Ls = x.shape[dim]
        m = min(k, Ls)
        tails = self.gather_steps(x.narrow(dim, Ls - m, m), dim)  # (.., world·m, ..)
        pad = [0, 0] * (x.dim() - 1 - dim) + [k, 0]
        return F.pad(tails, pad).narrow(dim, self.rank * m, k)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group (a new tensor; no gradient)."""
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def sum_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, differentiable: the backward sums the
        ranks' gradients, as the derivative of the group's total loss
        asks."""
        return _SumOverGroup.apply(t, self)

    def sum_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Every parameter's gradient summed over the group, in place, in one
        all-reduce of the flattened gradients.  Parameters without a
        gradient are left out; the ranks run the same model, so they leave
        out the same ones."""
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def attach(self, model: torch.nn.Module) -> None:
        """Hand the shard to the modules of ``model`` that read it (those
        with a ``shard`` attribute: ``BatchNorm``'s global statistics,
        ``Dropout``'s global masks)."""
        for m in model.modules():
            if hasattr(m, "shard"):
                m.shard = self

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, self.global_rank(0), group=self.group)

    def broadcast(self, obj: Any) -> Any:
        """Rank 0's (picklable) ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, self.global_rank(0), group=self.group)
        return box[0]

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's (picklable) ``obj``, in rank order, on rank 0; None
        elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=self.global_rank(0), group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class _GatherOverGroup(torch.autograd.Function):
    """All-gather with autograd, as :meth:`Shard.all_gather`: forward and
    backward each one all-reduce (this rank's slot of a zero buffer)."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        out = t.new_zeros((shard.world, *t.shape))
        out[shard.rank] = t
        dist.all_reduce(out, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.shard.group)
        return g[ctx.shard.rank], None


def _shift(t: torch.Tensor, by: int, shard: Shard) -> torch.Tensor:
    """``t`` sent to rank + ``by`` and rank − ``by``'s received, both
    messages in flight at once.  Gloo's point-to-point messages take CPU
    tensors only, so a CUDA tensor travels through the host there; NCCL
    takes it directly."""
    world, rank = shard.world, shard.rank
    if world == 1:
        return t.clone()
    host = t.is_cuda and dist.get_backend(shard.group) != "nccl"
    send = (t.cpu() if host else t).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, shard.global_rank((rank + by) % world), shard.group),
           dist.P2POp(dist.irecv, recv, shard.global_rank((rank - by) % world), shard.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device) if host else recv


class _RingShift(torch.autograd.Function):
    """:meth:`Shard.ring_shift` with autograd."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return _shift(t, 1, shard)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -1, ctx.shard), None


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) with autograd: y = Σ_r t_r on every rank, and each
    rank's gradient of the group's total loss, Σ_r ∂L_r/∂y, is the sum of
    the ranks' upstream gradients (``torch.distributed.nn``'s all-reduce,
    which is deprecated)."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        out = t.clone()
        dist.all_reduce(out, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


def process_shard() -> Optional[Shard]:
    """This process's :class:`Shard` in the default group, or None where no
    group was started."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return Shard(dist.get_rank(), dist.get_world_size())


def data_shard(batch_size: int, enabled: bool = True) -> Optional[Shard]:
    """The data-parallel route's shard, ``_data_mesh``'s rule
    (``tlie_tpu/training/loop.py:47-55``, ``:233``): a process group has been
    started, the world size divides the batch and the route is ``enabled``
    (``train.data_parallel``, true by default); else None, and the
    single-process route runs.  A group of one process, which only an
    explicit start makes, takes the route too."""
    shard = process_shard()
    if shard is None or batch_size % shard.world or not enabled:
        return None
    return shard


def seq_shard(n: int) -> Shard:
    """The sequence-parallel route's shard for ``train.sequence_parallel:
    n``: this process's place in a started group of exactly n processes,
    holding time steps (``tlie_tpu``'s ``seq_mesh(n)``, which raises where
    fewer devices are visible).  Raises where no group of n runs."""
    shard = process_shard()
    if shard is None or shard.world != n:
        have = "no process group" if shard is None else f"a group of {shard.world}"
        raise ValueError(f"sequence_parallel={n} needs a process group of {n} processes "
                         f"(tlie_tpu_torch.launch starts one); this process has {have}")
    return Shard(shard.rank, shard.world, axis=1)


def mesh_2d(n_model: int) -> Tuple[Shard, Shard]:
    """This process's (data, model) shards of a 2-D layout of the default
    group, ``tlie_tpu/parallel/tp.py::mesh_2d``'s ``reshape(W // m, m)``
    (``:94-102``): rank r has data index r // m and model index r % m.  The
    model group of data index d holds ranks {d·m, …, d·m + m − 1} and the
    data group of model index j ranks {j, j + m, …}.  The data shard holds
    rows (``axis`` 0) in the data group; the model shard (``vocab``) splits
    the vocabulary in the model group.  Every rank makes every subgroup, in
    the same order (``dist.new_group`` is collective over the default
    group).  Raises where ``n_model`` does not divide the world size."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} devices not divisible by model_parallel={n_model}")
    n_data = world // n_model
    d, j = divmod(rank, n_model)
    data_groups = [dist.new_group([i * n_model + k for i in range(n_data)])
                   for k in range(n_model)]
    model_groups = [dist.new_group(list(range(i * n_model, (i + 1) * n_model)))
                    for i in range(n_data)]
    return (Shard(d, n_data, group=data_groups[j]),
            Shard(j, n_model, group=model_groups[d], vocab=True))


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes files and prints."""
    shard = process_shard()
    return shard is None or shard.rank == 0


def launched() -> bool:
    """Whether a launcher (:func:`spawn` or ``torchrun``) started this
    process as a rank of a group."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE"))


def init_process_group(device="cuda", backend: Optional[str] = None, *,
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Start this process's rank of the default group and return its
    device.  ``rank``, ``world_size`` and ``init_method`` default to the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``env://``).  The
    backend is NCCL for a card and gloo for the CPU unless ``backend`` names
    one.  A card without an index becomes ``cuda:LOCAL_RANK``, one card per
    local rank; an indexed card is taken as it is (gloo ranks may share
    one)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a card; use gloo on the CPU")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def destroy_process_group() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: Sequence[str], world_size: int, env: Optional[dict] = None,
          timeout: Optional[float] = None) -> int:
    """Run ``python argv`` as ``world_size`` ranks of one group on this
    machine, each with the launcher's environment (rank ``i`` is local rank
    ``i``; ``MASTER_ADDR`` localhost, a free ``MASTER_PORT``), plus ``env``.
    Waits for all of them; once one fails (or ``timeout`` seconds pass) the
    others are stopped.  Returns 0, or the first failing exit code (124
    for a timeout)."""
    base = dict(os.environ, **(env or {}), WORLD_SIZE=str(world_size),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, *argv],
                              env=dict(base, RANK=str(i), LOCAL_RANK=str(i)))
             for i in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                code = failed[0]
                break
            if deadline is not None and time.monotonic() > deadline:
                code = 124
                break
            time.sleep(0.05)
        else:
            code = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return code
