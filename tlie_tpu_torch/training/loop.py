"""The training loop of ``tlie_tpu/training/loop.py::train``, step-driven or
epoch-driven (an eval period of ``train_size // batch_size`` steps, the
ListOps S5 and S4), as :func:`tlie_tpu_torch.config.train_fields` says.

Each eval period draws its (steps, batch) index matrix from
``numpy.random.default_rng(seed)`` as ``tlie_tpu`` does, runs that many
steps one at a time, evaluates the test split, prints one line with the
steps/s, tracks the best result, decays the plateau rates, stops early
once the test metric exceeds ``stop_criterion``, and writes a resume
snapshot where ``checkpoint_every`` asks for one.  The final checkpoint
goes to ``checkpoint_name() + "-perf{:.3f}"`` as a ``.pth`` file.

The decoder head of the training steps is the dense one, the sparse one
(MQAR's few valid labels) or, with ``train.fused_xent``, the fused decoder +
CE head, chosen as ``tlie_tpu`` chooses it (``loop.py:292-350``).  The eval
runs the dense or sparse head and the dataset's metric.

The run logs through :class:`tlie_tpu_torch.utils.RunLogger` where
``tlie_tpu`` logs (``loop.py:146-159``, ``:448``, ``:507``, ``:543-555``):
the parameter counts, then each eval's numbers, to
``./logs/<run name>.jsonl``, the run name ``tlie_tpu``'s.  A ``wandb``
section logs locally as well (the port has no W&B sink).

With a process group started (``tlie_tpu_torch.launch`` on more than one
card, ``--nproc``, or ``torchrun``), the data-parallel route runs where
``tlie_tpu``'s ``_data_mesh`` would shard the batch (``loop.py:47-55``,
:func:`tlie_tpu_torch.parallel.mesh.data_shard`): every rank draws the same
batch indices and trains on its rows, with the global batch's loss
denominator, BatchNorm statistics and dropout masks and the gradients
summed over the group (:mod:`tlie_tpu_torch.parallel.mesh`), so it takes
the one-process run's steps.  Evals, checkpoints, resume snapshots and the
run logger are rank 0's; the other ranks take its eval results and wait
for its files.  A resume loads on every rank.

With ``train.sequence_parallel: N`` (a group of N processes started by the
launcher) the sequence-parallel route runs instead, whatever
``train.data_parallel`` says, as ``tlie_tpu`` drops its data mesh under a
``seq`` mesh (``loop.py:233-254``): every rank takes the whole batch and
holds its contiguous L/N time steps of it
(:func:`tlie_tpu_torch.parallel.mesh.seq_shard`), and the model's forward
and backward and the eval run inside ``ops.scan.sequence_parallel``, so the
scans, attention, convolutions, positions and pooling span the group
(:mod:`tlie_tpu_torch.parallel.sp`, :mod:`~tlie_tpu_torch.parallel.ring`).
The loss divides by the valid count summed over the group, the BatchNorm
statistics and dropout masks are the whole sequence's, the gradients are
summed over the group, and the eval gathers the per-position outputs, so the
route takes the one-process run's steps and numbers.  Rank 0 writes the
checkpoints and the logs.

With ``train.model_parallel: m`` above 1 the tensor-parallel route runs
(``tlie_tpu``'s ``mesh_2d``, ``loop.py:221-230``, ``:276-280``): the group
is laid out as (data, model) (:func:`tlie_tpu_torch.parallel.mesh.mesh_2d`),
the whole model is built and its token table and decoder cut to the model
rank's V/m rows (:mod:`tlie_tpu_torch.parallel.tp`), and the data shard
takes the data-parallel route's part: the rows, the loss denominators,
BatchNorm's statistics, the dropout masks and the gradient sums.  The loss
and the eval's metric span the model group; the fused and sparse heads are
off, as in ``tlie_tpu``.  The ranks of data index 0 evaluate together.
Rank 0 writes the checkpoint, the resume snapshot and the logs in the
one-process layout, the split leaves (and their moments) gathered over the
model group; a resume cuts them again on every rank.  The returned
``.model`` is the whole model, gathered.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from ..config import checkpoint_name, lang_model, model_parallel_of, train_fields
from ..data import DATASETS
from ..device import resolve_device
from ..models.layers import Dropout
from ..models.registry import build_models
from ..ops.fused_xent import fused_xent_eligible
from ..ops.scan import sequence_parallel
from ..parallel.mesh import Shard, data_shard, mesh_2d, process_shard, seq_shard
from ..parallel.sp import sp_inputs
from ..parallel.tp import gather_vocab_parallel
from ..utils.logging import RunLogger
from .checkpoint import restore_resume, save_checkpoint, save_resume
from .scan_loop import (
    DeviceData, batch_indices, eval_indices, evaluate, gather_batch, per_position, put_dataset,
    sparse_head_k_for,
)
from .schedules import PlateauState, lr_for_step, reduce_lr_on_plateau
from .state import make_family_optimizer
from .steps import train_step


class TrainResult(tuple):
    """``(checkpoint_path | None, final perf)``, the reference ``train()``
    contract, carrying the trained models as ``.model`` (train mode) and
    ``.eval_model`` (eval mode, sharing its parameters), the optimiser as
    ``.optimizer``, and ``.history``, one dict per eval with the numbers of
    its printed line."""

    def __new__(cls, path, perf, model, eval_model, history, optimizer):
        result = super().__new__(cls, (path, perf))
        result.model, result.eval_model, result.history = model, eval_model, history
        result.optimizer = optimizer
        return result


def use_fused_head(cfg: Dict[str, Any], batch_size: int) -> bool:
    """``train.fused_xent`` on a next-token task with a per-position head
    whose (B·L, D) rows the fused head takes (``loop.py:292-325``, without
    ``tlie_tpu``'s TPU-only condition: the port runs the plain version on
    the CPU and the kernels on the card); under the sequence-parallel route
    a rank's B·L/N rows; off under ``train.model_parallel`` above 1
    (``loop.py:302-306``)."""
    model_cfg = cfg["model"]
    n = int(cfg["train"].get("sequence_parallel") or 1)
    return (
        bool(cfg["train"].get("fused_xent", False))
        and model_parallel_of(cfg) == 1
        and bool(cfg.get("lang_model", lang_model(cfg)))
        and per_position(model_cfg)
        and fused_xent_eligible(batch_size * model_cfg["seq_len"] // n,
                                model_cfg["hidden_dim"], model_cfg["output_dim"])
    )


def save_trained(cfg: Dict[str, Any], model: torch.nn.Module, perf: float,
                 used_paths: Optional[Set[str]] = None) -> Optional[str]:
    """Write the checkpoint of a trained ``model`` to ``checkpoint_name(cfg)
    + "-perf{perf:.3f}" + ".pth"`` and return its path, or None where the
    config has no ``save``.  With ``used_paths`` (a sweep's), a path already
    in it takes the suffix ``-p1``, ``-p2``, ... instead, as
    ``tlie_tpu/parallel/sweep.py`` disambiguates points whose names
    collide, and the path chosen joins the set."""
    stem = checkpoint_name(cfg)
    if stem is None:
        return None
    stem = stem + f"-perf{perf:0.3f}"
    if used_paths is not None:
        n, base = 1, stem
        while os.path.abspath(stem + ".pth") in used_paths:
            stem = f"{base}-p{n}"
            n += 1
        used_paths.add(os.path.abspath(stem + ".pth"))
    tree = {"model": dict(cfg["model"]), "train": dict(cfg["train"]), "data": dict(cfg["dataset"])}
    return save_checkpoint(stem, model, tree)


def head_choice(cfg: Dict[str, Any], train_split, test_split) -> Tuple[bool, Optional[int]]:
    """(fused, sparse K) of the training heads, chosen as ``tlie_tpu``
    chooses them (``loop.py:292-350``)."""
    f = train_fields(cfg)
    fused = use_fused_head(cfg, f["batch_size"])
    sparse_k = None
    if f["sparse_head"] and bool(cfg.get("lang_model", lang_model(cfg))) and not fused:
        sparse_k = sparse_head_k_for(cfg["model"], train_split[1], test_split[1])
    return fused, sparse_k


def _device_split(split, dev, padded: bool) -> DeviceData:
    """A host split on the device: (inputs, labels) or, for a padded
    config, (inputs, labels, lengths) with the lengths carried."""
    if padded and len(split) < 3:
        raise ValueError("a padded config (dataset.fixed_size: false) needs the split's lengths")
    return put_dataset(split[0], split[1], dev, split[2] if padded else None)


def _dropout_generator(model: torch.nn.Module) -> Optional[torch.Generator]:
    """The generator the model's dropout masks are drawn from (one a model,
    set by ``build_models``), or None where it has no dropout."""
    return next((m.generator for m in model.modules() if isinstance(m, Dropout)), None)


def resume_path(cfg: Dict[str, Any]) -> Optional[str]:
    """Where the run's resume snapshot lives: ``checkpoint_name(cfg) +
    "-resume.pth"``, or None where the config has no ``save`` or no
    ``train.checkpoint_every`` (``tlie_tpu``'s ``<stem>-resume``)."""
    stem = checkpoint_name(cfg)
    every = cfg["train"].get("checkpoint_every")
    return stem + "-resume.pth" if stem is not None and every else None


def run_name(cfg: Dict[str, Any], wandb_config: Optional[Dict[str, Any]] = None) -> str:
    """The run's name, ``tlie_tpu``'s (``loop.py:146-150``): the W&B name or
    the family, then d_model, seed, layers, d_qk and the learning rate."""
    m, t = cfg["model"], cfg["train"]
    return (f"{(wandb_config or {}).get('name', m['layer'])}-dmodel{m['hidden_dim']}"
            f"-seed{cfg['seed']}-num_layers{m['num_layers']}-dqk{m['state_dim']}-lr{t['lr']}")


def train(cfg: Dict[str, Any], train_split: Tuple[np.ndarray, ...],
          test_split: Tuple[np.ndarray, ...], *, device="cuda",
          used_paths: Optional[Set[str]] = None,
          wandb_config: Optional[Dict[str, Any]] = None) -> TrainResult:
    """Train the configuration ``cfg`` (a resolved config dict, runtime
    fields derived) on the (inputs, labels) splits, or (inputs, labels,
    lengths) for a padded config, evaluating with the metric of its dataset
    (``cfg["dataset"]["_name_"]``); returns a :class:`TrainResult`.  Runs
    on the card unless ``device="cpu"``.  ``used_paths`` is a sweep's set
    of checkpoint paths (:func:`save_trained`); ``wandb_config`` is the
    config's ``wandb`` section, which names the run and is otherwise logged
    locally (:class:`~tlie_tpu_torch.utils.RunLogger`).

    With ``train.checkpoint_every`` a resume snapshot (:func:`resume_path`)
    is written after an eval once that many steps have passed since the
    last one, unless the run stops there; with ``train.resume`` a snapshot
    that exists is restored and the host's batch-index stream replayed to
    its step, so the run goes on as if never stopped.  The snapshot is
    removed when the run completes (``loop.py:367-404, 455-476``)."""
    dev = resolve_device(device)
    f = train_fields(cfg)
    model_cfg = cfg["model"]
    bsz = f["batch_size"]
    padded = bool(cfg["train"].get("padded", False))
    for name, split in (("train", train_split), ("test", test_split)):
        if len(split[0]) < bsz:
            raise ValueError(f"the {name} split holds {len(split[0])} examples, fewer than "
                             f"one batch of {bsz}")
    metric = DATASETS[cfg["dataset"]["_name_"]].get_metrics()
    # the sequence-parallel route takes the whole group, the data-parallel
    # one is off under it (tlie_tpu's loop.py:251-254); the tensor-parallel
    # route lays the group out as (data, model)
    seq = seq_shard(f["sequence_parallel"]) if f["sequence_parallel"] > 1 else None
    vocab = None
    if f["model_parallel"] > 1:
        shard, vocab = _tensor_shards(f["model_parallel"], bsz)
    else:
        shard = data_shard(bsz, f["data_parallel"]) if seq is None else None
    group = seq if seq is not None else shard
    world = None if group is None else process_shard()
    main = (group is None or group.rank == 0) and (vocab is None or vocab.rank == 0)
    say = print if main else (lambda *a, **k: None)

    logger = RunLogger(wandb_config, run_name(cfg, wandb_config)) if main else None
    model, eval_model, family = build_models(
        model_cfg, padded, generator=torch.Generator().manual_seed(cfg["seed"]), device=dev,
        vocab_shard=vocab)
    if group is not None:
        group.broadcast_module(model)
        group.attach(model)  # BatchNorm's global statistics, Dropout's global masks
        backend = torch.distributed.get_backend()
        if seq is not None:
            say(f"[train] sequence parallel: time axis {model_cfg['seq_len']} over "
                f"{seq.world} processes ({backend})")
        elif vocab is not None:
            say(f"[train] tensor parallel: vocabulary over {vocab.world} processes, batch "
                f"{bsz} over {shard.world} ({backend})")
        else:
            say(f"[train] data parallel: batch {bsz} over {shard.world} processes ({backend})")
    nr_params = sum(_whole_numel(p) for p in model.parameters())
    embed = getattr(model.encoder, "encoder", model.encoder)  # the SSM backbone nests it
    nr_encoder = sum(_whole_numel(p) for p in embed.parameters())
    say(f"Nr. of parameters: {nr_params} (encoder: {nr_encoder})")
    if main:
        logger.log({"params": nr_params, "params without encoder": nr_params - nr_encoder})
    optimizer, clip_norm = make_family_optimizer(model, family, model_cfg, cfg["train"], f)

    train_data = _device_split(train_split, dev, padded)
    test_data = _device_split(test_split, dev, padded)
    fused, sparse_k = head_choice(cfg, train_split, test_split)
    if fused:
        say("[train] fused decoder+softmax-CE head enabled")
    if sparse_k is not None:
        say(f"[train] sparse decoder head: K={sparse_k} of L={model_cfg['seq_len']}")
    # a rank's steps hold at most K of a row's valid labels, and no more
    # than its L/N positions: the sparse head on the shard at that K is the
    # dense masked CE of its steps, as on the whole sequence
    step_k = sparse_k
    if seq is not None and sparse_k is not None:
        step_k = min(sparse_k, model_cfg["seq_len"] // seq.world)
    hybrid = ([layer.mixer for layer in model.layers]
              if family == "transformer" and model_cfg.get("mixer") == "hybrid" else [])
    eval_idx = torch.as_tensor(eval_indices(len(test_split[0]), bsz), device=dev).long()
    n_train = len(train_split[0])
    nprng = np.random.default_rng(cfg["seed"])
    dropout_gen = _dropout_generator(model)

    total, warmup, every = f["total_steps"], f["warmup"], f["eval_every"]
    plateau = PlateauState(f["lr"], f["ssm_lr"], 0, -np.inf)
    step, stop = 0, False
    best = {"perf": -np.inf, "loss": np.inf, "step": 0}
    test_perf, test_loss = 0.0, np.inf
    history = []
    snap_path = resume_path(cfg)
    if snap_path and f["resume"] and os.path.isfile(snap_path):
        meta = restore_resume(snap_path, model, optimizer, vocab=vocab)
        step, history, best = int(meta["step"]), list(meta["history"]), dict(meta["best"])
        plateau = PlateauState(*meta["plateau"])
        if dropout_gen is not None:
            dropout_gen.set_state(meta["dropout_rng"])
        # replay the host's batch-index stream to the restored step, so the
        # data order goes on exactly
        s = 0
        while s < step:
            k = int(min(every, total - s))
            batch_indices(nprng, n_train, bsz, k)
            s += k
        if nprng.bit_generator.state != meta["data_rng"]:
            raise RuntimeError(f"the batch-index stream replayed to step {step} differs from "
                               f"the snapshot's: {snap_path} belongs to another split")
        say(f"[train] resumed at step {step} from {snap_path}")
    since_snap = 0
    t_start, steps_timed = time.perf_counter(), step

    while step < total and not stop:
        k = int(min(every, total - step))
        idx = torch.as_tensor(batch_indices(nprng, n_train, bsz, k), device=dev).long()
        loss_sum = torch.zeros((), device=dev)
        for j in range(k):
            lrs = {
                "regular": lr_for_step(step + j, plateau.lr, warmup, total, f["cosine"], f["lr_min"]),
                "ssm": lr_for_step(step + j, plateau.ssm_lr, warmup, total, f["cosine"], f["lr_min"]),
                "group": f["group_lr"],
            }
            if seq is None:
                rows = idx[j] if shard is None else shard.rows(idx[j])
                x, y = gather_batch(train_data, rows)
                loss_sum += train_step(model, optimizer, x, y, lrs, sparse_k, fused, clip_norm,
                                       shard)
            else:
                x, y = gather_batch(train_data, idx[j])
                with sequence_parallel(seq):
                    loss_sum += train_step(model, optimizer, sp_inputs(x, seq),
                                           seq.steps(y) if y.dim() > 1 else y, lrs, step_k,
                                           fused, clip_norm, seq)
        step += k
        if group is not None:  # each rank's loss is its share of the global batch's
            loss_sum = group.sum(loss_sum)
        test_loss, test_perf = _evaluate_on_main(eval_model, test_data, eval_idx, sparse_k,
                                                 metric, group)
        train_loss = float(loss_sum) / k
        elapsed = time.perf_counter() - t_start
        sps = (step - steps_timed) / max(elapsed, 1e-9)
        t_start, steps_timed = time.perf_counter(), step
        say(f"step {step}: train loss {train_loss:.4f} | test loss {test_loss:.4f} | "
            f"test perf {test_perf:.4f} | {sps:.1f} steps/s")
        sys.stdout.flush()
        history.append({"step": step, "train_loss": train_loss, "test_loss": test_loss,
                        "test_perf": test_perf, "steps_per_s": sps})
        if main:
            metrics = {"train loss": train_loss, "test loss": test_loss, "test perf": test_perf,
                       "steps_per_sec": sps, "lr": plateau.lr, "ssm_lr": plateau.ssm_lr}
            # the hybrid mixers' learned mix, σ(α) (loop.py:441-447)
            for i, mixer in enumerate(hybrid):
                metrics[f"mixer_alpha_{i}"] = float(torch.sigmoid(mixer.alpha.detach())[0])
            logger.log(metrics, step=step)
        # higher is better for every metric, perplexity included, as in
        # tlie_tpu (loop.py:449, schedules.py:44)
        if test_perf > best["perf"]:
            best = {"perf": test_perf, "loss": test_loss, "step": step}
        if f["plateau"]:
            plateau = reduce_lr_on_plateau(plateau, test_perf, factor=f["reduce_factor"],
                                           patience=f["lr_patience"], lr_min=f["lr_min"])
        if f["stop_criterion"] is not None and test_perf > f["stop_criterion"]:
            say(f"Stopping: test perf {test_perf:.4f} exceeded criterion {f['stop_criterion']}")
            stop = True
        since_snap += k
        if snap_path and since_snap >= f["checkpoint_every"] and not stop and step < total:
            whole = {}
            if vocab is not None:  # the split leaves and their moments, joined
                whole = dict(zip(("state", "optimizer_state"),
                                 gather_vocab_parallel(model, vocab, optimizer)))
            if main:
                save_resume(snap_path, model, optimizer, {
                    "step": step, "plateau": tuple(plateau), "best": best, "history": history,
                    "data_rng": nprng.bit_generator.state,
                    "dropout_rng": None if dropout_gen is None else dropout_gen.get_state(),
                }, **whole)
            if world is not None:
                world.barrier()
            since_snap = 0
            say(f"[train] resume snapshot at step {step}")

    if world is not None:  # every rank has read the snapshot it resumed from
        world.barrier()
    if main and snap_path and os.path.isfile(snap_path):
        os.remove(snap_path)  # the run completed: the snapshot is obsolete
    if np.isinf(test_loss):  # no eval boundary was reached
        test_loss, test_perf = _evaluate_on_main(eval_model, test_data, eval_idx, sparse_k,
                                                 metric, group)
    say(f"Best test perf: {best['perf']:.4f} (test loss {best['loss']:.4f}, "
        f"step {best['step']})")

    if vocab is not None:  # the whole model, its split leaves gathered
        state, _ = gather_vocab_parallel(model, vocab)
        model, eval_model, _ = build_models(model_cfg, padded, generator=torch.Generator(),
                                            device=dev)
        model.load_state_dict(state)
    path = save_trained(cfg, model, test_perf, used_paths) if main else None
    if world is not None:
        path = world.broadcast(path)
    if main:
        logger.finish()
    return TrainResult(path, test_perf, model, eval_model, history, optimizer)


def _tensor_shards(n_model: int, batch_size: int) -> Tuple[Shard, Shard]:
    """The tensor-parallel route's (data, model) shards of the started
    group (:func:`~tlie_tpu_torch.parallel.mesh.mesh_2d`); raises where no
    group runs, where ``n_model`` does not divide it, or where the data
    size does not divide the batch (``tlie_tpu``'s ``loop.py:226-230``)."""
    if process_shard() is None:
        raise ValueError(f"model_parallel={n_model} needs a process group "
                         "(tlie_tpu_torch.launch starts one); this process has none")
    data, vocab = mesh_2d(n_model)
    if batch_size % data.world:
        raise ValueError(f"batch {batch_size} not divisible by data axis {data.world}")
    return data, vocab


def _whole_numel(p: torch.nn.Parameter) -> int:
    """A parameter's element count in the one-process model (a split leaf's
    times the model group's size)."""
    vocab = getattr(p, "vocab_shard", None)
    return p.numel() * (1 if vocab is None else vocab.world)


def _evaluate_on_main(eval_model, test_data, eval_idx, sparse_k, metric, shard):
    """``evaluate``'s (loss, metric), on rank 0 alone under the data-parallel
    route (data rank 0 under the tensor-parallel one: the ranks of its model
    group evaluate together) and broadcast from there over the data group,
    so every rank takes the same plateau and stopping decisions.  Under the
    sequence-parallel route every rank runs the eval on its time steps,
    inside the context (``scan_loop.py:356-363``), and rank 0's numbers are
    broadcast."""
    if shard is None:
        return evaluate(eval_model, test_data, eval_idx, sparse_k, metric)
    if shard.axis:
        with sequence_parallel(shard):
            out = evaluate(eval_model, test_data, eval_idx, sparse_k, metric, seq=shard)
        return shard.broadcast(out)
    out = evaluate(eval_model, test_data, eval_idx, sparse_k, metric) if shard.rank == 0 else None
    return shard.broadcast(out)
