"""The step-driven training loop of ``tlie_tpu/training/loop.py::train``.

Each eval period draws its (steps, batch) index matrix from
``numpy.random.default_rng(seed)`` as ``tlie_tpu`` does, runs that many
steps one at a time, evaluates the test split, prints one line with the
steps/s, tracks the best result, decays the plateau rates, and stops early
once the test metric exceeds ``stop_criterion``.  The final checkpoint goes
to ``checkpoint_name() + "-perf{:.3f}"`` as a ``.pth`` file.

The decoder head of the training steps is the dense one, the sparse one
(MQAR's few valid labels) or, with ``train.fused_xent``, the fused decoder +
CE head, chosen as ``tlie_tpu`` chooses it (``loop.py:292-350``).  The eval
runs the dense or sparse head and the dataset's metric.

Not ported yet, and refused by :func:`tlie_tpu_torch.config.train_fields`:
epoch-driven runs, data/tensor/sequence parallelism, ``checkpoint_every``/
resume; W&B logging is not carried.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from ..config import checkpoint_name, lang_model, train_fields
from ..data import DATASETS
from ..device import resolve_device
from ..models.registry import build_models
from ..ops.fused_xent import fused_xent_eligible
from .checkpoint import save_checkpoint
from .scan_loop import (
    batch_indices, eval_indices, evaluate, per_position, put_dataset, sparse_head_k_for,
)
from .schedules import PlateauState, lr_for_step, reduce_lr_on_plateau
from .state import make_family_optimizer
from .steps import train_step


class TrainResult(tuple):
    """``(checkpoint_path | None, final perf)``, the reference ``train()``
    contract, carrying the trained models as ``.model`` (train mode) and
    ``.eval_model`` (eval mode, sharing its parameters), and ``.history``,
    one dict per eval with the numbers of its printed line."""

    def __new__(cls, path, perf, model, eval_model, history):
        result = super().__new__(cls, (path, perf))
        result.model, result.eval_model, result.history = model, eval_model, history
        return result


def use_fused_head(cfg: Dict[str, Any], batch_size: int) -> bool:
    """``train.fused_xent`` on a next-token task with a per-position head
    whose (B·L, D) rows the fused head takes (``loop.py:292-325``, without
    ``tlie_tpu``'s TPU-only condition: the port runs the plain version on
    the CPU and the kernels on the card)."""
    model_cfg = cfg["model"]
    return (
        bool(cfg["train"].get("fused_xent", False))
        and bool(cfg.get("lang_model", lang_model(cfg)))
        and per_position(model_cfg)
        and fused_xent_eligible(batch_size * model_cfg["seq_len"], model_cfg["hidden_dim"],
                                model_cfg["output_dim"])
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
    if fused and cfg["model"].get("compute_dtype", "float32") != "float32":
        raise NotImplementedError("the fused head on bfloat16 operands is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    sparse_k = None
    if f["sparse_head"] and bool(cfg.get("lang_model", lang_model(cfg))) and not fused:
        sparse_k = sparse_head_k_for(cfg["model"], train_split[1], test_split[1])
    return fused, sparse_k


def train(cfg: Dict[str, Any], train_split: Tuple[np.ndarray, np.ndarray],
          test_split: Tuple[np.ndarray, np.ndarray], *, device="cuda",
          used_paths: Optional[Set[str]] = None) -> TrainResult:
    """Train the configuration ``cfg`` (a resolved config dict, runtime
    fields derived) on the (inputs, labels) splits, evaluating with the
    metric of its dataset (``cfg["dataset"]["_name_"]``); returns a
    :class:`TrainResult`.  Runs on the card unless ``device="cpu"``.
    ``used_paths`` is a sweep's set of checkpoint paths (:func:`save_trained`)."""
    dev = resolve_device(device)
    f = train_fields(cfg)
    model_cfg = cfg["model"]
    bsz = f["batch_size"]
    for name, split in (("train", train_split), ("test", test_split)):
        if len(split[0]) < bsz:
            raise ValueError(f"the {name} split holds {len(split[0])} examples, fewer than "
                             f"one batch of {bsz}")
    metric = DATASETS[cfg["dataset"]["_name_"]].get_metrics()

    model, eval_model, family = build_models(
        model_cfg, generator=torch.Generator().manual_seed(cfg["seed"]), device=dev)
    nr_params = sum(p.numel() for p in model.parameters())
    embed = getattr(model.encoder, "encoder", model.encoder)  # the SSM backbone nests it
    nr_encoder = sum(p.numel() for p in embed.parameters())
    print(f"Nr. of parameters: {nr_params} (encoder: {nr_encoder})")
    optimizer, clip_norm = make_family_optimizer(model, family, model_cfg, cfg["train"], f)

    train_data = put_dataset(*train_split, dev)
    test_data = put_dataset(*test_split, dev)
    fused, sparse_k = head_choice(cfg, train_split, test_split)
    if fused:
        print("[train] fused decoder+softmax-CE head enabled")
    if sparse_k is not None:
        print(f"[train] sparse decoder head: K={sparse_k} of L={model_cfg['seq_len']}")
    eval_idx = torch.as_tensor(eval_indices(len(test_split[0]), bsz), device=dev).long()
    nprng = np.random.default_rng(cfg["seed"])

    total, warmup = f["total_steps"], f["warmup"]
    plateau = PlateauState(f["lr"], f["ssm_lr"], 0, -np.inf)
    step, stop = 0, False
    best_perf = -np.inf
    test_perf, test_loss = 0.0, np.inf
    t_start, steps_timed = time.perf_counter(), 0
    history = []

    while step < total and not stop:
        k = int(min(f["eval_every"], total - step))
        idx = torch.as_tensor(batch_indices(nprng, len(train_split[0]), bsz, k), device=dev).long()
        loss_sum = torch.zeros((), device=dev)
        for j in range(k):
            lrs = {
                "regular": lr_for_step(step + j, plateau.lr, warmup, total, f["cosine"], f["lr_min"]),
                "ssm": lr_for_step(step + j, plateau.ssm_lr, warmup, total, f["cosine"], f["lr_min"]),
            }
            x, y = train_data.inputs[idx[j]], train_data.labels[idx[j]]
            loss_sum += train_step(model, optimizer, x, y, lrs, sparse_k, fused, clip_norm)
        step += k
        test_loss, test_perf = evaluate(eval_model, test_data, eval_idx, sparse_k, metric)
        train_loss = float(loss_sum) / k
        elapsed = time.perf_counter() - t_start
        sps = (step - steps_timed) / max(elapsed, 1e-9)
        t_start, steps_timed = time.perf_counter(), step
        print(f"step {step}: train loss {train_loss:.4f} | test loss {test_loss:.4f} | "
              f"test perf {test_perf:.4f} | {sps:.1f} steps/s")
        sys.stdout.flush()
        history.append({"step": step, "train_loss": train_loss, "test_loss": test_loss,
                        "test_perf": test_perf, "steps_per_s": sps})
        # higher is better for every metric, perplexity included, as in
        # tlie_tpu (loop.py:449, schedules.py:44)
        best_perf = max(best_perf, test_perf)
        if f["plateau"]:
            plateau = reduce_lr_on_plateau(plateau, test_perf, factor=f["reduce_factor"],
                                           patience=f["lr_patience"], lr_min=f["lr_min"])
        if f["stop_criterion"] is not None and test_perf > f["stop_criterion"]:
            print(f"Stopping: test perf {test_perf:.4f} exceeded criterion {f['stop_criterion']}")
            stop = True

    if np.isinf(test_loss):  # no eval boundary was reached
        test_loss, test_perf = evaluate(eval_model, test_data, eval_idx, sparse_k, metric)
    print(f"Best test perf: {best_perf:.4f}")

    path = save_trained(cfg, model, test_perf, used_paths)
    return TrainResult(path, test_perf, model, eval_model, history)
