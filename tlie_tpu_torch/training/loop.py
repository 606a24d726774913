"""The step-driven training loop of ``tlie_tpu/training/loop.py::train``.

Each eval period draws its (steps, batch) index matrix from
``numpy.random.default_rng(seed)`` as ``tlie_tpu`` does, runs that many
steps one at a time, evaluates the test split, prints one line with the
steps/s, tracks the best result, decays the plateau rates, and stops early
once the test metric exceeds ``stop_criterion``.  The final checkpoint goes
to ``checkpoint_name() + "-perf{:.3f}"`` as a ``.pth`` file.

Not ported yet, and refused by :func:`tlie_tpu_torch.config.train_fields`:
epoch-driven runs, data/tensor/sequence parallelism, the fused head,
``checkpoint_every``/resume; W&B logging is not carried.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import checkpoint_name, lang_model, train_fields
from ..device import resolve_device
from ..models.registry import build_models
from .checkpoint import save_checkpoint
from .scan_loop import batch_indices, eval_indices, evaluate, put_dataset, sparse_head_k_for
from .schedules import PlateauState, lr_for_step, reduce_lr_on_plateau
from .state import make_optimizer
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


def train(cfg: Dict[str, Any], train_split: Tuple[np.ndarray, np.ndarray],
          test_split: Tuple[np.ndarray, np.ndarray], *, device="cuda") -> TrainResult:
    """Train the configuration ``cfg`` (a resolved config dict, runtime
    fields derived) on the (inputs, labels) splits; returns a
    :class:`TrainResult`.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    f = train_fields(cfg)
    model_cfg = cfg["model"]
    bsz = f["batch_size"]

    model, eval_model, _ = build_models(
        model_cfg, generator=torch.Generator().manual_seed(cfg["seed"]), device=dev)
    nr_params = sum(p.numel() for p in model.parameters())
    nr_encoder = sum(p.numel() for p in model.encoder.encoder.parameters())
    print(f"Nr. of parameters: {nr_params} (encoder: {nr_encoder})")
    optimizer = make_optimizer(model, model_cfg.get("ssm_lr_vars", []), f["lr"],
                               f["ssm_lr"], f["wd"], f["betas"])

    train_data = put_dataset(*train_split, dev)
    test_data = put_dataset(*test_split, dev)
    sparse_k = None
    if f["sparse_head"] and bool(cfg.get("lang_model", lang_model(cfg))):
        sparse_k = sparse_head_k_for(model_cfg, train_split[1], test_split[1])
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
            loss_sum += train_step(model, optimizer, x, y, lrs, sparse_k)
        step += k
        test_loss, test_perf = evaluate(eval_model, test_data, eval_idx, sparse_k)
        train_loss = float(loss_sum) / k
        elapsed = time.perf_counter() - t_start
        sps = (step - steps_timed) / max(elapsed, 1e-9)
        t_start, steps_timed = time.perf_counter(), step
        print(f"step {step}: train loss {train_loss:.4f} | test loss {test_loss:.4f} | "
              f"test perf {test_perf:.4f} | {sps:.1f} steps/s")
        sys.stdout.flush()
        history.append({"step": step, "train_loss": train_loss, "test_loss": test_loss,
                        "test_perf": test_perf, "steps_per_s": sps})
        best_perf = max(best_perf, test_perf)
        if f["plateau"]:
            plateau = reduce_lr_on_plateau(plateau, test_perf, factor=f["reduce_factor"],
                                           patience=f["lr_patience"], lr_min=f["lr_min"])
        if f["stop_criterion"] is not None and test_perf > f["stop_criterion"]:
            print(f"Stopping: test perf {test_perf:.4f} exceeded criterion {f['stop_criterion']}")
            stop = True

    if np.isinf(test_loss):  # no eval boundary was reached
        test_loss, test_perf = evaluate(eval_model, test_data, eval_idx, sparse_k)
    print(f"Best test perf: {best_perf:.4f}")

    path = None
    stem = checkpoint_name(cfg)
    if stem is not None:
        tree = {"model": dict(model_cfg), "train": dict(cfg["train"]), "data": dict(cfg["dataset"])}
        path = save_checkpoint(stem + f"-perf{test_perf:0.3f}", model, tree)
    return TrainResult(path, test_perf, model, eval_model, history)
