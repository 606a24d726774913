"""Seed × LR sweeps stacked on one GPU: the port's counterpart of
``tlie_tpu/parallel/sweep.py`` (``run_sweep_on_mesh``), which
``python -m tlie_tpu_torch.launch --sweep_parallel`` reaches.

Sweep points whose configs agree on every key but the seed and the two
learning rates (``_PER_POINT_KEYS``, ``_group_signature``) share a group.
A group is trained in waves of at most ``_MAX_POINTS_PER_DEVICE`` points:
each point's model is built from its own seed exactly as ``build_models``
builds it for a serial run, the points' parameters are stacked on a leading
grid axis (``torch.func.stack_module_state``), and one step trains them all
(``torch.func.vmap`` over ``functional_call`` and ``grad``).  Per point: its
learning rate and ssm learning rate ((G,) tensors through the warmup/cosine
schedule and the plateau decay), its AdamW moments and global-norm clip
(:func:`stacked_adamw_step`, the arithmetic of ``torch.optim.AdamW`` and
``clip_by_global_norm_`` with the groups of ``make_family_optimizer``), its
batch stream (``np.random.default_rng(seed)`` through ``batch_indices``, as
the serial loop draws it) and its dropout masks (``vmap(randomness=
"different")``: the masks differ from a serial run's, whose generator
cannot be drawn from under ``vmap``, so a stacked point reproduces its
serial run at dropout 0, not above it).  Early stopping is masked: a point
whose test metric passes ``stop_criterion`` steps on with learning rate 0,
which leaves its parameters exactly as they are.

After training, each point is unstacked, checkpointed (a path that collides
with one already written takes the suffix ``-pN``), journaled, and
eigen-analysed from its in-memory weights.  The journal
(``<save>.sweep_journal.jsonl``, keys ``point_key``, ``path``, ``perf``)
lets a rerun skip every point it holds; the serial ``--sweep`` writes and
reads the same journal.

The stacked step runs families whose training step reaches no hand-written
kernel: the transformer with linear or norm attention.  The others'
kernels are ``autograd.Function``\\ s bound with ``ctypes``, which have no
``vmap`` rule: :func:`run_sweep` raises ``NotImplementedError`` for them,
and ``--sweep`` trains them one point after another.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, stack_module_state, vmap

from ..config import ExperimentConfig, apply_sweep_point, derive_runtime_fields, train_fields
from ..data import DATASETS
from ..device import resolve_device
from ..models.layers import Dropout
from ..models.registry import build_models
from ..training.loop import head_choice, save_trained
from ..training.scan_loop import batch_indices, eval_indices, put_dataset
from ..training.schedules import PlateauState, lr_for_step, reduce_lr_on_plateau
from ..training.state import make_family_optimizer
from ..training.steps import cross_entropy_loss, head_logits

# the keys a point may vary inside a group: the seed and the two learning
# rates, which the stacked step carries per point; any other swept key makes
# groups of its own, each trained with its own config
_PER_POINT_KEYS = (("seed",), ("train", "lr"), ("train", "ssm_lr"))

# a wave: the points one device holds at once (each point carries its own
# step transients, so this bounds the memory); the reference's
# ``max_points_per_device``
_MAX_POINTS_PER_DEVICE = 4

# the transformer's attention functions whose training step runs no port kernel
STACKED_ATTENTION = ("lin-attention", "norm-attention")


def _group_signature(cfg: ExperimentConfig) -> str:
    masked = copy.deepcopy(cfg.raw)
    for path in _PER_POINT_KEYS:
        node = masked
        for key in path[:-1]:
            node = node.get(key, {})
        node.pop(path[-1], None)
    return json.dumps(masked, sort_keys=True, default=str)


def _journal_path(cfg: ExperimentConfig) -> str:
    stem = cfg.save or "./checkpoint/sweep"
    return stem + ".sweep_journal.jsonl"


def _load_journal(path: str) -> Dict[str, Dict[str, Any]]:
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["point_key"]] = rec
    return done


def _point_key(point: Dict) -> str:
    return json.dumps({"/".join(k): v for k, v in sorted(point.items())})


def write_journal(path: str, point: Dict, ckpt: Optional[str], perf: float) -> None:
    """Append one point's line to the journal."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"point_key": _point_key(point), "path": ckpt, "perf": perf}) + "\n")


def check_stackable(model_cfg: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError``, naming the family, where the stacked
    step cannot run the model: every family but the transformer with linear
    or norm attention reaches a kernel whose ``autograd.Function`` has no
    ``vmap`` rule."""
    layer = model_cfg["layer"]
    attention = model_cfg.get("attention_fn")
    if layer != "transformer" or attention not in STACKED_ATTENTION:
        what = f"{layer} ({attention})" if layer == "transformer" else layer
        raise NotImplementedError(
            f"--sweep_parallel stacks the transformer with {' or '.join(STACKED_ATTENTION)} "
            f"only; the {what} family's kernels have no vmap rule yet (ROADMAP Queue 1 item 6): "
            "run it with --sweep, one point after another")


def run_sweep(base: ExperimentConfig, points: List[Dict], train_split, test_split, l_max: int,
              conf_args: Optional[Dict[str, Any]] = None, *, device="cuda"
              ) -> Tuple[List[Tuple[Optional[str], float]], List[Dict[str, Any]]]:
    """Train every sweep point stacked on one device (``run_sweep_on_mesh``
    on a mesh of one); then checkpoint, journal and eigen-analyse each point.
    ``train_split`` and ``test_split`` are the (inputs, labels) splits of
    the dataset, built once for all points; ``l_max`` is its sequence
    length.  Points already in the journal are skipped and their journaled
    (path, perf) returned.  Returns (results, waves): results the
    reference's ``[(checkpoint_path | None, perf)]`` in point order, waves
    one dict per trained wave with its points, steps, seconds of stacked
    training, point-steps/s and per-point histories."""
    dev = resolve_device(device)
    cfgs: List[ExperimentConfig] = []
    for point in points:
        c = apply_sweep_point(base, point)
        c.raw = derive_runtime_fields(c.raw, l_max, len(train_split[0]))
        check_stackable(c.model)
        cfgs.append(c)

    journal_path = _journal_path(base)
    done = _load_journal(journal_path)
    used_paths = {r.get("path") for r in done.values() if r.get("path")}

    groups: Dict[str, List[int]] = {}
    for i, c in enumerate(cfgs):
        groups.setdefault(_group_signature(c), []).append(i)

    results: List[Tuple[Optional[str], float]] = [(None, 0.0)] * len(points)
    waves: List[Dict[str, Any]] = []
    for members in groups.values():
        pending = [i for i in members if _point_key(points[i]) not in done]
        for i in members:
            rec = done.get(_point_key(points[i]))
            if rec is not None:
                results[i] = (rec.get("path"), rec.get("perf", 0.0))
        for w0 in range(0, len(pending), _MAX_POINTS_PER_DEVICE):
            waves.append(_run_group(cfgs, points, pending[w0:w0 + _MAX_POINTS_PER_DEVICE],
                                    train_split, test_split, results, journal_path, conf_args,
                                    used_paths, dev))
    return results, waves


class _Loss(nn.Module):
    """One point's loss through the training head, as ``train_step`` takes
    it: the dense or sparse head and the masked CE."""

    def __init__(self, model: nn.Module, sparse_k: Optional[int]):
        super().__init__()
        self.model, self.sparse_k = model, sparse_k

    def forward(self, x, y):
        return cross_entropy_loss(*head_logits(self.model, x, y, self.sparse_k))


class _Eval(nn.Module):
    """One point's (loss, metric) on one test batch, as ``evaluate`` takes them."""

    def __init__(self, model: nn.Module, sparse_k: Optional[int], metric):
        super().__init__()
        self.model, self.sparse_k, self.metric = model, sparse_k, metric

    def forward(self, x, y):
        logits, labels = head_logits(self.model, x, y, self.sparse_k)
        return cross_entropy_loss(logits, labels), self.metric(logits, labels)


def _stacked_state(cfgs: List[ExperimentConfig], members: List[int], device):
    """Each member point's model built from its own seed exactly as
    ``build_models`` builds it for a serial run (``tlie_tpu``'s
    ``_stacked_state`` vmaps its state factory over the seeds), its
    parameters and buffers stacked on a leading grid axis: (train model,
    eval model, family, params, buffers), the models those of the first
    point, the templates ``functional_call`` runs."""
    model_cfg = cfgs[members[0]].model
    built = [build_models(model_cfg, generator=torch.Generator().manual_seed(cfgs[i].seed),
                          device=device) for i in members]
    model, eval_model, family = built[0]
    params, buffers = stack_module_state([b[0] for b in built])
    return (model, eval_model, family, {k: v.detach() for k, v in params.items()},
            {k: v.detach() for k, v in buffers.items()})


def optimizer_groups(model: nn.Module, family: str, model_cfg: Dict[str, Any],
                     train_cfg: Dict[str, Any], f: Dict[str, Any]):
    """(group_of, clip_norm) for :func:`stacked_adamw_step`: each parameter's
    (optimiser group, weight decay) and the global-norm clip, as
    ``make_family_optimizer`` builds them for the serial run."""
    opt, clip_norm = make_family_optimizer(model, family, model_cfg, train_cfg, f)
    by_id = {id(p): (grp["name"], grp["weight_decay"]) for grp in opt.param_groups
             for p in grp["params"]}
    return {n: by_id[id(p)] for n, p in model.named_parameters()}, clip_norm


def _prefixed(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"model." + k: v for k, v in tree.items()}


def stacked_grads(model: nn.Module, sparse_k: Optional[int]):
    """``f(params, buffers, x, y) -> (grads, losses)`` over a stacked grid:
    params and buffers stacked on a leading axis of G points, x and y (G, B,
    L), each point's gradient of its own loss.  Dropout draws a mask per
    point (the model's dropout modules draw without a generator)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = None
    wrap = _Loss(model, sparse_k)

    def loss(p, b, x, y):
        return functional_call(wrap, (_prefixed(p), _prefixed(b)), (x, y))

    return vmap(grad_and_value(loss), randomness="different")


def stacked_eval(eval_model: nn.Module, sparse_k: Optional[int], metric):
    """``f(params, buffers, x, y) -> (losses, metrics)``, each (G,), of the
    stacked points on one shared test batch."""
    wrap = _Eval(eval_model, sparse_k, metric)

    def one(p, b, x, y):
        return functional_call(wrap, (_prefixed(p), _prefixed(b)), (x, y))

    return vmap(one, in_dims=(0, 0, None, None))


@torch.no_grad()
def stacked_adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                       moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]], step: int,
                       lrs: Dict[str, torch.Tensor], group_of: Dict[str, Tuple[str, float]],
                       betas: Tuple[float, float], clip_norm: Optional[float],
                       eps: float = 1e-8) -> torch.Tensor:
    """One optimiser step of every stacked point, in place: each point's
    gradients clipped to its own global norm ``clip_norm`` (optax's
    ``clip_by_global_norm``, as ``clip_by_global_norm_``), then
    ``torch.optim.AdamW``'s update with the point's learning rate.
    ``group_of`` maps each parameter to its optimiser group's (name, weight
    decay); ``lrs[name]`` is the group's (G,) learning rates; ``step`` counts
    from 1.  A point at learning rate 0 keeps its parameters exactly.
    Returns the (G,) gradient norms."""
    names = list(params)
    G = params[names[0]].shape[0]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(grads[n].reshape(G, -1), dim=1) for n in names], 1), dim=1)
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for n in names:
        p, g = params[n], grads[n]
        view = (G,) + (1,) * (p.dim() - 1)
        if clip_norm is not None:
            keep = (norm < clip_norm).reshape(view)
            g = torch.where(keep, g, g / norm.reshape(view) * clip_norm)
        group, wd = group_of[n]
        lr = lrs[group].reshape(view)
        m, v = moments[n]
        p.mul_(1 - lr * wd)
        m.lerp_(g, 1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / bc2 ** 0.5).add_(eps)
        p.addcdiv_(m * (-lr / bc1), denom)
    return norm


def _run_group(cfgs, points, members, train_split, test_split, results, journal_path,
               conf_args, used_paths, dev) -> Dict[str, Any]:
    """Train one wave stacked; then checkpoint, journal and eigen-analyse
    each of its points, filling ``results``.  Returns the wave's record
    (see :func:`run_sweep`)."""
    g_real = len(members)
    cfg0 = cfgs[members[0]]
    model_cfg, f = cfg0.model, train_fields(cfg0.raw)
    bsz = f["batch_size"]
    fused, sparse_k = head_choice(cfg0.raw, train_split, test_split)
    if fused:
        raise NotImplementedError("--sweep_parallel does not stack the fused head")
    metric = DATASETS[cfg0.dataset["_name_"]].get_metrics()
    print(f"[sweep] group {g_real} points on one device ({dev})")

    model, eval_model, family, params, buffers = _stacked_state(cfgs, members, dev)
    group_of, clip_norm = optimizer_groups(model, family, model_cfg, cfg0.train, f)
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    grads_fn = stacked_grads(model, sparse_k)
    eval_fn = stacked_eval(eval_model, sparse_k, metric)

    data = put_dataset(*train_split, dev)
    test = put_dataset(*test_split, dev)
    eval_idx = torch.as_tensor(eval_indices(len(test_split[0]), bsz), device=dev).long()
    nprngs = [np.random.default_rng(cfgs[i].seed) for i in members]
    plateaus = [PlateauState(cfgs[i].train["lr"], cfgs[i].train.get("ssm_lr", cfgs[i].train["lr"]),
                             0, -np.inf) for i in members]
    total, warmup = f["total_steps"], f["warmup"]
    active = np.ones(g_real, dtype=bool)
    perfs = np.zeros(g_real)
    histories: List[List[Dict[str, float]]] = [[] for _ in members]
    step, t_train = 0, 0.0
    # the dropout masks come from the device's default generator, seeded here
    # from the group's first seed, so a rerun draws the same masks
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(cfgs[members[0]].seed)
        while step < total and active.any():
            t0 = time.perf_counter()
            k = int(min(f["eval_every"], total - step))
            idx = torch.as_tensor(np.stack([batch_indices(r, len(train_split[0]), bsz, k)
                                            for r in nprngs]), device=dev).long()  # (G, k, B)
            # the period's (k, G) rates of each group, moved to the device at
            # once; frozen points step at rate 0, so their parameters stay put
            rates = {name: torch.tensor(
                [[lr_for_step(step + j, getattr(pl, attr), warmup, total, f["cosine"],
                              f["lr_min"]) if on else 0.0 for pl, on in zip(plateaus, active)]
                 for j in range(k)], device=dev)
                for name, attr in (("regular", "lr"), ("ssm", "ssm_lr"))}
            loss_sum = torch.zeros(g_real, device=dev)
            for j in range(k):
                x, y = data.inputs[idx[:, j]], data.labels[idx[:, j]]
                grads, losses = grads_fn(params, buffers, x, y)
                stacked_adamw_step(params, grads, moments, step + j + 1,
                                   {name: r[j] for name, r in rates.items()}, group_of,
                                   f["betas"], clip_norm)
                loss_sum += losses.detach()
            step += k
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_train += time.perf_counter() - t0
            with torch.no_grad():
                ev = [eval_fn(params, buffers, test.inputs[i], test.labels[i]) for i in eval_idx]
                test_loss = torch.stack([e[0] for e in ev]).mean(0).cpu().numpy()
                perf_now = torch.stack([e[1] for e in ev]).float().mean(0).cpu().numpy()
            train_loss = (loss_sum / k).cpu().numpy()
            for slot in range(g_real):
                if active[slot]:
                    perfs[slot] = perf_now[slot]
                    histories[slot].append({
                        "step": step, "train_loss": float(train_loss[slot]),
                        "test_loss": float(test_loss[slot]), "test_perf": float(perf_now[slot])})
                    if f["plateau"]:
                        plateaus[slot] = reduce_lr_on_plateau(
                            plateaus[slot], float(perf_now[slot]), factor=f["reduce_factor"],
                            patience=f["lr_patience"], lr_min=f["lr_min"])
            if f["stop_criterion"] is not None:
                newly = active & (perf_now > f["stop_criterion"])
                if newly.any():
                    print(f"[sweep] step {step}: {int(newly.sum())} point(s) hit stop "
                          f"criterion {f['stop_criterion']}")
                active &= ~newly
            print(f"[sweep] step {step}/{total}: active {int(active.sum())}/{g_real} "
                  f"| best perf {perfs.max():.4f} "
                  f"| {step * g_real / max(t_train, 1e-9):.1f} point-steps/s", flush=True)

    wave = {"points": [points[i] for i in members], "steps": step, "train_seconds": t_train,
            "point_steps_per_s": step * g_real / max(t_train, 1e-9), "histories": histories}
    # unstack, checkpoint, journal, analyse: per point
    for slot, i in enumerate(members):
        cfg_i, perf = cfgs[i], float(perfs[slot])
        state = {**{k: v[slot] for k, v in params.items()},
                 **{k: v[slot] for k, v in buffers.items()}}
        model.load_state_dict(state)
        path = save_trained(cfg_i.raw, model, perf, used_paths)
        results[i] = (path, perf)
        write_journal(journal_path, points[i], path, perf)
        if path is not None and conf_args is not None:
            from ..analysis import eval_eig

            # the in-memory weights, not a re-read of the checkpoint
            batch = test_split[0][: conf_args["batch_size"]]
            eval_eig(cfg_i.raw, conf_args, perf, model, device=dev, batch=batch)
    return wave
