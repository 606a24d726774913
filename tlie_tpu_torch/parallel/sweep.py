"""Seed × LR sweeps stacked on one GPU, or spread over the ranks of a
process group: the port's counterpart of ``tlie_tpu/parallel/sweep.py``
(``run_sweep_on_mesh``), which ``python -m tlie_tpu_torch.launch
--sweep_parallel`` reaches.

Sweep points whose configs agree on every key but the seed and the two
learning rates (``_PER_POINT_KEYS``, ``_group_signature``) share a group.
A group is trained in waves of at most ``_MAX_POINTS_PER_DEVICE`` points:
each point's model is built from its own seed exactly as ``build_models``
builds it for a serial run, the points' parameters are stacked on a leading
grid axis (``torch.func.stack_module_state``), and one step trains them all
(``torch.func.vmap`` over ``functional_call`` and ``grad``).  Every family
stacks: the LRU, S5 and S4 (their ``{ssm, regular}`` groups, no clip,
BatchNorm statistics stacked per point), the Mamba family (Mamba-2,
``SSD_LTI``, Mamba-1, bfloat16 compute) and the transformer (softmax through
the flash kernels or materialised, linear, norm, the classifier and dual
heads), padded splits with their lengths.  The kernels' autograd Functions
have ``vmap`` rules (``ops/_grid.py``) that fold the grid into each kernel's
batch axis, so a stacked step launches each kernel as often as one serial
step does, whatever the number of points.  ``train.fused_xent`` trains
stacked through the dense head, or the sparse one where
``sparse_head_k_for`` gives a K, as ``tlie_tpu``'s stacked block does.

Per point: its learning rate and ssm learning rate ((G,) tensors through
the warmup/cosine schedule and the plateau decay), its AdamW moments and
global-norm clip (:func:`stacked_adamw_step`, the arithmetic of
``torch.optim.AdamW`` and ``clip_by_global_norm_`` with the groups of
``make_family_optimizer``, ``train.param_group``'s ``MultiSteps`` group
included: :class:`StackedMultiSteps`), its batch stream
(``np.random.default_rng(seed)`` through ``batch_indices``, as the serial
loop draws it) and its dropout masks (``vmap(randomness="different")``: the
masks differ from a serial run's, whose generator cannot be drawn from under
``vmap``, so a stacked point reproduces its serial run at dropout 0, not
above it).  Early stopping is masked: a point whose test metric passes
``stop_criterion`` steps on with learning rate 0 (its param group's too),
which leaves its parameters exactly as they are.

In a process group (``launch`` on several cards, ``--nproc`` or
``torchrun``; :mod:`tlie_tpu_torch.parallel.mesh`) a wave holds up to
``_MAX_POINTS_PER_DEVICE`` points a rank, padded with copies of its last
point to a multiple of the world size, as ``run_sweep_on_mesh`` pads the
grid to the device count (``sweep.py:203-235``): each rank stacks its share
on its own device, rank 0 gathers the trained points, drops the padding,
and writes every checkpoint, journal line and eigen-analysis; the others
wait.  Each point trains as in the one-process wave (its dropout masks
aside, which each rank draws from the default generator seeded from its
share's first seed).

After training, each point is unstacked, checkpointed (a path that collides
with one already written takes the suffix ``-pN``), journaled, and
eigen-analysed from its in-memory weights.  The journal
(``<save>.sweep_journal.jsonl``, keys ``point_key``, ``path``, ``perf``)
lets a rerun skip every point it holds; the serial ``--sweep`` writes and
reads the same journal.

Where the port departs from ``tlie_tpu``'s stacked block (ROADMAP Queue 3):
it carries a padded split's lengths (the reference's block puts inputs and
labels alone on the device and its padded model raises), it steps
``train.param_group`` at the config's ``group_lr`` (the reference's block
takes ``make_train_block``'s default 1e-3), and an epoch-driven config's
``warmup`` counts epochs, as in the serial loop (the reference's block reads
it as steps).
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
from ..training.loop import _device_split, save_trained
from ..training.scan_loop import batch_indices, eval_indices, gather_batch, sparse_head_k_for
from ..training.schedules import PlateauState, lr_for_step, reduce_lr_on_plateau
from ..training.state import GROUP, OPTAX_BETAS, make_family_optimizer
from ..training.steps import cross_entropy_loss, head_logits
from .mesh import process_shard

# the keys a point may vary inside a group: the seed and the two learning
# rates, which the stacked step carries per point; any other swept key makes
# groups of its own, each trained with its own config
_PER_POINT_KEYS = (("seed",), ("train", "lr"), ("train", "ssm_lr"))

# a wave: the points one device holds at once (each point carries its own
# step transients, so this bounds the memory); the reference's
# ``max_points_per_device``
_MAX_POINTS_PER_DEVICE = 4


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


def run_sweep(base: ExperimentConfig, points: List[Dict], train_split, test_split, l_max: int,
              conf_args: Optional[Dict[str, Any]] = None, *, device="cuda"
              ) -> Tuple[List[Tuple[Optional[str], float]], List[Dict[str, Any]]]:
    """Train every sweep point stacked on one device (``run_sweep_on_mesh``
    on a mesh of one); then checkpoint, journal and eigen-analyse each point.
    ``train_split`` and ``test_split`` are the (inputs, labels) splits of
    the dataset, built once for all points, or (inputs, labels, lengths)
    for a padded config; ``l_max`` is its sequence
    length.  Points already in the journal are skipped and their journaled
    (path, perf) returned.  Returns (results, waves): results the
    reference's ``[(checkpoint_path | None, perf)]`` in point order, waves
    one dict per trained wave with its points, steps, seconds of stacked
    training, point-steps/s and per-point histories."""
    dev = resolve_device(device)
    shard = process_shard()
    cfgs: List[ExperimentConfig] = []
    for point in points:
        c = apply_sweep_point(base, point)
        c.raw = derive_runtime_fields(c.raw, l_max, len(train_split[0]))
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
        wave = _MAX_POINTS_PER_DEVICE * (shard.world if shard is not None else 1)
        for w0 in range(0, len(pending), wave):
            waves.append(_run_group(cfgs, points, pending[w0:w0 + wave], train_split,
                                    test_split, results, journal_path, conf_args, used_paths,
                                    dev, shard))
    if shard is not None:  # rank 0's results and records on every rank
        results, waves = shard.broadcast((results, waves))
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


def _stacked_state(cfgs: List[ExperimentConfig], members: List[int], device,
                   padded: bool = False):
    """Each member point's model built from its own seed exactly as
    ``build_models`` builds it for a serial run (``tlie_tpu``'s
    ``_stacked_state`` vmaps its state factory over the seeds), its
    parameters and buffers stacked on a leading grid axis: (train model,
    eval model, family, params, buffers), the models those of the first
    point, the templates ``functional_call`` runs."""
    model_cfg = cfgs[members[0]].model
    built = [build_models(model_cfg, padded,
                          generator=torch.Generator().manual_seed(cfgs[i].seed), device=device)
             for i in members]
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


class StackedMultiSteps:
    """``optax.MultiSteps`` of ``train.param_group``'s leaves for a stacked
    grid (``MultiStepsAdamW``'s, each leaf (G, ...)): the running mean of
    each leaf's gradients, the mini-step and the count of the group's AdamW
    steps, which the grid's points share (they step together)."""

    def __init__(self, params: Dict[str, torch.Tensor], names: List[str], every_k: int):
        self.every_k, self.mini_step, self.count = every_k, 0, 0
        self.acc = {n: torch.zeros_like(params[n]) for n in names}


def _adamw_(p, g, moments, lr, wd: float, betas, t: int, eps: float) -> None:
    """``torch.optim.AdamW``'s update of one stacked leaf at step ``t``."""
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    m, v = moments
    p.mul_(1 - lr * wd)
    m.lerp_(g, 1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / bc2 ** 0.5).add_(eps)
    p.addcdiv_(m * (-lr / bc1), denom)


@torch.no_grad()
def stacked_adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                       moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]], step: int,
                       lrs: Dict[str, torch.Tensor], group_of: Dict[str, Tuple[str, float]],
                       betas: Tuple[float, float], clip_norm: Optional[float],
                       eps: float = 1e-8,
                       multi_steps: Optional[StackedMultiSteps] = None) -> torch.Tensor:
    """One optimiser step of every stacked point, in place: each point's
    gradients clipped to its own global norm ``clip_norm`` (optax's
    ``clip_by_global_norm``, as ``clip_by_global_norm_``), then
    ``torch.optim.AdamW``'s update with the point's learning rate.
    ``group_of`` maps each parameter to its optimiser group's (name, weight
    decay); ``lrs[name]`` is the group's (G,) learning rates; ``step`` counts
    from 1.  The leaves of ``train.param_group``'s group (``GROUP``) go
    through ``multi_steps`` instead: outside the clip, their gradients
    averaged over its ``every_k`` steps and applied on the last with optax's
    default betas and the group's own step count.  A point at learning rate
    0 keeps its parameters exactly.  Returns the (G,) gradient norms of the
    clipped leaves."""
    names = list(params)
    G = params[names[0]].shape[0]
    clipped = [n for n in names if group_of[n][0] != GROUP]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(grads[n].reshape(G, -1), dim=1) for n in clipped], 1), dim=1)
    emit = multi_steps is not None and multi_steps.mini_step == multi_steps.every_k - 1
    for n in names:
        p, g = params[n], grads[n]
        view = (G,) + (1,) * (p.dim() - 1)
        group, wd = group_of[n]
        if group == GROUP:
            acc = multi_steps.acc[n]
            acc.add_((g - acc) / (multi_steps.mini_step + 1))
            if not emit:
                continue
            g = acc.clone()
            acc.zero_()
            group_betas, t = OPTAX_BETAS, multi_steps.count + 1
        else:
            if clip_norm is not None:
                keep = (norm < clip_norm).reshape(view)
                g = torch.where(keep, g, g / norm.reshape(view) * clip_norm)
            group_betas, t = betas, step
        _adamw_(p, g, moments[n], lrs[group].reshape(view), wd, group_betas, t, eps)
    if multi_steps is not None:
        multi_steps.mini_step = 0 if emit else multi_steps.mini_step + 1
        multi_steps.count += int(emit)
    return norm


def _run_group(cfgs, points, members, train_split, test_split, results, journal_path,
               conf_args, used_paths, dev, shard=None) -> Optional[Dict[str, Any]]:
    """Train one wave stacked (in a process group: each rank its share of
    the padded wave, gathered on rank 0); then checkpoint, journal and
    eigen-analyse each of its points, filling ``results``, on rank 0.
    Returns the wave's record (see :func:`run_sweep`) on rank 0, None on
    the others."""
    g_real = len(members)
    mine = members
    if shard is not None:
        per = -(-g_real // shard.world)
        padded_wave = members + [members[-1]] * (per * shard.world - g_real)
        mine = padded_wave[shard.rank * per:(shard.rank + 1) * per]
    model, *trained = _train_wave(cfgs, mine, train_split, test_split, dev)
    if shard is not None:
        gathered = shard.gather(trained)
        if shard.rank != 0:
            shard.barrier()  # rank 0 writes the wave's files
            return None
        trained = _join_shares(gathered, g_real)
    states, perfs, histories, step, t_train = trained
    wave = {"points": [points[i] for i in members], "steps": step, "train_seconds": t_train,
            "point_steps_per_s": step * g_real / max(t_train, 1e-9), "histories": histories}
    # checkpoint, journal, analyse: per point
    for slot, i in enumerate(members):
        cfg_i, perf = cfgs[i], float(perfs[slot])
        model.load_state_dict(states[slot])
        path = save_trained(cfg_i.raw, model, perf, used_paths)
        results[i] = (path, perf)
        write_journal(journal_path, points[i], path, perf)
        if path is not None and conf_args is not None:
            from ..analysis import eval_eig

            # the in-memory weights, not a re-read of the checkpoint
            batch = test_split[0][: conf_args["batch_size"]]
            eval_eig(cfg_i.raw, conf_args, perf, model, device=dev, batch=batch)
    if shard is not None:
        shard.barrier()
    return wave


def _join_shares(shares, g_real: int):
    """The ranks' trained shares (states, perfs, histories, steps, seconds)
    as one wave of ``g_real`` points, in point order, the padding dropped;
    the wave's steps and seconds its slowest rank's."""
    states = [st for share in shares for st in share[0]][:g_real]
    perfs = np.concatenate([share[1] for share in shares])[:g_real]
    histories = [h for share in shares for h in share[2]][:g_real]
    return (states, perfs, histories, max(share[3] for share in shares),
            max(share[4] for share in shares))


def _train_wave(cfgs, members, train_split, test_split, dev):
    """Train the points ``members`` stacked on ``dev``.  Returns (the first
    point's train model, the template of the wave's checkpoints; each
    point's trained state on the CPU; their final test metrics; their
    histories; the steps taken; the seconds of stacked training)."""
    g_real = len(members)
    cfg0 = cfgs[members[0]]
    model_cfg, f = cfg0.model, train_fields(cfg0.raw)
    if f["sequence_parallel"] > 1:  # a stacked wave holds every point's whole sequences
        raise ValueError("a stacked sweep does not take train.sequence_parallel")
    bsz = f["batch_size"]
    padded = bool(cfg0.train.get("padded", False))
    # the heads of tlie_tpu's stacked block (sweep.py:256-262): the sparse one
    # where it applies, else the dense one; train.fused_xent takes no part
    sparse_k = (sparse_head_k_for(model_cfg, train_split[1], test_split[1])
                if f["sparse_head"] else None)
    metric = DATASETS[cfg0.dataset["_name_"]].get_metrics()
    print(f"[sweep] group {g_real} points on one device ({dev})")

    model, eval_model, family, params, buffers = _stacked_state(cfgs, members, dev, padded)
    group_of, clip_norm = optimizer_groups(model, family, model_cfg, cfg0.train, f)
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    in_group = [n for n, (g, _) in group_of.items() if g == GROUP]
    multi_steps = (StackedMultiSteps(params, in_group, int(cfg0.train.get("update_step", 1)))
                   if in_group else None)
    grads_fn = stacked_grads(model, sparse_k)
    eval_fn = stacked_eval(eval_model, sparse_k, metric)

    data = _device_split(train_split, dev, padded)
    test = _device_split(test_split, dev, padded)
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
            # train.param_group's fixed rate (no schedule), 0 for a frozen point
            rates[GROUP] = torch.tensor([[f["group_lr"] if on else 0.0 for on in active]] * k,
                                        device=dev)
            loss_sum = torch.zeros(g_real, device=dev)
            for j in range(k):
                x, y = gather_batch(data, idx[:, j])
                grads, losses = grads_fn(params, buffers, x, y)
                stacked_adamw_step(params, grads, moments, step + j + 1,
                                   {name: r[j] for name, r in rates.items()}, group_of,
                                   f["betas"], clip_norm, multi_steps=multi_steps)
                loss_sum += losses.detach()
            step += k
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_train += time.perf_counter() - t0
            with torch.no_grad():
                ev = [eval_fn(params, buffers, *gather_batch(test, i)) for i in eval_idx]
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

    states = [{k: v[slot].cpu() for k, v in {**params, **buffers}.items()}
              for slot in range(g_real)]
    return model, states, perfs, histories, step, t_train
