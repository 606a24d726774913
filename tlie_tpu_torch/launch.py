"""Train, then eigen-analyse: the port's counterpart of the root ``launch.py``.

    python -m tlie_tpu_torch.launch --config configs/tasks/mqar/mqar-lru.yaml \\
        --analysis_config configs/analysis/mqar.yaml [--device cpu]

The model families are the SSM backbones, the LRU (``layer: lru``), S5
(``layer: s5``, e.g. ``configs/tasks/mqar/mqar-s5.yaml`` and the CPU-sized
``configs/mqar-s5-small.yaml``) and S4 (``layer: s4``, ``mqar-s4.yaml``,
``mqar-s4-small.yaml``), Mamba-2 (``layer: mamba``,
e.g. ``configs/tasks/mqar/mqar-mamba2.yaml``) and Mamba-1 (``version:
mamba1``, ``configs/mqar-mamba1-small.yaml``), and the transformer (``layer:
transformer``) with softmax attention (``attention_fn: sm-attention``, e.g.
``configs/tasks/mqar/mqar-sm-attention.yaml``), linear attention
(``lin-attention``, e.g. ``configs/tasks/mqar/mqar-lin-attention.yaml`` and
the CPU-sized ``configs/mqar-lin-attention-small.yaml``) or norm attention
(``norm-attention``, e.g. ``configs/tasks/mqar/mqar-norm-attention-conv.yaml``,
and the WikiText LM ``configs/wikitext-norm-attention-short.yaml`` with the
MLP mixer, analysed with ``configs/analysis/wikitext.yaml``):

    python -m tlie_tpu_torch.launch --config configs/tasks/mqar/mqar-lin-attention.yaml \\
        --analysis_config configs/analysis/mqar.yaml

The LRA ListOps classifiers, S5 and S4 (``configs/tasks/listops/listops-s5.yaml``,
``listops-s4.yaml``: padded sequences, a masked mean pool, epoch-driven),
run the same way with ``configs/analysis/listops.yaml``; ``--resume`` picks
a run up from its resume snapshot (the config's ``train.checkpoint_every``
writes one every so many steps, at an epoch's end):

    python -m tlie_tpu_torch.launch --config configs/tasks/listops/listops-s5.yaml \
        --analysis_config configs/analysis/listops.yaml [--resume]

Sequential CIFAR-10 (``configs/tasks/cifar/*.yaml``: the Mamba-2
classifier ``cifar-mamba2.yaml``, its pseudo-LTI variant
``cifar-mamba2-pseudoLTI.yaml``, ``cifar-s4.yaml``, ``cifar-s5.yaml``,
``cifar-lru.yaml``; grayscale pixels through a dense encoder, a mean pool,
epoch-driven) runs with ``configs/analysis/cifar.yaml``.  Its images are
read from the CIFAR-10 files under ``data/cifar`` (``dataset.data_dir``);
where they are missing, as in this repository, the loader prints so and
trains on its class-conditional synthetic split (2,048 / 512 images), as
``tlie_tpu`` does; ``dataset.synthetic: true`` in a copy of the config
asks for that split without the message:

    python -m tlie_tpu_torch.launch --config tasks/cifar/cifar-mamba2.yaml \
        --analysis_config configs/analysis/cifar.yaml

The transformer classifiers (``classifier: true``, a pooled
``ClassifierHead``; ``use_gate`` for the SiLU gate) run on CIFAR's
tokenized pixels (``cifar-sm-attention.yaml``, ``cifar-lin-attention*.yaml``)
and on the padded ListOps and IMDB tokens, as do the ListOps and IMDB
Mamba-2 (``listops-mamba2.yaml``, ``imdb-mamba2.yaml``): both families take
``(tokens, lengths)`` and drop the lengths.  IMDB (``configs/tasks/imdb/``,
analysed with ``configs/analysis/imdb.yaml``) reads the aclImdb folders
under ``dataset.data_dir`` or, where there are none, prints so and trains on
the loader's synthetic corpus:

    python -m tlie_tpu_torch.launch --config tasks/imdb/imdb-mamba2.yaml \
        --analysis_config configs/analysis/imdb.yaml

PathFinder's S4 (``tasks/pathfinder/pathfinder-s4.yaml``: (n, 1024, 1)
pixels), AAN's dual transformer (``tasks/aan/aan-transformer.yaml``: pairs
of char tokens (n, 2, 4000), folded into the batch and joined by the
``MATCH`` head) and the Speech Commands S5 (``sc-s5-mfcc.yaml``: 161 MFCC
frames of 20) read the lra_release and Speech Commands files under
``dataset.data_dir`` or, where there are none, as in this repository, the
loaders' synthetic splits; no analysis config is named for them, and
``configs/analysis/listops.yaml`` serves:

    python -m tlie_tpu_torch.launch --config tasks/aan/aan-transformer.yaml \
        --analysis_config configs/analysis/listops.yaml

``--config`` paths resolve against ``configs/`` first, then as given.  The
run trains on the card unless ``--device cpu`` is given (a CUDA request
without a card raises), writes the checkpoint named by the config's
``save``, and runs ``eval_eig`` of the trained weights into the analysis
config's ``save_path``.  The datasets are those of
:data:`tlie_tpu_torch.data.DATASETS`, the ``SequenceDataset`` registry (MQAR,
WikiText, ListOps, CIFAR-10, MNIST, IMDB, PathFinder, AAN, Speech
Commands).  Each run logs its evals to ``./logs/<run name>.jsonl``
(:class:`tlie_tpu_torch.utils.RunLogger`); a config's ``wandb`` section
names the run and is logged locally, as the port has no W&B sink.
``--profile DIR`` traces the whole run with ``torch.profiler``
(:func:`tlie_tpu_torch.utils.profile_trace`) into a Chrome trace in ``DIR``.

Data parallelism (``tlie_tpu``'s ``_data_mesh``, on by default): on a
machine with more than one visible card, a run whose batch the card count
divides (and whose ``train.data_parallel`` is not false) starts one process
per card, NCCL between them; each trains on its rows of every batch, and
rank 0 evaluates, checkpoints, logs and eigen-analyses
(:mod:`tlie_tpu_torch.parallel.mesh`).  ``--nproc N`` asks for N processes
(``--nproc 1`` runs the route in a group of one); with ``--device cpu``
they are N gloo processes.  Under ``torchrun`` each process joins the group ``torchrun`` describes.
``--sweep_parallel`` spreads each wave's points over the processes.  With
one card and no ``--nproc`` nothing changes:

    python -m tlie_tpu_torch.launch --config configs/mqar-lru-small.yaml --device cpu --nproc 4
    torchrun --nproc_per_node 8 -m tlie_tpu_torch.launch --config tasks/mqar/mqar-lru.yaml

Vocab tensor parallelism (``train.model_parallel: m``): the launcher
starts W processes, W the ``--nproc`` given or every visible card (m with
``--device cpu`` and no ``--nproc``), m dividing W; rank r holds the
vocabulary rows of model index r % m and the batch rows of data index
r // m (:mod:`tlie_tpu_torch.parallel.tp`):

    python -m tlie_tpu_torch.launch --config <a config with it> --device cpu --nproc 4
    torchrun --nproc_per_node 8 -m tlie_tpu_torch.launch --config <a config with it>

Sequence parallelism (``train.sequence_parallel: N``, the LRU, S5,
Mamba-1 and the transformer): the launcher starts N processes, one per card
(NCCL), or N gloo processes with ``--device cpu``; each holds L/N time steps
of every sequence (:mod:`tlie_tpu_torch.parallel.sp`).  A ``--nproc`` other
than N raises; under ``torchrun`` the group must hold N processes:

    python -m tlie_tpu_torch.launch --config configs/mqar-lru-small.yaml --device cpu \
        (with train.sequence_parallel: 4 in the config)
    torchrun --nproc_per_node 4 -m tlie_tpu_torch.launch --config <a config with it>

``--sweep`` takes a sweep file (``base_config`` + ``sweep`` lists, e.g.
``configs/sweep/mqar-lin-attention-seeds-lrs-8k.yaml``), builds the dataset
once, and trains and analyses its points one after another, each with
``apply_sweep_point``, ``derive_runtime_fields``, ``train`` and ``eval_eig``;
``--sweep_parallel`` (which implies ``--sweep``) trains the points stacked on
one device instead (:func:`tlie_tpu_torch.parallel.run_sweep`, every
family: each kernel launches once a stacked step for all the points).  Both
journal each finished point in ``<save>.sweep_journal.jsonl`` and skip the
points a rerun finds there:

    python -m tlie_tpu_torch.launch --config sweep/mqar-lin-attention-seeds-lrs-8k.yaml \\
        --sweep_parallel --analysis_config configs/analysis/mqar.yaml
    python -m tlie_tpu_torch.launch --config sweep/wikitext-norm-attention-seeds-lrs.yaml \\
        --sweep_parallel --analysis_config configs/analysis/wikitext.yaml
    python -m tlie_tpu_torch.launch --config sweep/mqar-mamba2-layers.yaml \\
        --sweep_parallel --analysis_config configs/analysis/mqar.yaml
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

from .config import apply_sweep_point, derive_runtime_fields, expand_sweep, load_sweep, load_yaml
from .device import resolve_device
from .parallel import mesh


def _resolve(path: str) -> Path:
    for cand in (Path("configs") / path, Path(path)):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"Config not found: {path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True, help="experiment config file")
    parser.add_argument("--analysis_config", type=str, default="no-analysis")
    parser.add_argument("--sweep", action="store_true", default=False)
    parser.add_argument("--sweep_parallel", action="store_true", default=False,
                        help="train the sweep's points stacked on one device, any family "
                             "(at most 4 points a wave, one kernel launch a step for all)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="trace the run with torch.profiler into a Chrome trace in DIR")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="resume from the run's mid-training snapshot if one exists "
                             "(requires train.checkpoint_every in the config)")
    parser.add_argument("--nproc", type=int, default=None,
                        help="data-parallel processes (default: one per visible card where "
                             "more than one is visible and the batch divides; with --device "
                             "cpu, N gloo processes); train.sequence_parallel: N takes N; "
                             "train.model_parallel: m takes every card, or m on the CPU")
    args = parser.parse_args(argv)

    base = sweep = None
    if args.sweep or args.sweep_parallel:
        base, sweep = load_sweep(_resolve(args.config), config_root="configs")
        cfg = base.raw
    else:
        cfg = load_yaml(_resolve(args.config))
    if mesh.launched():
        device = mesh.init_process_group(args.device)
    else:
        n = _processes(args, cfg)
        if n > 1:
            return mesh.spawn(["-m", "tlie_tpu_torch.launch",
                               *(sys.argv[1:] if argv is None else argv)], n)
        if n == 1:  # the route in a group of one
            device = mesh.init_process_group(
                args.device, rank=0, world_size=1,
                init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
        else:
            device = resolve_device(args.device)
    try:
        return _run(args, cfg, base, sweep, device)
    finally:
        mesh.destroy_process_group()


def _processes(args, cfg) -> int:
    """How many processes the run takes: under ``train.model_parallel: m``
    above 1, ``--nproc`` or else every visible card (``tlie_tpu``'s mesh
    takes every local device), m on the CPU, raising where m does not
    divide it, where fewer cards are visible, or beside ``--sweep_parallel``;
    ``train.sequence_parallel``'s N where it is above 1 (a ``--nproc`` that
    differs raises, and so does a card run with fewer than N cards);
    ``--nproc``; else, on the card, one per visible card where more than
    one is visible and the data-parallel route applies (``tlie_tpu`` shards
    over every local device by default); else none (0: no process
    group)."""
    sp = int(cfg["train"].get("sequence_parallel") or 1)
    mp = int(cfg["train"].get("model_parallel") or 1)
    if mp > 1 and sp == 1:
        if args.sweep_parallel:
            raise ValueError("--sweep_parallel and train.model_parallel exclude each other")
        card = torch.device(args.device).type == "cuda" and torch.cuda.is_available()
        n = args.nproc if args.nproc is not None else (
            torch.cuda.device_count() if card else mp)
        if n % mp:
            raise ValueError(f"{n} processes not divisible by model_parallel={mp}")
        if card and torch.cuda.device_count() < n:
            raise ValueError(f"train.model_parallel takes one card a process: {n} processes, "
                             f"{torch.cuda.device_count()} cards visible")
        return n
    if sp > 1:
        if args.nproc is not None and args.nproc != sp:
            raise ValueError(f"--nproc {args.nproc} differs from train.sequence_parallel {sp}")
        if args.sweep_parallel:
            raise ValueError("--sweep_parallel and train.sequence_parallel exclude each other")
        if torch.device(args.device).type == "cuda" and torch.cuda.is_available() \
                and torch.cuda.device_count() < sp:
            raise ValueError(f"train.sequence_parallel {sp} takes one card a process; "
                             f"{torch.cuda.device_count()} visible")
        return sp
    if args.nproc is not None:
        return args.nproc
    if torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
        return 0
    n = torch.cuda.device_count()
    if n < 2:
        return 0
    if args.sweep_parallel:
        return n
    train = cfg["train"]
    return n if bool(train.get("data_parallel", True)) and int(train["batch_size"]) % n == 0 else 0


def _run(args, cfg, base, sweep, device) -> int:
    main_rank = mesh.is_main()
    print(f"Using config {args.config}")
    wandb_config = cfg.pop("wandb", None)
    if args.resume:
        cfg["train"]["resume"] = True
    do_analysis = args.analysis_config != "no-analysis"
    conf_args = load_yaml(_resolve(args.analysis_config)) if do_analysis else None

    from .data import DATASETS

    name = cfg["dataset"].get("_name_")
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    # the dataset is built once and shared by every sweep point
    data = DATASETS[name](**cfg["dataset"])
    train_split, test_split = data.split("train"), data.split("test")

    from .training import train

    def run_one(point_cfg, used_paths=None):
        result = train(point_cfg, train_split, test_split, device=device, used_paths=used_paths,
                       wandb_config=wandb_config)
        path, perf = result
        if not main_rank:
            return path, perf
        if path is None:
            print("Path is None, no eval")
        elif do_analysis:
            print("Running eigenvalue evaluation")
            from .analysis import eval_eig

            # the Mamba and transformer families' spectra are taken on the first
            # analysis batch of the test split, as tlie_tpu's unshuffled analysis
            # loader gives it (a padded split's tokens alone)
            batch = test_split[0][: conf_args["batch_size"]]
            eval_eig(point_cfg, conf_args, perf, result.model, device=device, batch=batch)
            print("Finished!")
        return path, perf

    from .utils import profile_trace

    traced = args.profile and main_rank
    with profile_trace(args.profile) if traced else contextlib.nullcontext():
        if sweep is None:
            run_one(derive_runtime_fields(cfg, data.l_max, len(train_split[0])))
            return 0
        points = expand_sweep(sweep)
        print(f"Found {len(points)} sweep configurations ...")
        if args.sweep_parallel:
            from .parallel import run_sweep

            run_sweep(base, points, train_split, test_split, data.l_max, conf_args, device=device)
            return 0
        _run_serial(base, points, run_one, data.l_max, len(train_split[0]))
    return 0


def _run_serial(base, points, run_one, l_max: int, train_size: int) -> None:
    """The sweep's points one after another (``launch.py::_run_all``'s serial
    branch), each journaled as it ends; points already in the journal are
    skipped, and a checkpoint path that collides with one the sweep wrote
    takes the suffix ``-pN``."""
    import yaml

    from .parallel.sweep import _journal_path, _load_journal, _point_key, write_journal

    journal = _journal_path(base)
    done = _load_journal(journal)
    used_paths = {r.get("path") for r in done.values() if r.get("path")}
    for idx, point in enumerate(points):
        if _point_key(point) in done:
            print(f"Skipping {idx + 1}/{len(points)}: in the journal {journal}")
            continue
        print(f"Training... {idx + 1}/{len(points)}")
        point_cfg = derive_runtime_fields(apply_sweep_point(base, point).raw, l_max, train_size)
        print(yaml.dump(point_cfg))
        path, perf = run_one(point_cfg, used_paths)
        if mesh.is_main():
            write_journal(journal, point, path, perf)
        print(f"Done with {idx + 1} of {len(points)} configurations.")


if __name__ == "__main__":
    sys.exit(main())
