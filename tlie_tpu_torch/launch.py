"""Train, then eigen-analyse: the port's counterpart of the root ``launch.py``.

    python -m tlie_tpu_torch.launch --config configs/tasks/mqar/mqar-lru.yaml \\
        --analysis_config configs/analysis/mqar.yaml [--device cpu]

The model families are the LRU (``layer: lru``), Mamba-2 (``layer: mamba``,
e.g. ``configs/tasks/mqar/mqar-mamba2.yaml``) and the transformer (``layer:
transformer``) with softmax attention (``attention_fn: sm-attention``, e.g.
``configs/tasks/mqar/mqar-sm-attention.yaml``), linear attention
(``lin-attention``, e.g. ``configs/tasks/mqar/mqar-lin-attention.yaml`` and
the CPU-sized ``configs/mqar-lin-attention-small.yaml``) or norm attention
(``norm-attention``, e.g. ``configs/tasks/mqar/mqar-norm-attention-conv.yaml``):

    python -m tlie_tpu_torch.launch --config configs/tasks/mqar/mqar-lin-attention.yaml \\
        --analysis_config configs/analysis/mqar.yaml

``--config`` paths resolve against ``configs/`` first, then as given.  The
run trains on the card unless ``--device cpu`` is given (a CUDA request
without a card raises), writes the checkpoint named by the config's
``save``, and runs ``eval_eig`` of the trained weights into the analysis
config's ``save_path``.  The datasets are those of
:data:`tlie_tpu_torch.data.DATASETS`, the ``SequenceDataset`` registry (MQAR,
WikiText); W&B is not ported and raises.

``--sweep`` takes a sweep file (``base_config`` + ``sweep`` lists, e.g.
``configs/sweep/mqar-lin-attention-seeds-lrs-8k.yaml``), builds the dataset
once, and trains and analyses its points one after another, each with
``apply_sweep_point``, ``derive_runtime_fields``, ``train`` and ``eval_eig``;
``--sweep_parallel`` (which implies ``--sweep``) trains the points stacked on
one device instead (:func:`tlie_tpu_torch.parallel.run_sweep`; the
transformer with linear or norm attention only).  Both journal each finished
point in ``<save>.sweep_journal.jsonl`` and skip the points a rerun finds
there:

    python -m tlie_tpu_torch.launch --config sweep/mqar-lin-attention-seeds-lrs-8k.yaml \\
        --sweep_parallel --analysis_config configs/analysis/mqar.yaml
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config import apply_sweep_point, derive_runtime_fields, expand_sweep, load_sweep, load_yaml
from .device import resolve_device


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
                        help="train the sweep's points stacked on one device")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    print(f"Using config {args.config}")
    sweep = None
    if args.sweep or args.sweep_parallel:
        base, sweep = load_sweep(_resolve(args.config), config_root="configs")
        cfg = base.raw
        if args.sweep_parallel:
            from .parallel import check_stackable

            check_stackable(base.model)  # before the dataset is built
    else:
        cfg = load_yaml(_resolve(args.config))
    if cfg.pop("wandb", None):
        raise NotImplementedError("W&B logging is not ported")
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
        result = train(point_cfg, train_split, test_split, device=device, used_paths=used_paths)
        path, perf = result
        if path is None:
            print("Path is None, no eval")
        elif do_analysis:
            print("Running eigenvalue evaluation")
            from .analysis import eval_eig

            # the Mamba and transformer families' spectra are taken on the first
            # analysis batch of the test split, as tlie_tpu's unshuffled analysis
            # loader gives it
            batch = test_split[0][: conf_args["batch_size"]]
            eval_eig(point_cfg, conf_args, perf, result.model, device=device, batch=batch)
            print("Finished!")
        return path, perf

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
        write_journal(journal, point, path, perf)
        print(f"Done with {idx + 1} of {len(points)} configurations.")


if __name__ == "__main__":
    sys.exit(main())
