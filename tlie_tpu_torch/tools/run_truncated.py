"""Train a config with a cut budget, checkpoint it and eigen-analyse the
trained weights, counterpart of ``tools/run_truncated.py``.

    python -m tlie_tpu_torch.tools.run_truncated --config configs/wikitext-lru-short.yaml \\
        [--epochs 2 | --steps 2000] [--train_examples N] [--analysis_batch 64] \\
        [--save_path ./analysis_results/] [--device cpu]

``--steps`` sets a step-driven config's ``train.total_steps``, ``--epochs``
an epoch-driven one's ``train.num_epochs``; ``--train_examples`` caps
``train.train_size`` (so an epoch is shorter; the batches are still drawn
from the whole split, as in ``tools/run_truncated.py``).  Everything else,
the model's widths, the task and the optimiser, is the config's.  With
``--analysis_batch`` eval_eig runs on the trained weights after training,
on the first that many test examples, into ``--save_path``.  It runs on the
card unless ``--device cpu`` is given; ``--config`` resolves against
``configs/`` first, then as given.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Any, Dict, Optional, Tuple

from ..config import derive_runtime_fields, load_yaml
from ..device import resolve_device
from ..launch import _resolve


def run(cfg: Dict[str, Any], *, epochs: Optional[int] = None, steps: Optional[int] = None,
        train_examples: Optional[int] = None, analysis_batch: Optional[int] = None,
        save_path: str = "./analysis_results/", device="cuda",
        data: Optional[Tuple[int, Any, Any]] = None):
    """Train ``cfg`` (a config dict as loaded, its runtime fields not yet
    derived) with the cut budget, then, with ``analysis_batch``, eval_eig of
    the trained weights.  ``data`` is ``(l_max, train_split, test_split)``
    where the caller has the splits already; otherwise the config's dataset
    is built.  Returns ``(train result, eval_eig's arrays or None)``."""
    from ..analysis import eval_eig
    from ..data import DATASETS
    from ..training import train

    dev = resolve_device(device)
    cfg = copy.deepcopy(cfg)
    cfg.pop("wandb", None)  # the tool logs locally, as tools/run_truncated.py passes no W&B
    if epochs is not None:
        cfg["train"]["num_epochs"] = epochs
    if steps is not None:
        cfg["train"]["total_steps"] = steps
    if data is None:
        ds = DATASETS[cfg["dataset"]["_name_"]](**cfg["dataset"])
        data = (ds.l_max, ds.split("train"), ds.split("test"))
    l_max, train_split, test_split = data
    cfg = derive_runtime_fields(cfg, l_max, len(train_split[0]))
    if train_examples is not None:
        cfg["train"]["train_size"] = min(cfg["train"]["train_size"], train_examples)

    result = train(cfg, train_split, test_split, device=dev)
    path, perf = result
    print(f"[truncated] ckpt {path} perf {perf:.4f}", flush=True)
    arrays = None
    if analysis_batch and path:
        conf_args = {"batch_size": analysis_batch, "save_path": save_path}
        arrays = eval_eig(cfg, conf_args, perf, result.model, device=dev,
                          batch=test_split[0][:analysis_batch])
    return result, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--train_examples", type=int, default=None,
                    help="cap the train split's size (epoch-driven runs)")
    ap.add_argument("--analysis_batch", type=int, default=None,
                    help="run eval_eig at this batch size after training")
    ap.add_argument("--save_path", default="./analysis_results/")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(load_yaml(_resolve(args.config)), epochs=args.epochs, steps=args.steps,
        train_examples=args.train_examples, analysis_batch=args.analysis_batch,
        save_path=args.save_path, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
