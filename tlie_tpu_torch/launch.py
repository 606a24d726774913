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
WikiText); ``--sweep`` and W&B are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config import derive_runtime_fields, load_yaml
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
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    if args.sweep:
        raise NotImplementedError("sweeps are not ported yet (ROADMAP: sweeps and multi-device)")
    device = resolve_device(args.device)
    print(f"Using config {args.config}")
    cfg = load_yaml(_resolve(args.config))
    if cfg.pop("wandb", None):
        raise NotImplementedError("W&B logging is not ported")
    do_analysis = args.analysis_config != "no-analysis"
    conf_args = load_yaml(_resolve(args.analysis_config)) if do_analysis else None

    from .data import DATASETS

    name = cfg["dataset"].get("_name_")
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    data = DATASETS[name](**cfg["dataset"])
    train_split, test_split = data.split("train"), data.split("test")
    cfg = derive_runtime_fields(cfg, data.l_max, len(train_split[0]))

    from .training import train

    result = train(cfg, train_split, test_split, device=device)
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
        eval_eig(cfg, conf_args, perf, result.model, device=device, batch=batch)
        print("Finished!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
