"""Artifact emission: .npy arrays, the percentage text reports (the Mamba
family's per batch, head and layer; the SSM families' per layer) and the
config snapshot, copied from ``tlie_tpu/analysis/artifacts.py`` with the
same file set and names.

The port uploads nothing (no W&B).  ``used_config.yaml`` is written when the
``yaml`` module imports and left out when it does not.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

_ARTIFACT_KEYS = (
    "eig", "eig_init",
    "percentage", "percentage_init",
    "percentage_phase", "percentage_phase_init",
    "percentage_mean", "percentage_init_mean",
    "percentage_std", "percentage_init_std",
)


def write_percentage_file(
    path: str, thresholds_radius, percentage, percentage_init,
    percentage_mean=None, percentage_init_mean=None,
    percentage_std=None, percentage_init_std=None,
    batch_selection=(0, 2, 4, 6),
) -> None:
    """Per-(batch, head, layer) report for the attention/mamba families
    (ref eval_eig.py:393-433)."""
    num_heads = np.shape(percentage)[2]
    num_layers = np.shape(percentage)[3]
    batch_size = np.shape(percentage)[1]
    sel = [b for b in batch_selection if b < batch_size]

    with open(path, "w") as f:
        print("threshold radius:", thresholds_radius, "\n", file=f)
        print("batch selection:", np.array(sel), "\n", file=f)
        for bi, b in enumerate(sel):
            for h in range(num_heads):
                for l in range(num_layers):
                    print("percentage batch dimension", b, "head", h, "layer", l,
                          "radius init: ", np.round(percentage_init[:, b, h, l], 1), file=f)
                for l in range(num_layers):
                    print("percentage batch dimension", b, "head", h, "layer", l,
                          "radius: ", np.round(percentage[:, b, h, l], 1), file=f)
                if bi == 0 and percentage_mean is not None:
                    for l in range(num_layers):
                        print("percentage batch mean head", h, "layer", l,
                              "radius init: ", np.round(percentage_init_mean[:, h, l], 1), file=f)
                    for l in range(num_layers):
                        print("percentage batch mean head", h, "layer", l,
                              "radius: ", np.round(percentage_mean[:, h, l], 1), file=f)
                    for l in range(num_layers):
                        print("percentage batch std head", h, "layer", l,
                              "radius init: ", np.round(percentage_init_std[:, h, l], 1), file=f)
                    for l in range(num_layers):
                        print("percentage batch std head", h, "layer", l,
                              "radius: ", np.round(percentage_std[:, h, l], 1), file=f)
                print("\n", file=f)
            print("\n", file=f)


def write_percentage_file_ssm(
    path: str, thresholds_radius, thresholds_phase,
    percentage, percentage_init, percentage_phase, percentage_phase_init,
) -> None:
    """Per-layer report for the SSM families (ref eval_eig.py:435-459)."""
    num_layers = np.shape(percentage)[1]
    with open(path, "w") as f:
        print("threshold radius:", thresholds_radius, "\n", file=f)
        print("threshold phase:", thresholds_phase, "\n", file=f)
        for l in range(num_layers):
            print("percentage layer", l, "radius init: ",
                  np.round(percentage_init[:, l], 1), file=f)
        print("\n", file=f)
        for l in range(num_layers):
            print("percentage layer", l, "radius: ",
                  np.round(percentage[:, l], 1), file=f)
        print("\n", file=f)
        for l in range(num_layers):
            print("percentage layer", l, "phase init: ",
                  np.round(percentage_phase_init[:, l], 1), file=f)
        print("\n", file=f)
        for l in range(num_layers):
            print("percentage layer", l, "phase: ",
                  np.round(percentage_phase[:, l], 1), file=f)


def artifact_name(args: Dict[str, Any], perf: float, wandb_name: str = "") -> str:
    """Run-identifying artifact name (ref eval_eig.py:755-756, 811-812)."""
    model_config = args["model"]
    train_config = args["train"]
    data_config = args["dataset"]
    dim_conv = model_config.get("dim_conv", 0)
    return (
        f"{data_config.get('name', '')}{wandb_name}"
        f"dmodel{model_config['hidden_dim']}-seed{args.get('seed')}"
        f"-num_layers{model_config['num_layers']}-dqk{model_config['state_dim']}"
        f"-conv_dim{dim_conv}-lr{train_config['lr']}"
    )


def save_artifacts(out_dir: str, arrays: Dict[str, Any], args: Dict[str, Any]) -> str:
    """Write the 10 arrays and, when ``yaml`` imports, used_config.yaml."""
    os.makedirs(out_dir, exist_ok=True)
    for key in _ARTIFACT_KEYS:
        if key in arrays:
            np.save(os.path.join(out_dir, f"{key}.npy"), np.asarray(arrays[key]))
    try:
        import yaml
    except ImportError:
        return out_dir
    with open(os.path.join(out_dir, "used_config.yaml"), "w") as f:
        yaml.dump(_plain(args), f, default_flow_style=False, sort_keys=False)
    return out_dir


def _plain(obj):
    """Recursively convert mappings/tuples to YAML-dumpable types."""
    from collections.abc import Mapping

    if isinstance(obj, Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (np.generic,)):
        return obj.item()
    return obj
