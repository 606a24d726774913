"""Experiment configuration: the parts of ``tlie_tpu/config/schema.py`` the
LRU slice uses, and the full-width MQAR LRU as a Python dict.

YAML is read only inside :func:`load_yaml`, so that the package and the card
run (``chip_smoke.py``) need no ``yaml`` module.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict

# Next-token style tasks (ref launch.py:119).
LANG_MODEL_DATASETS = ("WikiText", "MQAR")


def load_yaml(path: str | Path) -> Dict[str, Any]:
    import yaml

    with open(path) as stream:
        data = yaml.safe_load(stream)
    if not isinstance(data, dict):
        raise ValueError(f"Config {path} did not parse to a mapping")
    return data


def derive_runtime_fields(raw: Dict[str, Any], l_max: int, train_size: int) -> Dict[str, Any]:
    """Copy of ``raw`` with the fields the launcher derives from the dataset
    (``ExperimentConfig.derive_runtime_fields``): ``lang_model``,
    ``train.padded``, ``train.train_size`` and ``model.seq_len``."""
    cfg = copy.deepcopy(raw)
    cfg["lang_model"] = cfg["dataset"].get("name") in LANG_MODEL_DATASETS
    if "fixed_size" in cfg["dataset"]:
        cfg["train"]["padded"] = not cfg["dataset"]["fixed_size"]
    else:
        cfg["train"]["padded"] = False
    cfg["train"]["train_size"] = int(train_size)
    cfg["model"]["seq_len"] = int(l_max)
    return cfg


# configs/tasks/mqar/mqar-lru.yaml after derive_runtime_fields with the MQAR
# dataset it names (L = 512, 100 000 training examples by default); a CPU
# test pins this dict to the YAML as tlie_tpu.config resolves it.
MQAR_LRU_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/mqar-lru",
    "dataset": {
        "name": "MQAR", "_name_": "mqar", "input_seq_length": 512,
        "num_kv_pairs": 64, "data_dir": "", "fixed_size": True,
    },
    "train": {
        "total_steps": 40000, "batch_size": 64, "eval_every": 200,
        "stop_criterion": 0.99, "cosine_anneal": True, "param_group": None,
        "wd": 0.01, "warmup_steps": 4000, "lr": 0.00046416, "ssm_lr": 0.001,
        "lr_min": 1.0e-07, "reduce_factor": 0.5, "lr_patience": 200,
        "padded": False, "train_size": 100000,
    },
    "model": {
        "layer": "lru", "dt_min": 0.001, "dt_max": 0.1, "num_layers": 2,
        "activation": "full_glu", "input_dim": 8192, "output_dim": 8192,
        "hidden_dim": 128, "state_dim": 128, "dropout": 0.1, "norm": "batch",
        "pooling": "none",
        "ssm_lr_vars": ["Lambda_re", "Lambda_im", "P", "B", "log_step"],
        "prenorm": False, "dual": False, "decode": False,
        "r_min": 0.9, "r_max": 0.99, "seq_len": 512,
    },
    "lang_model": True,
}
