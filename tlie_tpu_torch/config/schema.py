"""Experiment configuration: the parts of ``tlie_tpu/config/schema.py`` the
LRU slices use (runtime fields, ``lang_model``, ``checkpoint_name``), the
train fields and the step-driven choice of ``tlie_tpu/training/loop.py``,
and the full-width MQAR LRU as a Python dict.

YAML is read only inside :func:`load_yaml`, so that the package and the card
run (``chip_smoke.py``) need no ``yaml`` module.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional

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


def lang_model(cfg: Dict[str, Any]) -> bool:
    """Next-token task? (``ExperimentConfig.lang_model``)."""
    return cfg["dataset"].get("name") in LANG_MODEL_DATASETS


def checkpoint_name(cfg: Dict[str, Any]) -> Optional[str]:
    """Checkpoint path stem embedding the run's hyperparameters, None when
    the config has no ``save`` (``ExperimentConfig.checkpoint_name``)."""
    if cfg.get("save") is None:
        return None
    model = cfg["model"]
    return (
        f"{cfg['save']}-seed-{cfg['seed']}-layers-{model['num_layers']}"
        f"dim_conv{model.get('dim_conv', 0)}-s_d-{model['state_dim']}"
    )


def step_driven(cfg: Dict[str, Any]) -> bool:
    """The loop's cadence choice (``training/loop.py:170-172``): steps and
    ``eval_every`` rather than epochs."""
    family = cfg["model"]["layer"]
    lm = bool(cfg.get("lang_model", lang_model(cfg)))
    return family in ("mamba", "transformer") and lm or (
        family in ("lru", "s4", "s5")
        and (lm or (family == "lru" and cfg["dataset"].get("_name_") == "listops"))
    )


# train options the port does not carry yet, with the value that leaves them off
_NOT_PORTED = {
    "fused_xent": False, "checkpoint_every": None, "resume": False,
    "model_parallel": 1, "sequence_parallel": 1,
}


def train_fields(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The train settings the step-driven loop reads, with
    ``tlie_tpu/training/loop.py``'s defaults (``warmup_steps`` wins over
    ``warmup``; ``ssm_lr`` defaults to ``lr``; plateau decay is on when
    ``reduce_factor`` is given).  Raises for what the port does not run yet:
    epoch-driven training, the fused head, resume snapshots and the
    multi-device modes."""
    if not step_driven(cfg):
        raise NotImplementedError("epoch-driven training is not ported yet")
    train = cfg["train"]
    for key, off in _NOT_PORTED.items():
        if train.get(key) not in (None, off):
            raise NotImplementedError(f"train.{key} is not ported yet")
    lr = train["lr"]
    return {
        "total_steps": int(train["total_steps"]),
        "eval_every": int(train["eval_every"]),
        "warmup": int(train.get("warmup_steps", train.get("warmup", 0)) or 0),
        "batch_size": int(train["batch_size"]),
        "lr": lr,
        "ssm_lr": train.get("ssm_lr", lr),
        "lr_min": train.get("lr_min", 1e-6),
        "wd": train["wd"],
        "betas": tuple(train.get("betas") or (0.9, 0.999)),
        "cosine": train.get("cosine_anneal", True),
        "stop_criterion": train.get("stop_criterion"),
        "plateau": "reduce_factor" in train,
        "reduce_factor": train.get("reduce_factor", 0.2),
        "lr_patience": train.get("lr_patience", 20),
        "sparse_head": train.get("sparse_head", True),
    }


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
