"""Experiment configuration: ``tlie_tpu/config/schema.py`` copied
(``ExperimentConfig``, ``load_experiment``, the sweep files' ``load_sweep``,
``expand_sweep``, ``apply_sweep_point`` and ``iter_sweep``), with its derived
fields also as functions on plain dicts (``derive_runtime_fields``,
``lang_model``, ``checkpoint_name``); the train fields of
``tlie_tpu/training/loop.py``, step-driven or epoch-driven as it chooses; and
the full-width MQAR LRU, MQAR Mamba-2, MQAR softmax, linear and norm
attention transformers, MQAR and ListOps S5 and S4, the WikiText LRU and
norm-attention LMs, the small MQAR Mamba-1, the CIFAR-10 Mamba-2, its
pseudo-LTI variant, S4, S5 and LRU, the CIFAR-10 softmax and gated norm
attention classifiers, and the ListOps and IMDB Mamba-2 as Python dicts.  The raw sections keep
every key a YAML gives (``pseudoLTI``, CIFAR's ``grayscale``, ``permute``,
``tokenize``, ``augment``, ``cutout``, ``synthetic``, ...), which the
modules read with their defaults.

YAML is read only inside :func:`load_yaml`, so that the package and the card
run (``chip_smoke.py``) need no ``yaml`` module.  Running a sweep is not
ported yet: ``launch --sweep`` raises.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# Next-token style tasks (ref launch.py:119).
LANG_MODEL_DATASETS = ("WikiText", "MQAR")

# Model families of the framework (ref train.py:732-743).
MODEL_FAMILIES = ("mamba", "transformer", "lru", "s4", "s5")


def load_yaml(path: str | Path) -> Dict[str, Any]:
    import yaml

    with open(path) as stream:
        data = yaml.safe_load(stream)
    if not isinstance(data, dict):
        raise ValueError(f"Config {path} did not parse to a mapping")
    return data


@dataclasses.dataclass
class ExperimentConfig:
    """One experiment point (``ExperimentConfig``): the raw dict sections,
    kept as they are so that any reference YAML key round-trips, and the
    fields the launcher derives at run time."""

    raw: Dict[str, Any]

    @property
    def seed(self) -> int:
        return int(self.raw.get("seed", 0))

    @property
    def save(self) -> Optional[str]:
        return self.raw.get("save")

    @property
    def dataset(self) -> Dict[str, Any]:
        return self.raw["dataset"]

    @property
    def train(self) -> Dict[str, Any]:
        return self.raw["train"]

    @property
    def model(self) -> Dict[str, Any]:
        return self.raw["model"]

    @property
    def wandb(self) -> Optional[Dict[str, Any]]:
        return self.raw.get("wandb")

    @property
    def layer(self) -> str:
        return self.model["layer"]

    @property
    def lang_model(self) -> bool:
        return self.dataset.get("name") in LANG_MODEL_DATASETS

    @property
    def is_torch_family(self) -> bool:
        """The families that were torch modules in the reference."""
        return self.layer in ("mamba", "transformer")

    def validate(self) -> "ExperimentConfig":
        for section in ("dataset", "train", "model"):
            if section not in self.raw:
                raise ValueError(f"Config missing required section '{section}'")
        if self.layer not in MODEL_FAMILIES:
            raise ValueError(f"model.layer={self.layer!r} not in {MODEL_FAMILIES}")
        return self

    def derive_runtime_fields(self, dataset) -> "ExperimentConfig":
        """Fill the fields the launcher derives from a set-up dataset (ref
        launch.py:119, :141-148): ``lang_model``, ``train.padded``,
        ``train.train_size`` and ``model.seq_len``."""
        _fill_runtime_fields(self.raw, dataset.l_max, len(dataset.train_inputs))
        return self

    def copy(self) -> "ExperimentConfig":
        return ExperimentConfig(copy.deepcopy(self.raw))

    def checkpoint_name(self) -> Optional[str]:
        """Checkpoint path stem embedding the run's hyperparameters."""
        return checkpoint_name(self.raw)


def load_experiment(path: str | Path) -> ExperimentConfig:
    return ExperimentConfig(load_yaml(path)).validate()


def load_sweep(path: str | Path,
               config_root: str | Path = "configs") -> Tuple[ExperimentConfig, Dict[str, Any]]:
    """A sweep file's (base experiment config, sweep mapping).  ``base_config``
    resolves against ``config_root``, the sweep file's own directory, then
    the sweep file's nearest ``configs/`` ancestor (ref launch.py:77-86)."""
    sweep_cfg = load_yaml(path)
    base_rel = sweep_cfg["base_config"]
    candidates = [Path(config_root) / base_rel, Path(path).parent / base_rel]
    for ancestor in Path(path).resolve().parents:
        if ancestor.name == "configs":
            candidates.append(ancestor / base_rel)
    base_path = next((c for c in candidates if c.exists()), candidates[0])
    return load_experiment(base_path), sweep_cfg["sweep"]


def expand_sweep(sweep: Dict[str, Any]) -> List[Dict[Tuple[str, ...], Any]]:
    """The Cartesian product of a sweep mapping, as flat overrides from a
    ``(section, param)`` path, or ``(section,)`` for a whole-section sweep
    such as ``seed``, to one value, in ``itertools.product``'s order (ref
    launch.py:19-36)."""
    paths: List[Tuple[str, ...]] = []
    value_lists: List[Sequence[Any]] = []
    for section, spec in sweep.items():
        if isinstance(spec, list):
            paths.append((section,))
            value_lists.append(spec)
        elif isinstance(spec, dict):
            for param, values in spec.items():
                if not isinstance(values, list):
                    raise ValueError("Sweep values must be lists "
                                     f"(got {type(values).__name__} for {section}.{param})")
                paths.append((section, param))
                value_lists.append(values)
        else:
            raise ValueError(f"Sweep section {section!r} must be a list or dict")
    return [dict(zip(paths, combo)) for combo in itertools.product(*value_lists)]


def apply_sweep_point(base: ExperimentConfig,
                      point: Dict[Tuple[str, ...], Any]) -> ExperimentConfig:
    """A deep copy of ``base`` with one sweep point applied (ref
    launch.py:38-49, :169-170)."""
    cfg = base.copy()
    for path, value in point.items():
        if len(path) == 1:
            cfg.raw[path[0]] = value
        else:
            section, param = path
            cfg.raw[section][param] = value
    return cfg


def iter_sweep(base: ExperimentConfig, sweep: Dict[str, Any]) -> Iterator[ExperimentConfig]:
    for point in expand_sweep(sweep):
        yield apply_sweep_point(base, point)


def _fill_runtime_fields(cfg: Dict[str, Any], l_max: int, train_size: int) -> None:
    cfg["lang_model"] = cfg["dataset"].get("name") in LANG_MODEL_DATASETS
    if "fixed_size" in cfg["dataset"]:
        cfg["train"]["padded"] = not cfg["dataset"]["fixed_size"]
    else:
        cfg["train"]["padded"] = False
    cfg["train"]["train_size"] = int(train_size)
    cfg["model"]["seq_len"] = int(l_max)


def derive_runtime_fields(raw: Dict[str, Any], l_max: int, train_size: int) -> Dict[str, Any]:
    """Copy of ``raw`` with the fields the launcher derives from the dataset
    (``ExperimentConfig.derive_runtime_fields``): ``lang_model``,
    ``train.padded``, ``train.train_size`` and ``model.seq_len``."""
    cfg = copy.deepcopy(raw)
    _fill_runtime_fields(cfg, l_max, train_size)
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


def model_parallel_of(cfg: Dict[str, Any]) -> int:
    """``train.model_parallel`` (1, the route off, by default): the size of
    the model group that splits the vocabulary (``tlie_tpu``'s ``mesh_2d``,
    ``training/loop.py:221-230``).  Not beside ``sequence_parallel``
    (:func:`sequence_parallel_of` raises); a count below 1 raises."""
    m = int(cfg["train"].get("model_parallel") or 1)
    if m < 1:
        raise ValueError(f"train.model_parallel must be at least 1, not {m}")
    return m


def sequence_parallel_of(cfg: Dict[str, Any]) -> int:
    """``train.sequence_parallel`` (1, the route off, by default), checked
    against the rest of the config as ``tlie_tpu/training/loop.py:243-250``
    checks it: not beside ``model_parallel``, and a divisor of the
    sequence length.  Where ``tlie_tpu`` accepts it silently and trains the
    whole sequence on every device (the SSD of Mamba-2 and ``SSD_LTI``, and
    S4's convolution, have no sequence-parallel route there), the port
    raises: the route covers the LRU, S5, Mamba-1 and the transformer."""
    train, model = cfg["train"], cfg["model"]
    n = int(train.get("sequence_parallel") or 1)
    if n <= 1:
        return 1
    if int(train.get("model_parallel") or 1) > 1:
        raise ValueError("sequence_parallel and model_parallel are mutually exclusive")
    family = model.get("layer")
    covered = family in ("lru", "s5", "transformer") or (
        family == "mamba" and model.get("version") == "mamba1")
    if not covered:
        name = {"s4": "S4", "mamba": "Mamba-2 (SSD_LTI too)"}.get(family, repr(family))
        raise ValueError(f"train.sequence_parallel has no route for {name}: it covers the "
                         "LRU, S5, Mamba-1 and the softmax, linear and norm attention "
                         "transformer")
    L = model.get("seq_len")
    if L is not None and int(L) % n:
        raise ValueError(f"seq_len {L} not divisible by sequence_parallel {n}")
    return n


def train_fields(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The train settings the loop reads, with ``tlie_tpu/training/loop.py``'s
    defaults (``ssm_lr`` defaults to ``lr``; plateau decay is on when
    ``reduce_factor`` is given).  Step-driven runs (:func:`step_driven`)
    take ``total_steps`` and ``eval_every`` (``warmup_steps`` wins over
    ``warmup``); epoch-driven ones (``loop.py:174-182``) take
    ``train_size // batch_size`` steps an epoch (at least 1), ``num_epochs``
    of them, an eval at each epoch's end, and ``warmup`` in epochs.
    ``checkpoint_every`` (steps between resume snapshots, or None) and
    ``resume`` come through, and so do ``data_parallel``,
    ``sequence_parallel`` (checked by :func:`sequence_parallel_of`) and
    ``model_parallel`` (:func:`model_parallel_of`).  Under
    ``model_parallel`` above 1 the fused and the sparse heads are off, as
    ``tlie_tpu`` turns them off (``loop.py:302-306``, ``:339-341``)."""
    train = cfg["train"]
    sequence_parallel = sequence_parallel_of(cfg)
    model_parallel = model_parallel_of(cfg)
    bsz = int(train["batch_size"])
    if step_driven(cfg):
        total = int(train["total_steps"])
        eval_every = int(train["eval_every"])
        warmup = int(train.get("warmup_steps", train.get("warmup", 0)) or 0)
    else:
        per_epoch = max(1, int(train["train_size"]) // bsz)
        total = per_epoch * int(train["num_epochs"])
        eval_every = per_epoch
        warmup = int(train.get("warmup", 0) or 0) * per_epoch
    lr = train["lr"]
    every = train.get("checkpoint_every")
    return {
        "total_steps": total,
        "eval_every": eval_every,
        "warmup": warmup,
        "batch_size": bsz,
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
        "sparse_head": bool(train.get("sparse_head", True)) and model_parallel == 1,
        "fused_xent": bool(train.get("fused_xent", False)) and model_parallel == 1,
        "checkpoint_every": int(every) if every else None,
        "resume": bool(train.get("resume", False)),
        # the data-parallel route where a process group runs the loop
        # (parallel/mesh.py::data_shard; tlie_tpu's loop.py:233), off under
        # the sequence-parallel route, which takes the whole group
        # (loop.py:251-254)
        "data_parallel": bool(train.get("data_parallel", True)) and sequence_parallel == 1,
        # the sequence-parallel route's process count (1: off)
        "sequence_parallel": sequence_parallel,
        # the tensor-parallel route's model group size (1: off)
        "model_parallel": model_parallel,
        # train.param_group's optimiser group (training/state.py): its fixed
        # rate, with tlie_tpu's default (loop.py:197-198, 347)
        "group_lr": train.get("group_lr", 1e-3),
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


# configs/wikitext-lru-short.yaml after derive_runtime_fields with the
# synthetic WikiText-103 it names (block 1024: 1,953 train blocks of the
# 2,000,000-token stream); a CPU test pins this dict to the YAML as
# tlie_tpu.config resolves it.  The config leaves train.fused_xent off; the
# card run turns it on.
WIKITEXT_LRU_SHORT: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/wikitext-lru-short",
    "dataset": {
        "name": "WikiText", "_name_": "wikitext", "version": 103, "block_size": 1024,
        "data_dir": "", "fixed_size": True, "synthetic": True,
    },
    "train": {
        "total_steps": 1500, "batch_size": 8, "eval_every": 500, "betas": [0.9, 0.95],
        "param_group": None, "wd": 0.1, "cosine_anneal": True, "warmup_steps": 150,
        "lr": 0.001, "ssm_lr": 0.001, "lr_min": 1.0e-07, "reduce_factor": 0.5,
        "lr_patience": 5, "padded": False, "train_size": 1953,
    },
    "model": {
        "layer": "lru", "dt_min": 0.001, "dt_max": 0.1, "num_layers": 6,
        "activation": "full_glu", "input_dim": 50257, "output_dim": 50257,
        "hidden_dim": 512, "state_dim": 512, "dropout": 0, "norm": "batch",
        "pooling": "none",
        "ssm_lr_vars": ["Lambda_re", "Lambda_im", "P", "B", "log_step"],
        "prenorm": False, "dual": False, "decode": False,
        "r_min": 0.9, "r_max": 0.99, "seq_len": 1024,
    },
    "lang_model": True,
}


# configs/tasks/mqar/mqar-mamba2.yaml after derive_runtime_fields with the
# MQAR dataset it names (L = 512, 100 000 training examples by default); a CPU
# test pins this dict to the YAML as tlie_tpu.config resolves it.
MQAR_MAMBA2_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/mqar-mamba2",
    "dataset": {
        "name": "MQAR", "_name_": "mqar", "input_seq_length": 512,
        "num_kv_pairs": 64, "data_dir": "", "fixed_size": True,
    },
    "train": {
        "total_steps": 40000, "batch_size": 64, "eval_every": 200,
        "stop_criterion": 0.99, "cosine_anneal": True, "param_group": None,
        "wd": 0.1, "warmup_steps": 4000, "lr": 0.01,
        "padded": False, "train_size": 100000,
    },
    "model": {
        "layer": "mamba", "version": "mamba2", "num_layers": 2, "num_heads": 1,
        "input_dim": 1, "output_dim": 8192, "hidden_dim": 128, "state_dim": 128,
        "conv_dim": 4, "expansion": 1, "dropout": 0.0, "glu": True, "norm": "layer",
        "dual": False, "prenorm": True, "pooling": "none", "embedding": True,
        "token_embedding": True, "vocab_size": 8192, "max_pos_embed": 512,
        "mixer": "none", "mixer_dim": 128, "classifier": False, "seq_len": 512,
    },
    "lang_model": True,
}


# configs/tasks/mqar/mqar-sm-attention.yaml after derive_runtime_fields with
# the MQAR dataset it names (L = 512, 100 000 training examples by default); a
# CPU test pins this dict to the YAML as tlie_tpu.config resolves it.  A
# transformer with classifier: false ignores its pooling: mean.
MQAR_SM_ATTENTION_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/mqar-sm-attention",
    "dataset": {
        "name": "MQAR", "_name_": "mqar", "input_seq_length": 512,
        "num_kv_pairs": 64, "data_dir": "", "fixed_size": True,
    },
    "train": {
        "total_steps": 40000, "batch_size": 64, "eval_every": 200,
        "stop_criterion": 0.99, "cosine_anneal": True, "param_group": None,
        "wd": 0.1, "warmup_steps": 4000, "lr": 0.00046416,
        "padded": False, "train_size": 100000,
    },
    "model": {
        "input_dim": 1, "output_dim": 8192, "layer": "transformer", "num_layers": 2,
        "hidden_dim": 128, "state_dim": 128, "num_heads": 1, "att_dropout": 0.0,
        "norm": "layer", "embedding": True, "vocab_size": 8192, "max_pos_embed": 512,
        "mixer": "none", "mixer_dim": 128, "dropout": 0.1, "classifier": False,
        "pooling": "mean", "dual": False, "attention_fn": "sm-attention", "use_flash": True,
        "seq_len": 512,
    },
    "lang_model": True,
}


# configs/tasks/mqar/mqar-lin-attention.yaml after derive_runtime_fields with
# the MQAR dataset it names (L = 512, 100 000 training examples by default); a
# CPU test pins this dict to the YAML as tlie_tpu.config resolves it.  Linear
# attention ignores use_flash; a transformer with classifier: false ignores
# its pooling: mean.
MQAR_LIN_ATTENTION_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/mqar-lin-attention",
    "dataset": {
        "name": "MQAR", "_name_": "mqar", "input_seq_length": 512,
        "num_kv_pairs": 64, "data_dir": "", "fixed_size": True,
    },
    "train": {
        "total_steps": 40000, "batch_size": 64, "eval_every": 200,
        "stop_criterion": 0.99, "cosine_anneal": True, "param_group": None,
        "wd": 0.1, "warmup_steps": 4000, "lr": 0.01,
        "padded": False, "train_size": 100000,
    },
    "model": {
        "input_dim": 1, "output_dim": 8192, "layer": "transformer", "num_layers": 2,
        "hidden_dim": 128, "state_dim": 128, "num_heads": 1, "att_dropout": 0.0,
        "norm": "layer", "embedding": True, "vocab_size": 8192, "max_pos_embed": 512,
        "mixer": "none", "mixer_dim": 128, "dropout": 0.1, "classifier": False,
        "pooling": "mean", "dual": False, "attention_fn": "lin-attention", "use_flash": False,
        "seq_len": 512,
    },
    "lang_model": True,
}


# configs/tasks/mqar/mqar-norm-attention-conv.yaml after derive_runtime_fields
# with the MQAR dataset it names; a CPU test pins this dict to the YAML as
# tlie_tpu.config resolves it.  No position table; the keys mode and learn_A
# are read by neither package.
MQAR_NORM_ATTENTION_CONV_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/mqar-norm-attention-conv",
    "dataset": {
        "name": "MQAR", "_name_": "mqar", "input_seq_length": 512,
        "num_kv_pairs": 64, "data_dir": "", "fixed_size": True,
    },
    "train": {
        "total_steps": 40000, "batch_size": 64, "eval_every": 200,
        "stop_criterion": 0.99, "cosine_anneal": True, "param_group": None,
        "wd": 0.1, "warmup_steps": 4000, "lr": 0.001,
        "padded": False, "train_size": 100000,
    },
    "model": {
        "input_dim": 1, "output_dim": 8192, "layer": "transformer", "num_layers": 2,
        "hidden_dim": 128, "state_dim": 128, "num_heads": 1, "att_dropout": 0.0,
        "norm": "layer", "embedding": True, "vocab_size": 8192, "max_pos_embed": 0,
        "mixer": "none", "mixer_dim": 128, "dropout": 0.1, "classifier": False,
        "pooling": "mean", "dual": False, "attention_fn": "norm-attention",
        "mode": "attention", "norm_fn": "softplus", "approx_fn": "elu", "scale_B": True,
        "offset": True, "offset_init": "exp", "learn_A": False, "dim_conv": 4,
        "use_flash": False, "seq_len": 512,
    },
    "lang_model": True,
}


def _mqar_ssm_full(layer: str, **model) -> Dict[str, Any]:
    """configs/tasks/mqar/mqar-{layer}.yaml after derive_runtime_fields with
    the MQAR dataset it names (L = 512, 100 000 training examples by
    default), the S5 and S4 configs differing only in their model keys."""
    full = copy.deepcopy(MQAR_LRU_FULL)
    full["save"] = f"./checkpoint/mqar-{layer}"
    m = full["model"]
    del m["r_min"], m["r_max"]
    seq_len = m.pop("seq_len")
    m.update(layer=layer, **model, seq_len=seq_len)
    return full


# configs/tasks/mqar/mqar-s5.yaml and mqar-s4.yaml resolved; a CPU test pins
# each dict to its YAML as tlie_tpu.config resolves it.  S5 ignores its
# ssm_lr_vars (create_train_state_s5's fixed set).
MQAR_S5_FULL = _mqar_ssm_full("s5", C_init="lecun_normal", discretization="zoh",
                              conj_sym=True, num_blocks=8)
MQAR_S4_FULL = _mqar_ssm_full("s4")


def _listops_ssm_full(layer: str, **model) -> Dict[str, Any]:
    """configs/tasks/listops/listops-{layer}.yaml after derive_runtime_fields
    with the ListOps dataset it names (l_max 2048, 96,000 training examples
    by default, padded), the S5 and S4 configs differing only in their
    model keys."""
    return {
        "seed": 1919,
        "save": f"./checkpoint/listops-{layer}",
        "dataset": {"name": "LISTOPS", "_name_": "listops", "data_dir": "./data/listops",
                    "fixed_size": False},
        "train": {
            "num_epochs": 50, "batch_size": 50, "param_group": None, "wd": 0.0,
            "cosine_anneal": True, "warmup": 5, "lr": 0.0005, "ssm_lr": 0.001,
            "lr_min": 1.0e-07, "reduce_factor": 0.5, "lr_patience": 5,
            "checkpoint_every": 4800, "padded": True, "train_size": 96000,
        },
        "model": {
            "layer": layer, "dt_min": 0.001, "dt_max": 0.1, "num_layers": 6,
            "activation": "full_glu", "input_dim": 20, "output_dim": 10, "hidden_dim": 128,
            "state_dim": 64, "dropout": 0, "norm": "batch", "pooling": "mean",
            "ssm_lr_vars": ["Lambda_re", "Lambda_im", "P", "B", "log_step"],
            "prenorm": True, "dual": False, "decode": False, **model, "seq_len": 2048,
        },
        "lang_model": False,
    }


# configs/tasks/listops/listops-s5.yaml and listops-s4.yaml resolved; a CPU
# test pins each dict to its YAML as tlie_tpu.config resolves it.  Both are
# epoch-driven: 1,920 steps an epoch at 96,000 / 50, 96,000 steps in all.
LISTOPS_S5_FULL = _listops_ssm_full("s5", C_init="lecun_normal", discretization="zoh",
                                    conj_sym=True, num_blocks=8)
LISTOPS_S4_FULL = _listops_ssm_full("s4")


# configs/wikitext-norm-attention-short.yaml after derive_runtime_fields with
# the synthetic WikiText-103 it names (block 1024: 1,953 train blocks); a CPU
# test pins this dict to the YAML as tlie_tpu.config resolves it.  The MLP
# mixer, norm attention with its conv and no position table; a transformer
# with classifier: false ignores its pooling: mean, and neither package reads
# mode or learn_A.  About 61M parameters, 51.5M of them the embedding and the
# bias-free decoder.
WIKITEXT_NORM_ATTENTION_SHORT: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/wikitext-norm-attention-short",
    "dataset": {
        "name": "WikiText", "_name_": "wikitext", "version": 103, "block_size": 1024,
        "data_dir": "", "fixed_size": True, "synthetic": True,
    },
    "train": {
        "total_steps": 2000, "batch_size": 8, "eval_every": 500, "betas": [0.9, 0.95],
        "param_group": None, "wd": 0.1, "cosine_anneal": True, "warmup_steps": 200,
        "lr": 0.001, "padded": False, "train_size": 1953,
    },
    "model": {
        "input_dim": 1, "output_dim": 50257, "layer": "transformer", "num_layers": 6,
        "hidden_dim": 512, "state_dim": 512, "num_heads": 8, "att_dropout": 0.0,
        "norm": "layer", "embedding": True, "vocab_size": 50257, "max_pos_embed": 0,
        "mixer": "mlp", "mixer_dim": 512, "dropout": 0.0, "classifier": False,
        "pooling": "mean", "dual": False, "attention_fn": "norm-attention",
        "mode": "attention", "norm_fn": "softplus", "approx_fn": "elu", "scale_B": True,
        "offset": True, "offset_init": "exp", "learn_A": False, "dim_conv": 4,
        "use_flash": False, "seq_len": 1024,
    },
    "lang_model": True,
}


# configs/mqar-mamba1-small.yaml after derive_runtime_fields with the MQAR
# dataset it names (L 64, 8 pairs, vocab 256, 20,000 training examples); a
# CPU test pins this dict to the YAML as tlie_tpu.config resolves it.
# Mamba-1 (d_inner 128, dt_rank 4, d_state 16) with dropout 0.1.
MQAR_MAMBA1_SMALL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/mqar-mamba1-small",
    "dataset": {
        "name": "MQAR", "_name_": "mqar", "input_seq_length": 64, "num_kv_pairs": 8,
        "vocab_size": 256, "num_train_examples": 20000, "num_test_examples": 512,
        "fixed_size": True,
    },
    "train": {
        "total_steps": 8000, "batch_size": 32, "lr": 0.003, "wd": 0.1, "warmup_steps": 400,
        "cosine_anneal": True, "eval_every": 400, "param_group": None, "stop_criterion": 0.99,
        "padded": False, "train_size": 20000,
    },
    "model": {
        "layer": "mamba", "version": "mamba1", "num_layers": 2, "hidden_dim": 64,
        "state_dim": 16, "num_heads": 2, "conv_dim": 4, "expansion": 2, "dropout": 0.1,
        "glu": True, "norm": "layer", "prenorm": True, "pooling": "none", "embedding": True,
        "token_embedding": True, "vocab_size": 256, "input_dim": 1, "output_dim": 256,
        "classifier": False, "dual": False, "seq_len": 64,
    },
    "lang_model": True,
}


def _cifar_mamba2_full(name: str, **model) -> Dict[str, Any]:
    """configs/tasks/cifar/cifar-mamba2{name}.yaml after
    derive_runtime_fields with the CIFAR-10 dataset it names: grayscale
    pixels, L 1024, and the 2,048 training images of the synthetic split
    that stands in while the CIFAR-10 files are not in the repository."""
    return {
        "seed": 1919,
        "save": f"./checkpoint/cifar-mamba2{name}",
        "dataset": {"name": "CIFAR-10", "_name_": "cifar", "grayscale": True},
        "train": {
            "num_epochs": 50, "batch_size": 50, "param_group": None, "wd": 0.0,
            "cosine_anneal": True, "warmup": 5, "lr": 0.0002, "padded": False,
            "train_size": 2048,
        },
        "model": {
            "layer": "mamba", "version": "mamba2", "num_layers": 6, "num_heads": 4,
            "input_dim": 1, "output_dim": 10, "hidden_dim": 512, "state_dim": 64,
            "conv_dim": 4, "expansion": 1, "dropout": 0.0, "glu": True, "norm": "layer",
            "dual": False, "prenorm": False, "pooling": "mean", "embedding": True,
            "token_embedding": False, "vocab_size": 256, "max_pos_embed": 1024,
            "mixer": "none", "mixer_dim": 128, "classifier": False, **model, "seq_len": 1024,
        },
        "lang_model": False,
    }


# configs/tasks/cifar/cifar-mamba2.yaml and cifar-mamba2-pseudoLTI.yaml
# resolved; a CPU test pins each dict to its YAML as tlie_tpu.config
# resolves it.  Epoch-driven: 40 steps an epoch at 2,048 / 50, 2,000 in all.
# The dense encoder (token_embedding: false) takes the (B, 1024, 1) pixels;
# 6 layers of d 512, 4 heads of 128, N 64; a mean pool before the decoder.
CIFAR_MAMBA2_FULL = _cifar_mamba2_full("")
CIFAR_MAMBA2_LTI_FULL = _cifar_mamba2_full("-pseudoLTI", pseudoLTI=True)


def _cifar_ssm_full(layer: str, **model) -> Dict[str, Any]:
    """configs/tasks/cifar/cifar-{layer}.yaml after derive_runtime_fields
    with the CIFAR-10 dataset it names (grayscale, L 1024, the 2,048
    synthetic training images), the S4, S5 and LRU configs differing only
    in their model keys."""
    return {
        "seed": 1919,
        "save": f"./checkpoint/cifar-{layer}",
        "dataset": {"name": "CIFAR-10", "_name_": "cifar", "grayscale": True},
        "train": {
            "num_epochs": 50, "batch_size": 50, "param_group": None, "wd": 0.05,
            "cosine_anneal": True, "warmup": 5, "lr": 0.005, "ssm_lr": 0.001,
            "lr_min": 1.0e-07, "reduce_factor": 0.5, "lr_patience": 20, "padded": False,
            "train_size": 2048,
        },
        "model": {
            "layer": layer, "dt_min": 0.001, "dt_max": 0.1, "num_layers": 6,
            "activation": "full_glu", "input_dim": 1, "output_dim": 10, "hidden_dim": 512,
            "state_dim": 64, "dropout": 0.1, "norm": "batch", "pooling": "mean",
            "ssm_lr_vars": ["Lambda_re", "Lambda_im", "P", "B", "log_step"],
            "prenorm": False, "dual": False, "decode": False, **model, "seq_len": 1024,
        },
        "lang_model": False,
    }


# configs/tasks/cifar/cifar-s4.yaml, cifar-s5.yaml and cifar-lru.yaml
# resolved; a CPU test pins each dict to its YAML as tlie_tpu.config resolves
# it.  S4 is the slice's accuracy gate (tlie_tpu: test accuracy 1.000 after 15
# epochs on the synthetic split, RESULTS.md:255).
CIFAR_S4_FULL = _cifar_ssm_full("s4")
CIFAR_S5_FULL = _cifar_ssm_full("s5", C_init="lecun_normal", discretization="zoh",
                                conj_sym=True, num_blocks=8)
CIFAR_LRU_FULL = _cifar_ssm_full("lru", r_min=0.9, r_max=0.99)


def _cifar_transformer_full(name: str, dataset: Dict[str, Any], **model) -> Dict[str, Any]:
    """configs/tasks/cifar/cifar-{name}.yaml after derive_runtime_fields with
    the CIFAR-10 dataset it names (grayscale, L 1024, the 2,048 synthetic
    training images): the transformer classifier, 6 layers of d 512, 4
    heads (head_dim 16 of d_qk 64 beside v_dim 128, so the softmax takes
    its materialised form), the MLP mixer of 128 and a mean pool into the
    classifier MLP of 128."""
    return {
        "seed": 1919,
        "save": f"./checkpoint/cifar-{name}",
        "dataset": {"name": "CIFAR-10", "_name_": "cifar", "grayscale": True, **dataset},
        "train": {
            "num_epochs": 50, "batch_size": 50, "param_group": None, "wd": 0.0,
            "cosine_anneal": True, "warmup": 5, "lr": 0.0002, "padded": False,
            "train_size": 2048,
        },
        "model": {
            "input_dim": 1, "output_dim": 10, "layer": "transformer", "num_layers": 6,
            "hidden_dim": 512, "state_dim": 64, "num_heads": 4, "att_dropout": 0.0,
            "norm": "layer", "embedding": True, "vocab_size": 256, **model,
            "seq_len": 1024,
        },
        "lang_model": False,
    }


_CIFAR_CLASSIFIER = {"mixer": "mlp", "mixer_dim": 128, "dropout": 0.0, "classifier": True,
                     "pooling": "mean", "dual": False}
# configs/tasks/cifar/cifar-sm-attention.yaml and
# cifar-norm-attention-gating.yaml resolved; a CPU test pins each dict to its
# YAML as tlie_tpu.config resolves it.  Epoch-driven: 40 steps an epoch.  The
# softmax one reads tokenized pixels (256 grey levels) with a position table
# of 1,024.  The gated norm attention (softplus decay with its offset, conv
# 4, the SiLU gate) asks for no tokenize, so its float pixels reach the
# token embedding, which raises there as in tlie_tpu; its card path reads
# the tokenized pixels instead.
CIFAR_SM_ATTENTION_FULL = _cifar_transformer_full(
    "sm-attention", {"tokenize": True}, max_pos_embed=1024, **_CIFAR_CLASSIFIER,
    attention_fn="sm-attention", use_flash=True)
CIFAR_NORM_ATTENTION_GATING_FULL = _cifar_transformer_full(
    "norm-attention-gating", {}, max_pos_embed=0, **_CIFAR_CLASSIFIER,
    attention_fn="norm-attention", mode="attention", norm_fn="softplus", approx_fn="elu",
    scale_B=True, offset=True, offset_init="exp", learn_A=False, dim_conv=4, use_flash=False,
    use_gate=True)


def _lra_mamba2_full(task: str, dataset: Dict[str, Any], train: Dict[str, Any],
                     seq_len: int, **model) -> Dict[str, Any]:
    """configs/tasks/{task}/{task}-mamba2.yaml after derive_runtime_fields
    with the dataset it names: padded tokens through the token embedding,
    Mamba-2 blocks of d 128 with 4 heads of 32 and N 64, pre-norm, GLU, an
    unmasked mean pool before the decoder."""
    return {
        "seed": 1919,
        "save": f"./checkpoint/{task}-mamba2",
        "dataset": {**dataset, "fixed_size": False},
        "train": {"param_group": None, "wd": 0.01, "cosine_anneal": True, "warmup": 5,
                  "lr": 0.0005, **train, "padded": True},
        "model": {
            "layer": "mamba", "version": "mamba2", "num_layers": 6, "num_heads": 4,
            "input_dim": 1, "output_dim": 10, "hidden_dim": 128, "state_dim": 64,
            "conv_dim": 4, "expansion": 1, "dropout": 0.0, "glu": True, "norm": "layer",
            "dual": False, "prenorm": True, "pooling": "mean", "embedding": True,
            "token_embedding": True, **model, "seq_len": seq_len,
        },
        "lang_model": False,
    }


# configs/tasks/listops/listops-mamba2.yaml and imdb/imdb-mamba2.yaml
# resolved; a CPU test pins each dict to its YAML as tlie_tpu.config resolves
# it.  ListOps: l_max 2048, 96,000 training examples, 1,920 steps an epoch at
# batch 50, 6 layers.  IMDB: char level, l_max 4096, the 2,048 reviews of
# the synthetic corpus that stands in while the IMDB files are not in the
# repository, 341 steps an epoch at batch 6 (10,230 in all), 4 layers.
LISTOPS_MAMBA2_FULL = _lra_mamba2_full(
    "listops", {"name": "LISTOPS", "_name_": "listops", "data_dir": "./data/listops"},
    {"num_epochs": 50, "batch_size": 50, "train_size": 96000}, 2048,
    vocab_size=18, max_pos_embed=2048, mixer="none", mixer_dim=256, classifier=False)
IMDB_MAMBA2_FULL = _lra_mamba2_full(
    "imdb", {"name": "IMDB", "_name_": "imdb", "data_dir": ""},
    {"num_epochs": 30, "batch_size": 6, "train_size": 2048}, 4096,
    num_layers=4, output_dim=2, vocab_size=134, max_pos_embed=4096, mixer="none",
    mixer_dim=512, classifier=False)


# configs/tasks/pathfinder/pathfinder-s4.yaml resolved with the PathFinder
# dataset it names: 32×32 images as L 1024 float pixels (centred), the 16,384
# images of the synthetic split the YAML asks for (327 steps an epoch at
# batch 50); 4 S4 layers of d 256, N 64, BatchNorm, a mean pool.  A CPU test
# pins the dict to the YAML as tlie_tpu.config resolves it.
PATHFINDER_S4_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/pathfinder-s4",
    "dataset": {"name": "PathFinder", "_name_": "pathfinder", "synthetic": True,
                "synthetic_train": 16384, "synthetic_test": 2048},
    "train": {
        "num_epochs": 20, "batch_size": 50, "param_group": None, "wd": 0.05,
        "cosine_anneal": True, "warmup": 2, "lr": 0.004, "ssm_lr": 0.001, "lr_min": 1.0e-07,
        "reduce_factor": 0.5, "lr_patience": 10, "padded": False, "train_size": 16384,
    },
    "model": {
        "layer": "s4", "dt_min": 0.001, "dt_max": 0.1, "num_layers": 4,
        "activation": "full_glu", "input_dim": 1, "output_dim": 2, "hidden_dim": 256,
        "state_dim": 64, "dropout": 0.1, "norm": "batch", "pooling": "mean",
        "ssm_lr_vars": ["Lambda_re", "Lambda_im", "P", "B", "log_step"],
        "prenorm": False, "dual": False, "decode": False, "seq_len": 1024,
    },
    "lang_model": False,
}

# configs/tasks/aan/aan-transformer.yaml resolved with the AAN dataset it
# names: pairs of char-level documents of l_max 4,000, the 4,096 pairs of the
# synthetic corpus the YAML asks for (512 steps an epoch at batch 8 pairs, 16
# documents); 4 linear-attention layers of d 128, 4 heads, the GLU mixer, a
# position table of 4,000, the classifier MLP of 128 and the dual MATCH head.
# A CPU test pins the dict to the YAML as tlie_tpu.config resolves it.
AAN_TRANSFORMER_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/aan-transformer",
    "dataset": {"name": "AAN", "_name_": "aan", "l_max": 4000, "synthetic": True,
                "synthetic_train": 4096, "synthetic_test": 512},
    "train": {
        "num_epochs": 20, "batch_size": 8, "param_group": None, "wd": 0.01,
        "cosine_anneal": True, "warmup": 2, "lr": 0.002, "lr_min": 1.0e-07,
        "reduce_factor": 0.5, "lr_patience": 5, "padded": False, "train_size": 4096,
    },
    "model": {
        "layer": "transformer", "attention_fn": "lin-attention", "use_flash": False,
        "num_layers": 4, "hidden_dim": 128, "state_dim": 128, "num_heads": 4,
        "att_dropout": 0.0, "norm": "layer", "embedding": True, "vocab_size": 128,
        "max_pos_embed": 4000, "mixer": "glu", "mixer_dim": 128, "dropout": 0.1,
        "input_dim": 1, "output_dim": 2, "classifier": True, "pooling": "mean", "dual": True,
        "seq_len": 4000,
    },
    "lang_model": False,
}

# configs/sc-s5-mfcc.yaml resolved with the Speech Commands dataset it names:
# 161 MFCC frames of 20 coefficients, the 2,048 clips of the synthetic corpus
# the YAML asks for (64 steps an epoch at batch 32), 10 classes; 4 S5 layers of
# H 96, state 96 (P 48 after conj-sym), ZOH, half_glu1, BatchNorm, a mean
# pool.  A CPU test pins the dict to the YAML as tlie_tpu.config resolves it.
SC_S5_MFCC_FULL: Dict[str, Any] = {
    "seed": 1919,
    "save": "./checkpoint/sc-s5-mfcc",
    "dataset": {"name": "SC", "_name_": "sc", "mfcc": True, "all_classes": False,
                "length": 16000, "synthetic_train": 2048, "synthetic_test": 512},
    "train": {
        "num_epochs": 20, "batch_size": 32, "lr": 0.004, "wd": 0.05, "ssm_lr": 0.001,
        "lr_min": 1.0e-07, "reduce_factor": 0.5, "lr_patience": 10, "warmup": 1,
        "cosine_anneal": True, "param_group": None, "padded": False, "train_size": 2048,
    },
    "model": {
        "layer": "s5", "dt_min": 0.001, "dt_max": 0.1, "num_layers": 4,
        "activation": "half_glu1", "C_init": "lecun_normal", "discretization": "zoh",
        "conj_sym": True, "num_blocks": 8, "input_dim": 20, "output_dim": 10,
        "hidden_dim": 96, "state_dim": 96, "dropout": 0.1, "norm": "batch", "pooling": "mean",
        "ssm_lr_vars": ["Lambda_re", "Lambda_im", "B", "log_step"],
        "prenorm": False, "dual": False, "decode": False, "seq_len": 161,
    },
    "lang_model": False,
}
