"""Every experiment YAML under ``configs/`` (the sweep files and the
analysis configs left out) through the port on the CPU: ``load_yaml`` →
``derive_runtime_fields`` → ``train_fields`` → ``build_models``, at the
config's own widths, with the l_max of the dataset it names.  Every one
builds its model (70 of 71, ``aan-transformer.yaml``'s dual ``MATCH`` head
among them) but ``listops-lru.yaml``, which raises: the LRU is step-driven
in ``tlie_tpu``, and the config has no ``total_steps`` (the reference's
``KeyError``, kept).  Also the slices' resolved config dicts against the
YAMLs as tlie_tpu resolves them.

No dataset is built: the l_max of each comes from the YAML or from the
loader's default, and the train split is given 1,000 examples."""

from pathlib import Path

import pytest
import torch

from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu_torch.config import (
    AAN_TRANSFORMER_FULL, CIFAR_NORM_ATTENTION_GATING_FULL, CIFAR_SM_ATTENTION_FULL,
    IMDB_MAMBA2_FULL, LISTOPS_MAMBA2_FULL, PATHFINDER_S4_FULL, SC_S5_MFCC_FULL,
    derive_runtime_fields, load_yaml, train_fields,
)
from tlie_tpu_torch.models import build_models

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.relative_to(ROOT / "configs").as_posix()
                 for p in (ROOT / "configs").rglob("*.yaml")
                 if p.relative_to(ROOT / "configs").parts[0] not in ("sweep", "analysis"))
# the one that raises, and what
RAISES = {
    "tasks/listops/listops-lru.yaml": (KeyError, "total_steps"),
}
# the dual models: their MATCH head
DUAL = {"tasks/aan/aan-transformer.yaml"}
TRAIN_SIZE = 1000


def l_max(dataset) -> int:
    """The sequence length of the dataset a config names: its own key where
    it gives one, else the loader's default (``tlie_tpu/data/*.py``)."""
    name = dataset["_name_"]
    if name == "mqar":
        return dataset["input_seq_length"]
    if name == "wikitext":
        return dataset["block_size"]
    if name == "pathfinder":
        return dataset.get("resolution", 32) ** 2
    if name == "sc":
        return 161 if dataset.get("mfcc", False) else dataset.get("length", 16000)
    return dataset.get("l_max", {"listops": 2048, "cifar": 1024, "mnist": 784, "imdb": 4096,
                                 "aan": 4096}[name])


def test_the_probe_sees_every_config():
    assert len(CONFIGS) == 71 and set(RAISES) | DUAL <= set(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_builds_a_model_on_the_cpu(name):
    cfg = load_yaml(ROOT / "configs" / name)
    cfg = derive_runtime_fields(cfg, l_max(cfg["dataset"]), TRAIN_SIZE)
    if name in RAISES:
        err, match = RAISES[name]
        with pytest.raises(err, match=match):
            train_fields(cfg)
            build_models(cfg["model"], cfg["train"]["padded"], generator=torch.Generator(),
                         device="cpu")
        return
    assert train_fields(cfg)["total_steps"] > 0
    model, eval_model, family = build_models(cfg["model"], cfg["train"]["padded"],
                                             generator=torch.Generator().manual_seed(0),
                                             device="cpu")
    assert family == cfg["model"]["layer"] and model.training and not eval_model.training
    assert sum(p.numel() for p in model.parameters()) > 0
    assert hasattr(model, "match") == (name in DUAL)


@pytest.mark.parametrize("name,full,lmax,n", [
    ("cifar/cifar-sm-attention", CIFAR_SM_ATTENTION_FULL, 1024, 2048),
    ("cifar/cifar-norm-attention-gating", CIFAR_NORM_ATTENTION_GATING_FULL, 1024, 2048),
    ("listops/listops-mamba2", LISTOPS_MAMBA2_FULL, 2048, 96000),
    ("imdb/imdb-mamba2", IMDB_MAMBA2_FULL, 4096, 2048),
    ("pathfinder/pathfinder-s4", PATHFINDER_S4_FULL, 1024, 16384),
    ("aan/aan-transformer", AAN_TRANSFORMER_FULL, 4000, 4096),
    ("../sc-s5-mfcc", SC_S5_MFCC_FULL, 161, 2048)])
def test_slice_config_dicts_are_the_yamls_as_tlie_tpu_resolves_them(name, full, lmax, n):
    """Each dict is its YAML after tlie_tpu's derive_runtime_fields with the
    dataset it names: CIFAR's l_max 1024 and the 2,048 images of the
    synthetic split, ListOps' 2048 and 96,000 examples, IMDB's 4096 and the
    2,048 reviews of the synthetic corpus, PathFinder's 1024 and 16,384
    synthetic images, AAN's 4000 and 4,096 synthetic pairs, Speech
    Commands' 161 MFCC frames and 2,048 synthetic clips."""
    exp = jax_load_experiment(ROOT / "configs" / "tasks" / f"{name}.yaml")

    class _Shape:
        l_max = lmax
        train_inputs = range(n)

    exp.derive_runtime_fields(_Shape())
    assert full == exp.raw
