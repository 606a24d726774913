"""One rank of the data-parallel runs of ``tests/test_torch_data_parallel.py``.

    python tests/torch_dp_worker.py SPEC.json

started as each rank of a gloo group on the CPU by
``tlie_tpu_torch.parallel.mesh.spawn`` (which sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``).  It runs the jobs the
spec names, one after another, in the one group:

- ``lru``, ``tf_dense``, ``tf_fused``: ``train`` of the tiny configs below
  (the MQAR LRU with BatchNorm, dropout and the sparse head; the MQAR softmax
  transformer through the dense and through the fused head) on the split of
  :func:`split`, whose shards hold different valid counts;
- ``control``: the ``lru`` job with per-shard means (each rank's own valid
  count and BatchNorm statistics, the gradients averaged over the ranks, as
  a plain ``DistributedDataParallel`` wrap would take them);
- ``step``: one training step of a one-layer LRU from the weights and batch the spec
  names (``tlie_tpu``'s, carried by ``compat``).

Each rank writes its final state dict and history to
``<out>/<job>-rank<r>.pt``.  The configs and the split are built here and
imported by the test, which runs the same jobs in one process; this module
imports no JAX.
"""

import copy
import json
import os
import sys

import numpy as np
import torch

from tlie_tpu_torch.config import derive_runtime_fields
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import mesh
from tlie_tpu_torch.training import train, train_step
from tlie_tpu_torch.training.state import make_optimizer

MQAR_TINY = dict(name="MQAR", _name_="mqar", input_seq_length=64, num_kv_pairs=8,
                 vocab_size=256, num_train_examples=128, num_test_examples=32, fixed_size=True)
TRAIN = dict(total_steps=6, eval_every=3, batch_size=8, lr=0.004, wd=0.01, ssm_lr=0.001,
             lr_min=1e-7, warmup_steps=2, cosine_anneal=True, param_group=None)
LRU = dict(layer="lru", r_min=0.9, r_max=0.99, dt_min=0.001, dt_max=0.1, num_layers=2,
           activation="full_glu", input_dim=256, output_dim=256, hidden_dim=32, state_dim=32,
           dropout=0.1, norm="batch", pooling="none", ssm_lr_vars=["nu_log", "theta_log"],
           prenorm=False, dual=False, decode=False)
TRANSFORMER = dict(input_dim=1, output_dim=256, layer="transformer", attention_fn="sm-attention",
                   use_flash=True, num_layers=2, hidden_dim=32, state_dim=32, num_heads=2,
                   att_dropout=0.0, norm="layer", embedding=True, vocab_size=256,
                   max_pos_embed=64, mixer="mlp", mixer_dim=32, dropout=0.1, classifier=False,
                   pooling="mean", dual=False)


def config(job: str) -> dict:
    """The resolved config of a job (no checkpoint is written)."""
    model = LRU if job in ("lru", "control") else TRANSFORMER
    train_cfg = dict(TRAIN, sparse_head=job != "tf_dense", fused_xent=job == "tf_fused")
    cfg = {"seed": 1919, "save": None, "dataset": dict(MQAR_TINY), "train": train_cfg,
           "model": dict(model)}
    return derive_runtime_fields(cfg, MQAR_TINY["input_seq_length"],
                                 MQAR_TINY["num_train_examples"])


def split():
    """The tiny MQAR split, with row i of the train split keeping only
    8 − (i mod 5) of its 8 valid labels, so that the rows of a batch, and a
    batch's shards, hold different valid counts."""
    data = MQAR(**MQAR_TINY)
    (tx, ty), test = data.split("train"), data.split("test")
    ty = ty.copy()
    for i, row in enumerate(ty):
        valid = np.flatnonzero(row != -100)
        row[valid[: i % 5]] = -100
    return (tx, ty), test


def _per_shard_means():
    """Each rank's own valid count and BatchNorm statistics, and gradients
    averaged over the ranks: what the route computes without its global
    sums."""
    mesh.Shard.sum = lambda self, t: t.detach().clone()
    mesh.Shard.sum_with_grad = lambda self, t: t
    real = mesh.Shard.sum_grads

    def averaged(self, params):
        params = list(params)
        real(self, params)
        for p in params:
            if p.grad is not None:
                p.grad /= self.world

    mesh.Shard.sum_grads = averaged


# the LRU of the one-step job: one layer, dropout 0
STEP_LRU = dict(LRU, dropout=0.0, num_layers=1)


def one_step(shard, spec):
    """One step of ``STEP_LRU`` from the spec's weights and batch, this
    rank's rows of it through ``train_step``."""
    cfg = STEP_LRU
    model, _, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(torch.load(spec["step_init"], weights_only=True))
    batch = np.load(spec["step_batch"])
    x, y = (torch.from_numpy(batch[k]).long() for k in ("x", "y"))
    shard = shard or mesh.Shard(0, 1)
    shard.attach(model)
    opt = make_optimizer(model, cfg["ssm_lr_vars"], spec["step_lr"], spec["step_lr"],
                         TRAIN["wd"], (0.9, 0.999))
    lrs = {"regular": spec["step_lr"], "ssm": spec["step_lr"]}
    loss = train_step(model, opt, shard.rows(x), shard.rows(y), lrs, int(batch["k"]),
                      shard=shard)
    return model, [{"loss": float(shard.sum(loss))}]


def main(spec_path: str) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    mesh.init_process_group("cpu")
    shard = mesh.process_shard()
    tr, te = split()
    try:
        for job in spec["jobs"]:
            if job == "step":
                model, history = one_step(shard, spec)
            else:
                if job == "control":
                    _per_shard_means()
                result = train(copy.deepcopy(config(job)), tr, te, device="cpu")
                model, history = result.model, result.history
            torch.save({"state": model.state_dict(), "history": history},
                       os.path.join(spec["out"], f"{job}-rank{shard.rank}.pt"))
    finally:
        mesh.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
