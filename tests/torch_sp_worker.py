"""One rank of the sequence-parallel runs of ``tests/test_torch_sequence_parallel.py``.

    python tests/torch_sp_worker.py SPEC.json

started as each rank of a gloo group on the CPU by
``tlie_tpu_torch.parallel.mesh.spawn``.  In the one group it runs

- the primitives on the seeded inputs of :func:`primitive_inputs`, this
  rank's time steps of each: the scan (real, pairs, complex, the (N,)
  decay, reversed, time at axis 1 of a 4-D input), the linear attention
  with and without the normaliser and ``eps``, the ring attention, the
  halo convolution and the pooling over time, each output and the gradient of Σ output·w with respect
  to every input, written to ``<out>/prims-rank<r>.npz``;
- ``train`` of each job of :data:`JOBS` with ``train.sequence_parallel`` at
  the world size, writing the final state dict and history to
  ``<out>/<job>-rank<r>.pt``.

The configs and the inputs are built here and imported by the test, which
computes the one-process runs and ``tlie_tpu``'s functions; this module
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
from tlie_tpu_torch.models.layers import DepthwiseCausalConv
from tlie_tpu_torch.ops.scan import sequence_parallel
from tlie_tpu_torch.parallel import (
    mesh, ring_causal_attention, sp_diag_linear_scan, sp_linear_attention,
)
from tlie_tpu_torch.parallel.sp import sp_pool
from tlie_tpu_torch.training import train

# tests/test_sp.py's tiny MQAR (L 32: 8 steps a rank of 4)
MQAR_TINY = dict(name="MQAR", _name_="mqar", input_seq_length=32, num_kv_pairs=4,
                 vocab_size=64, num_train_examples=128, num_test_examples=32, fixed_size=True)
TRAIN = dict(total_steps=6, batch_size=16, lr=3e-3, wd=0.05, ssm_lr=1e-3, eval_every=3,
             cosine_anneal=True, param_group=None)
_SSM = dict(dt_min=0.001, dt_max=0.1, num_layers=2, input_dim=64, output_dim=64, hidden_dim=16,
            state_dim=16, dropout=0.0, norm="layer", pooling="none", prenorm=False, dual=False,
            decode=False)
_TF = dict(input_dim=1, output_dim=64, layer="transformer", use_flash=False, num_layers=1,
           hidden_dim=16, state_dim=16, num_heads=2, att_dropout=0.0, norm="layer",
           embedding=True, vocab_size=64, max_pos_embed=32, mixer="none", mixer_dim=16,
           dropout=0.0, classifier=False, pooling="mean", dual=False)
_NORM = dict(norm_fn="softplus", approx_fn="elu", scale_B=True, offset=True,
             offset_init="exp", learn_A=False, dim_conv=4)
MODELS = {
    "lru": dict(_SSM, layer="lru", r_min=0.9, r_max=0.99, activation="full_glu",
                ssm_lr_vars=["nu_log", "theta_log"]),
    "s5": dict(_SSM, layer="s5", activation="half_glu1", C_init="lecun_normal",
               discretization="zoh", conj_sym=True, num_blocks=4, bidirectional=True,
               ssm_lr_vars=["Lambda_re", "Lambda_im", "B", "log_step"]),
    "mamba1": dict(layer="mamba", version="mamba1", num_layers=2, hidden_dim=16, state_dim=8,
                   num_heads=2, conv_dim=4, expansion=2, dropout=0.0, glu=True, norm="layer",
                   prenorm=True, pooling="none", embedding=True, token_embedding=True,
                   vocab_size=64, input_dim=1, output_dim=64, classifier=False, dual=False),
    "sm": dict(_TF, attention_fn="sm-attention"),
    "lin": dict(_TF, attention_fn="lin-attention"),
    "norm": dict(_TF, attention_fn="norm-attention", **_NORM),
    # BatchNorm's statistics over the group (and its time-shared dropout)
    "lru_batchnorm": dict(_SSM, layer="lru", r_min=0.9, r_max=0.99, activation="full_glu",
                          ssm_lr_vars=["nu_log", "theta_log"], norm="batch", dropout=0.1),
    # element-wise dropout masks, the whole sequence's, cut to each rank's
    # steps: the encoder's, the attention context's and the MLP mixer's
    "sm_dropout": dict(_TF, attention_fn="sm-attention", dropout=0.1, att_dropout=0.1,
                       mixer="mlp", dim_conv=4),
    # pooled classifiers, CLASSES classes of a whole sequence (labels (B,))
    "lru_mean_cls": dict(_SSM, layer="lru", r_min=0.9, r_max=0.99, activation="full_glu",
                         ssm_lr_vars=["nu_log", "theta_log"], pooling="mean", output_dim=10),
    "mamba1_last_cls": dict(layer="mamba", version="mamba1", num_layers=1, hidden_dim=16,
                            state_dim=8, num_heads=2, conv_dim=4, expansion=2, dropout=0.0,
                            glu=True, norm="layer", prenorm=True, pooling="last",
                            embedding=True, token_embedding=True, vocab_size=64, input_dim=1,
                            output_dim=10, classifier=False, dual=False),
    "sm_max_cls": dict(_TF, attention_fn="sm-attention", classifier=True, pooling="max",
                       output_dim=10),
}
JOBS = tuple(MODELS)
CLASSES = 10


def config(job: str, sp: int = 1) -> dict:
    """The resolved config of a job (no checkpoint), with
    ``train.sequence_parallel`` at ``sp``: MQAR's next tokens, or for a
    ``*_cls`` job the classes of :func:`split`'s classification labels (a
    dataset of ListOps' metric, the argmax accuracy)."""
    dataset = dict(MQAR_TINY)
    if job.endswith("_cls"):  # 6 steps, 2 evals, step- or epoch-driven alike
        dataset.update(name="ListOps", _name_="listops")
    cfg = {"seed": 11, "save": None, "dataset": dataset,
           "train": dict(TRAIN, sequence_parallel=sp, num_epochs=2, train_size=48),
           "model": dict(MODELS[job])}
    return derive_runtime_fields(cfg, MQAR_TINY["input_seq_length"],
                                 48 if job.endswith("_cls") else
                                 MQAR_TINY["num_train_examples"])


def split(job: str = "lru"):
    """The tiny MQAR split, or for a ``*_cls`` job its first 48 training
    sequences, each labelled with its first token mod CLASSES."""
    data = MQAR(**MQAR_TINY)
    (tx, ty), (ex, ey) = data.split("train"), data.split("test")
    if not job.endswith("_cls"):
        return (tx, ty), (ex, ey)
    return (tx[:48], tx[:48, 0] % CLASSES), (ex, ex[:, 0] % CLASSES)


def primitive_inputs():
    """The primitives' seeded global inputs: {case: (inputs, the time dim of
    each input (None: the whole input on every rank), the number of
    outputs)}; every output has its time at dim 1."""
    rng = np.random.default_rng(0)
    B, L, N, H, D = 2, 32, 8, 2, 4

    def f(*shape, lo=None, hi=None):
        x = rng.uniform(lo, hi, size=shape) if lo is not None else rng.normal(size=shape)
        return np.asarray(x, np.float32)

    def ring(*shape):
        r, th = rng.uniform(0.8, 0.99, size=shape), rng.uniform(0, 2 * np.pi, size=shape)
        return np.float32(r * np.cos(th)), np.float32(r * np.sin(th))

    cases = {
        "scan_real": ([f(B, L, N, lo=0.7, hi=0.999), f(B, L, N)], (1, 1), 1),
        "scan_pair": ([*ring(B, L, N), f(B, L, N), f(B, L, N)], (1, 1, 1, 1), 2),
        "scan_complex": ([*ring(B, L, N), f(B, L, N), f(B, L, N)], (1, 1, 1, 1), 2),
        "scan_decay_n": ([*ring(N), f(B, L, N), f(B, L, N)], (None, None, 1, 1), 2),
        # a decay that varies in time: tlie_tpu's reverse flips the decay's
        # axis -2, which an (N,) decay lacks (the bidirectional S5's (N,)
        # decay runs reversed in the training jobs)
        "scan_reverse": ([*ring(B, L, N), f(B, L, N), f(B, L, N)], (1, 1, 1, 1), 2),
        "scan_axis1": ([f(B, L, 3, N, lo=0.7, hi=0.999), f(B, L, 3, N)], (1, 1), 1),
        "linear": ([np.abs(f(B, L, H, D)), np.abs(f(B, L, H, D)), f(B, L, H, D)], (1, 1, 1), 1),
        "linear_normalizer": ([np.abs(f(B, L, H, D)), np.abs(f(B, L, H, D)), f(B, L, H, D)],
                              (1, 1, 1), 2),
        "ring": ([f(B, L, H, D), f(B, L, H, D), f(B, L, H, D)], (1, 1, 1), 1),
        # x (B, L, C), weight (C, 1, K) as nn.Conv1d holds it, bias (C,)
        "halo_conv": ([f(B, L, 6), f(6, 1, 4), f(6)], (1, None, None), 1),
    }
    for how in POOLINGS:  # (B, d) on every rank: no time axis
        cases[f"pool_{how}"] = ([f(B, L, 6)], (1,), 1)
    return cases


POOLINGS = ("mean", "sum", "max", "last", "cls")


def output_weights(name: str, shapes):
    """The weights w of the loss Σ output·w of a case, seeded by its name."""
    rng = np.random.default_rng(sum(map(ord, name)))
    return [np.asarray(rng.normal(size=s), np.float32) for s in shapes]


def port_primitive(name: str, shard, *xs):
    """The port's sequence-parallel function of a case on this rank's steps
    (``shard`` a time shard), as a tuple of outputs."""
    if name in ("scan_real", "scan_axis1"):
        return (sp_diag_linear_scan(xs[0], xs[1], shard, axis=1),)
    if name == "scan_complex":
        h = sp_diag_linear_scan(torch.complex(xs[0], xs[1]), torch.complex(xs[2], xs[3]), shard)
        return h.real, h.imag
    if name.startswith("scan"):
        return sp_diag_linear_scan((xs[0], xs[1]), (xs[2], xs[3]), shard,
                                   reverse=name == "scan_reverse")
    if name == "linear":
        return (sp_linear_attention(*xs, shard, scale=0.5),)
    if name == "linear_normalizer":
        return sp_linear_attention(*xs, shard, scale=0.5, return_normalizer=True, eps=1e-6)
    if name == "ring":
        return (ring_causal_attention(*xs, shard, scale=0.5),)
    if name.startswith("pool_"):
        return (sp_pool(xs[0], name[5:], shard),)
    if name == "halo_conv":
        conv = DepthwiseCausalConv(6, 4, torch.Generator())
        with torch.no_grad():
            conv.weight.copy_(xs[1])
            conv.bias.copy_(xs[2])
        with sequence_parallel(shard):
            y = conv(xs[0])
        # the parameters' gradients through the module's own leaves
        return (y,), (conv.weight, conv.bias)
    raise KeyError(name)


def run_primitives(shard, out_dir: str) -> None:
    got = {}
    for name, (inputs, dims, n_out) in primitive_inputs().items():
        local = [(shard.steps(torch.from_numpy(x), d) if d is not None else torch.from_numpy(x))
                 .clone().requires_grad_() for x, d in zip(inputs, dims)]
        res = port_primitive(name, shard, *local)
        leaves = local
        if isinstance(res[0], tuple):  # the conv: its module's parameters
            res, params = res
            leaves = [local[0], *params]
        if name.startswith("pool_"):
            # every rank holds the whole output: each takes 1/n of the loss,
            # so that the group's losses sum to it
            ws = [torch.from_numpy(w) for w in output_weights(name, [o.shape for o in res])]
            loss = sum((o * w).sum() for o, w in zip(res, ws)) / shard.world
        else:
            full = [(o.shape[0], o.shape[1] * shard.world, *o.shape[2:]) for o in res]
            ws = [shard.steps(torch.from_numpy(w), 1) for w in output_weights(name, full)]
            loss = sum((o * w).sum() for o, w in zip(res, ws))
        grads = torch.autograd.grad(loss, leaves)
        for i, o in enumerate(res):
            got[f"{name}/out{i}"] = o.detach().numpy()
        for i, g in enumerate(grads):
            got[f"{name}/grad{i}"] = g.numpy()
    np.savez(os.path.join(out_dir, f"prims-rank{shard.rank}.npz"), **got)


def main(spec_path: str) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    mesh.init_process_group("cpu")
    group = mesh.process_shard()
    try:
        run_primitives(mesh.Shard(group.rank, group.world, axis=1), spec["out"])
        for job in spec["jobs"]:
            tr, te = split(job)
            result = train(copy.deepcopy(config(job, group.world)), tr, te, device="cpu")
            torch.save({"state": result.model.state_dict(), "history": result.history},
                       os.path.join(spec["out"], f"{job}-rank{group.rank}.pt"))
    finally:
        mesh.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
