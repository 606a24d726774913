"""One rank of the tensor-parallel runs of ``tests/test_torch_tensor_parallel.py``.

    python tests/torch_tp_worker.py SPEC.json

started as each rank of a gloo group of 4 on the CPU by
``tlie_tpu_torch.parallel.mesh.spawn``.  In the one group it runs

- the primitives (the vocab-parallel embedding, the decoder with its copy
  into the model region, the CE with ``-100`` labels in float32 and
  bfloat16, the argmax with ties across shards) on the seeded inputs of
  :func:`primitive_inputs` in the layouts 2 × 2 and 1 × 4 (data × model),
  each output and the gradient of Σ output·w with respect to every input,
  written to ``<out>/prims-rank<r>.npz``;
- ``train`` of each job of :data:`JOBS` with ``train.model_parallel: 2``
  (2 × 2), writing the gathered state dict, this rank's own state dict and
  the history to ``<out>/<job>-rank<r>.pt``; the ``sm`` job writes its
  checkpoint under ``<out>/ckpt``;
- ``control``: the ``lru_batchnorm`` job with the data shard's collectives
  put back on the default (world) group;
- ``resume``: the ``sm`` job with a snapshot at step 3, run whole, then
  resumed from that snapshot;
- ``step``: one step of :data:`STEP_TF` from the weights and batch the spec
  names (``tlie_tpu``'s, carried by ``compat``);
- ``decode``: greedy and sampled tokens of a transformer served over the 4
  ranks as data ranks (``Decoder(..., shard=)``).

The configs and the inputs are built here and imported by the test, which
runs the one-process counterparts; this module imports no JAX.
"""

import copy
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import torch

import torch_sp_worker as sp
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import mesh
from tlie_tpu_torch.parallel.tp import (
    VocabParallelLinear, gather_vocab_parallel, slice_vocab_parallel, vocab_parallel_argmax,
    vocab_parallel_cross_entropy, vocab_parallel_embedding,
)
from tlie_tpu_torch.training import loop, train, train_step
from tlie_tpu_torch.training.state import make_family_optimizer

MP = 2
MODELS = {
    # dropout 0.1 on the encoder, the attention context and the MLP mixer
    "sm": sp.MODELS["sm_dropout"],
    "lin": sp.MODELS["lin"],
    "mamba2": dict(layer="mamba", version="mamba2", num_layers=1, num_heads=1, input_dim=1,
                   output_dim=64, hidden_dim=16, state_dim=16, conv_dim=4, expansion=1,
                   dropout=0.0, glu=True, norm="layer", dual=False, prenorm=True, mixer="none",
                   mixer_dim=16, classifier=False, pooling="none", embedding=True,
                   token_embedding=True, vocab_size=64, max_pos_embed=32),
    # BatchNorm and dropout 0.1; the decoder split, the dense encoder replicated
    "lru_batchnorm": sp.MODELS["lru_batchnorm"],
    # a mean-pooled classifier of 10 classes
    "lru_mean_cls": sp.MODELS["lru_mean_cls"],
}
JOBS = tuple(MODELS)
# the one-step job: tlie_tpu's tests/test_training.py model (linear
# attention, 1 layer, d_model 16, vocabulary 64) on a batch of 8
STEP_TF = dict(sp.MODELS["lin"], num_heads=1, seq_len=32)
STEP_LR = 1e-3


def config(job: str, mp: int = MP, save=None) -> dict:
    """The resolved config of a job with ``train.model_parallel`` at ``mp``
    (``torch_sp_worker``'s tiny MQAR: L 32, vocabulary 64, batch 16, 6
    steps, 2 evals)."""
    base = "lru_mean_cls" if job.endswith("_cls") else "lru"
    cfg = sp.config(base, 1)
    cfg["model"] = dict(MODELS[job], seq_len=cfg["model"]["seq_len"])
    cfg["train"]["model_parallel"] = mp
    cfg["save"] = save
    return cfg


def split(job: str):
    return sp.split("lru_mean_cls" if job.endswith("_cls") else "lru")


def primitive_inputs():
    """The primitives' seeded global inputs: a (V, d) table and the tokens
    it embeds, a decoder's x, weight and bias, logits with labels (a fifth
    of them -100) and argmax logits whose row maxima tie across shards."""
    rng = np.random.default_rng(0)
    B, L, V, d = 4, 5, 12, 6

    def f(*shape):
        return np.asarray(rng.normal(size=shape), np.float32)

    labels = rng.integers(0, V, size=(B, L))
    labels[rng.random((B, L)) < 0.2] = -100
    ties = np.round(f(B, L, V), 1)
    # the maximum at a column of the first shard of each layout and again in
    # a later one: in row 0 at columns 1 and 9 (shards 0 and 1 of 2, 0 and 3
    # of 4), in row 1 at 4 and 7 (shards 0 and 1 of 2, 1 and 2 of 4), in row
    # 2 twice in one shard (columns 6 and 8)
    for r, cols in ((0, (1, 9)), (1, (4, 7)), (2, (6, 8))):
        ties[r, :, list(cols)] = 9.0
    return {"ids": rng.integers(0, V, size=(B, L)), "table": f(V, d), "x": f(B, L, d),
            "weight": f(V, d), "bias": f(V), "logits": f(B, L, V), "labels": labels,
            "ties": np.asarray(ties, np.float32), "w_emb": f(B, L, d), "w_dec": f(B, L, V)}


def _cols(t, vocab, dim=-1):
    n = t.shape[dim] // vocab.world
    return t.narrow(dim, vocab.rank * n, n)


def run_primitives(out_dir: str, rank: int) -> None:
    xs = {k: torch.from_numpy(v) for k, v in primitive_inputs().items()}
    got = {}
    for m in (2, 4):
        data, vocab = mesh.mesh_2d(m)
        key = f"{data.world}x{m}"
        table = _cols(xs["table"], vocab, 0).clone().requires_grad_()
        out = vocab_parallel_embedding(xs["ids"], table, vocab)
        (g,) = torch.autograd.grad((out * xs["w_emb"]).sum(), [table])
        got[f"{key}/emb/out"], got[f"{key}/emb/dtable"] = out.detach().numpy(), g.numpy()
        x = xs["x"].clone().requires_grad_()
        dec = VocabParallelLinear(_cols(xs["weight"], vocab, 0).clone(),
                                  _cols(xs["bias"], vocab, 0).clone(), vocab)
        y = dec(x)
        grads = torch.autograd.grad((y * _cols(xs["w_dec"], vocab)).sum(),
                                    [x, dec.weight, dec.bias])
        got[f"{key}/dec/out"] = y.detach().numpy()
        for name, g in zip(("dx", "dweight", "dbias"), grads):
            got[f"{key}/dec/{name}"] = g.numpy()
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{key}/ce_{str(dtype)[6:]}"
            logits = _cols(data.rows(xs["logits"]), vocab).to(dtype).requires_grad_()
            loss = vocab_parallel_cross_entropy(logits, data.rows(xs["labels"]), vocab, data)
            (g,) = torch.autograd.grad(loss, [logits])
            got[f"{tag}/loss"], got[f"{tag}/dlogits"] = loss.item(), g.float().numpy()
        got[f"{key}/argmax"] = vocab_parallel_argmax(_cols(xs["ties"], vocab), vocab).numpy()
    np.savez(os.path.join(out_dir, f"prims-rank{rank}.npz"), **got)


def _save(out_dir, job, rank, result):
    torch.save({"state": result.model.state_dict(), "history": result.history},
               os.path.join(out_dir, f"{job}-rank{rank}.pt"))


def world_group_control():
    """The data shard's collectives on the default group (all 4 ranks):
    the route without its data group."""
    real = loop.mesh_2d

    def world_data(m):
        data, vocab = real(m)
        return dataclasses.replace(data, group=None), vocab

    loop.mesh_2d = world_data


def resume_job(out_dir, rank, world):
    """The ``sm`` job with a snapshot at step 3: run whole (each snapshot
    copied aside as it is written), then resumed from the copy."""
    save = os.path.join(out_dir, "resume", "sm")
    cfg = config("sm", save=save)
    cfg["train"]["checkpoint_every"] = 3
    kept = []
    real = loop.save_resume

    def keep(path, *args, **kwargs):
        out = real(path, *args, **kwargs)
        shutil.copyfile(out, out + ".kept")
        kept.append(out)
        return out

    loop.save_resume = keep
    try:
        whole = train(copy.deepcopy(cfg), *split("sm"), device="cpu")
    finally:
        loop.save_resume = real
    if rank == 0:
        assert len(kept) == 1
        shutil.copyfile(kept[0] + ".kept", loop.resume_path(cfg))
    world.barrier()
    cfg["train"]["resume"] = True
    resumed = train(cfg, *split("sm"), device="cpu")
    return whole, resumed


def one_step(spec):
    """One step of STEP_TF from the spec's weights on the spec's batch of 8,
    each data rank's 4 rows, through ``train_step`` (AdamW behind the
    clip at global norm 1)."""
    data, vocab = mesh.mesh_2d(MP)
    model = build_models(STEP_TF, generator=torch.Generator(), device="cpu",
                         vocab_shard=vocab)[0]
    local, _ = slice_vocab_parallel(model, vocab, torch.load(spec["step_init"],
                                                             weights_only=True))
    model.load_state_dict(local)
    data.attach(model)
    batch = np.load(spec["step_batch"])
    x, y = (torch.from_numpy(batch[k]).long() for k in ("x", "y"))
    f = {"lr": STEP_LR, "ssm_lr": STEP_LR, "wd": sp.TRAIN["wd"], "betas": (0.9, 0.999)}
    opt, clip = make_family_optimizer(model, "transformer", STEP_TF, {"param_group": None}, f)
    loss = train_step(model, opt, data.rows(x), data.rows(y), {"regular": STEP_LR},
                      clip_norm=clip, shard=data)
    state, _ = gather_vocab_parallel(model, vocab)
    return state, float(data.sum(loss))


def decode_tokens(world):
    """Greedy and sampled (temperature 0.8, top-k 10) tokens of the ``sm``
    transformer (seed 7) on :func:`decode_prompts`, served over the ranks."""
    model = build_models(config("sm")["model"], generator=torch.Generator().manual_seed(7),
                         device="cpu")[1]
    dec = Decoder(config("sm")["model"], model, device="cpu", shard=world)
    prompt = torch.from_numpy(decode_prompts())
    greedy = dec.generate(prompt, 6)
    sampled = dec.generate(prompt, 6, temperature=0.8, top_k=10,
                           generator=torch.Generator().manual_seed(5))
    return greedy, sampled


def decode_prompts():
    return np.random.default_rng(3).integers(0, 64, size=(8, 20))


def main(spec_path: str) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    mesh.init_process_group("cpu")
    world = mesh.process_shard()
    out, rank = spec["out"], world.rank
    try:
        run_primitives(out, rank)
        for job in JOBS:
            save = os.path.join(out, "ckpt", job) if job == "sm" else None
            _save(out, job, rank, train(config(job, save=save), *split(job), device="cpu"))
        whole, resumed = resume_job(out, rank, world)
        _save(out, "resume_whole", rank, whole)
        _save(out, "resume", rank, resumed)
        state, loss = one_step(spec)
        torch.save({"state": state, "history": [{"loss": loss}]},
                   os.path.join(out, f"step-rank{rank}.pt"))
        greedy, sampled = decode_tokens(world)
        torch.save({"greedy": greedy, "sampled": sampled},
                   os.path.join(out, f"decode-rank{rank}.pt"))
        world_group_control()
        _save(out, "control", rank, train(config("lru_batchnorm"), *split("lru"), device="cpu"))
    finally:
        mesh.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
