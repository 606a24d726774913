"""Vocab tensor parallelism over processes (``tlie_tpu_torch/parallel/tp.py``,
``mesh.py::mesh_2d`` and the training loop's tensor-parallel route) on the
CPU, in one group of four gloo processes (``tests/torch_tp_worker.py``,
started once for the module while this process runs the one-process
counterparts and ``tlie_tpu``'s step):

- the primitives (embedding, decoder with its copy into the model region,
  CE with ``-100`` labels in float32 and bfloat16, argmax with ties across
  shards) in the layouts 2 × 2 and 1 × 4 against the one-process dense
  forms: outputs and every input's gradient;
- ``vocab_partition_specs`` against ``tlie_tpu``'s rules on the carried
  flax tree, and the ``ValueError`` on WikiText's 50257 vocabulary at m = 2
  in both packages;
- ``train.model_parallel: 2`` over 4 ranks (2 × 2) against one process for
  the softmax transformer with dropout, the linear attention, a Mamba-2,
  the LRU with BatchNorm and dropout, and a mean-pooled classifier; the
  gathered checkpoint and its spectra; the world-group control; a resume;
  one step against ``tlie_tpu``'s step on its (data 4 × model 2) mesh;
- the decoder over 4 data ranks, the launcher's process count and
  refusals, and ``chip_smoke.tensor_parallel_path`` (path 39) rehearsed.
"""

import json
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_tp_worker as worker
from tlie_tpu_torch.config import train_fields
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import mesh, shard_vocab_parallel, vocab_partition_specs
from tlie_tpu_torch.training import restore_checkpoint, train
from tlie_tpu_torch.training.schedules import lr_for_step
from tlie_tpu_torch.training.steps import cross_entropy_loss
from torch_parity import ARTIFACT_FILES, jax_transformer_params, load_chip_smoke, stub_card

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# the primitives: outputs and gradients within PRIM_ATOL + PRIM_RTOL·|ref|
# (the bfloat16 CE's too)
PRIM_RTOL = PRIM_ATOL = 1e-5
# training, tests/test_torch_data_parallel.py's bounds: a weight within
# PARAM_ATOL at PARAM_SHARE of the elements at least and within the
# movement bound 2·Σ lr everywhere; a running statistic within STATS_ATOL;
# each eval's numbers within LOSS_RTOL
PARAM_ATOL, PARAM_SHARE, STATS_ATOL, LOSS_RTOL = 2e-5, 0.99, 1e-6, 1e-4
SPECTRA_RTOL = 1e-5


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The worker's outputs beside the one-process runs, ``tlie_tpu``'s
    step on the (4 × 2) mesh and the one-process decode."""
    from tlie_tpu_torch.compat import params_from_jax

    out = tmp_path_factory.mktemp("tp")
    _, params = jax_transformer_params(worker.STEP_TF, seed=0)
    torch.save(params_from_jax(params), out / "init.pt")
    (tx, ty), _ = worker.split("sm")
    x, y = tx[:8], ty[:8]
    np.savez(out / "batch.npz", x=x, y=y)
    spec = {"out": str(out), "step_init": str(out / "init.pt"),
            "step_batch": str(out / "batch.npz")}
    (out / "spec.json").write_text(json.dumps(spec))
    codes = []
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests"),
                                          os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    runner = threading.Thread(target=lambda: codes.append(mesh.spawn(
        [str(ROOT / "tests" / "torch_tp_worker.py"), str(out / "spec.json")], WORLD, env=env,
        timeout=300)))
    runner.start()
    try:
        single = {job: train(worker.config(job, 1, save=str(out / "single" / job)),
                             *worker.split(job), device="cpu")
                  for job in worker.JOBS}
        jax_step = _jax_step(params, x, y)
        decode = _one_process_decode()
    finally:
        runner.join()
    assert codes == [0]
    ranks = {job: [torch.load(out / f"{job}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)]
             for job in (*worker.JOBS, "control", "resume", "resume_whole", "step", "decode")}
    prims = [dict(np.load(out / f"prims-rank{r}.npz")) for r in range(WORLD)]
    return {"single": single, "ranks": ranks, "prims": prims, "jax_step": jax_step,
            "decode": decode, "out": out, "step": (params, x, y)}


def _jax_step(params, x, y):
    """One step of ``tlie_tpu``'s scanned block on the conftest's (data 4 ×
    model 2) ``mesh_2d(2)``, the state placed by ``shard_vocab_parallel``
    and the data replicated, as ``tlie_tpu``'s loop lays them
    (``loop.py:221-280``): (params, loss)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from tlie_tpu.models.registry import build_models as jax_build_models
    from tlie_tpu.parallel.tp import mesh_2d, shard_vocab_parallel as jax_shard
    from tlie_tpu.training import scan_loop as jax_scan_loop
    from tlie_tpu.training.state import create_train_state_adamw

    cfg = worker.STEP_TF
    jmodel, _, _ = jax_build_models(dict(cfg), padded=False)
    state, _ = create_train_state_adamw(
        jmodel, jax.random.PRNGKey(0), in_dim=1, batch_size=2, seq_len=cfg["seq_len"],
        weight_decay=worker.sp.TRAIN["wd"], lr=worker.STEP_LR, betas=(0.9, 0.999),
        integer_inputs=True, param_group=None)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    grid = mesh_2d(2)
    assert dict(grid.shape) == {"data": 4, "model": 2}
    state = jax_shard(state, grid)
    block = jax_scan_loop.make_train_block(
        jmodel, "layer", tuple(sorted(state.opt_state.inner_states)), 0, 1, False,
        worker.STEP_LR, mesh=grid)
    data = jax_scan_loop.put_dataset(x, y, sharding=NamedSharding(grid, PartitionSpec()))
    jstate, jloss = block(state, jax.random.PRNGKey(1), data, np.arange(8)[None], 0,
                          worker.STEP_LR, worker.STEP_LR)
    return jax.tree_util.tree_map(np.asarray, jstate.params), float(jloss)


def _one_process_decode():
    model = build_models(worker.config("sm")["model"], generator=torch.Generator().manual_seed(7),
                         device="cpu")[1]
    dec = Decoder(worker.config("sm")["model"], model, device="cpu")
    prompt = torch.from_numpy(worker.decode_prompts())
    return {"greedy": dec.generate(prompt, 6),
            "sampled": dec.generate(prompt, 6, temperature=0.8, top_k=10,
                                    generator=torch.Generator().manual_seed(5))}


# -- the primitives ------------------------------------------------------------------


def _dense_primitives():
    """The one-process dense forms of the worker's primitives."""
    xs = {k: torch.from_numpy(v) for k, v in worker.primitive_inputs().items()}
    ref = {}
    table = xs["table"].clone().requires_grad_()
    out = F.embedding(xs["ids"], table)
    ref["emb/out"] = out.detach()
    ref["emb/dtable"] = torch.autograd.grad((out * xs["w_emb"]).sum(), [table])[0]
    x, w, b = (xs[k].clone().requires_grad_() for k in ("x", "weight", "bias"))
    y = F.linear(x, w, b)
    ref["dec/out"] = y.detach()
    ref["dec/dx"], ref["dec/dweight"], ref["dec/dbias"] = torch.autograd.grad(
        (y * xs["w_dec"]).sum(), [x, w, b])
    for dtype in (torch.float32, torch.bfloat16):
        logits = xs["logits"].to(dtype).requires_grad_()
        loss = cross_entropy_loss(logits, xs["labels"])
        ref[f"ce_{str(dtype)[6:]}/loss"] = loss.detach()
        ref[f"ce_{str(dtype)[6:]}/dlogits"] = torch.autograd.grad(loss, [logits])[0].float()
    ref["argmax"] = torch.argmax(xs["ties"], dim=-1)
    return ref


def _rank(r, m):
    """(data index, model index) of rank r in the layout (W/m) × m."""
    return divmod(r, m)


@pytest.mark.parametrize("case", ["emb", "dec", "ce_float32", "ce_bfloat16", "argmax"])
@pytest.mark.parametrize("m", [2, 4], ids=["2x2", "1x4"])
def test_primitive_matches_the_one_process_form(four_ranks, m, case):
    """Each rank's outputs and gradients, joined over the model ranks
    (columns of the vocabulary) and the data ranks (rows of the CE's
    batch), against the dense forms: the embedding (its output on every
    rank, each rank's rows of the table's gradient), the decoder (each
    rank's logit columns, dx whole on every rank, its rows of dW and db),
    the CE (the data ranks' loss shares summing to the mean over the valid
    labels; dlogits), the argmax (the first maximum, ties placed across
    shards); within PRIM_ATOL + PRIM_RTOL·|ref|."""
    prims, ref = four_ranks["prims"], _dense_primitives()
    key = f"{WORLD // m}x{m}"
    n_data = WORLD // m

    def tol(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=PRIM_RTOL, atol=PRIM_ATOL)

    def cols(name, dim=-1):
        """The model ranks' parts of data index 0, joined along dim."""
        return np.concatenate([prims[j][f"{key}/{name}"] for j in range(m)], axis=dim)

    if case == "argmax":
        for p in prims:
            np.testing.assert_array_equal(p[f"{key}/argmax"], ref["argmax"].numpy())
        assert ref["argmax"][0, 0] == 1 and ref["argmax"][1, 0] == 4 and ref["argmax"][2, 0] == 6
        return
    if case == "emb":
        for p in prims:
            tol(p[f"{key}/emb/out"], ref["emb/out"])
        tol(cols("emb/dtable", 0), ref["emb/dtable"])
        return
    if case == "dec":
        tol(cols("dec/out"), ref["dec/out"])
        for p in prims:
            tol(p[f"{key}/dec/dx"], ref["dec/dx"])
        tol(cols("dec/dweight", 0), ref["dec/dweight"])
        tol(cols("dec/dbias", 0), ref["dec/dbias"])
        return
    loss = sum(float(prims[d * m][f"{key}/{case}/loss"]) for d in range(n_data))
    tol(loss, ref[f"{case}/loss"])
    for r, p in enumerate(prims):  # model ranks of one data index agree
        d, _ = _rank(r, m)
        assert float(p[f"{key}/{case}/loss"]) == float(prims[d * m][f"{key}/{case}/loss"])
    got = np.concatenate([np.concatenate([prims[d * m + j][f"{key}/{case}/dlogits"]
                                          for j in range(m)], axis=-1)
                          for d in range(n_data)], axis=0)
    tol(got, ref[f"{case}/dlogits"])


# -- partition rules -----------------------------------------------------------------


def _rule_models():
    tf = worker.config("sm")["model"]
    return {
        "transformer": tf,
        "mamba2": worker.config("mamba2")["model"],
        "lru": worker.config("lru_batchnorm")["model"],
        "transformer_mlp_classifier_dual": dict(tf, mixer="mlp", classifier=True, dual=True,
                                                output_dim=2),
    }


@pytest.mark.parametrize("name", list(_rule_models()))
def test_partition_rules_pick_tlie_tpus_leaves(name):
    """The leaves ``vocab_partition_specs`` splits, carried to the flax tree
    (``tlie_tpu/analysis/compat.py::torch_state_dict_to_flax``; the SSM
    backbone through the port's ``compat``), are those
    ``tlie_tpu.parallel.tp.vocab_partition_specs`` splits on that tree, and
    each split leaf is the vocabulary axis of its flax array."""
    from jax.sharding import PartitionSpec as P

    from tlie_tpu.analysis.compat import torch_state_dict_to_flax
    from tlie_tpu.parallel.tp import vocab_partition_specs as jax_specs
    from tlie_tpu_torch.compat import params_to_jax

    cfg = _rule_models()[name]
    model = build_models(cfg, generator=torch.Generator().manual_seed(0), device="cpu")[0]
    state = {k: v for k, v in model.state_dict().items()}
    specs = vocab_partition_specs(model)

    def carry(sd):
        if cfg["layer"] in ("transformer", "mamba"):
            return torch_state_dict_to_flax(sd, cfg["layer"])
        return params_to_jax(sd)[0]

    def paths(tree, spec_of):
        leaves = jax.tree_util.tree_leaves_with_path(jax_specs(tree),
                                                     is_leaf=lambda s: isinstance(s, P))
        return {jax.tree_util.keystr(p): s for p, s in leaves if s != P()} if spec_of else \
            {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(tree)}

    picked = {}
    for key, dim in specs.items():
        one = paths(carry({key: state[key]}), False)
        assert len(one) == 1
        if dim is not None:
            picked[one.pop()] = state[key].shape[0]
    flax_tree = carry(state)
    want = paths(flax_tree, True)
    assert set(picked) == set(want) and picked
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(flax_tree)}
    for path, spec in want.items():  # the flax array's "model" axis holds the vocabulary
        assert flat[path].shape[list(spec).index("model")] == picked[path]
    expected = {"transformer": 2, "mamba2": 3, "lru": 2, "transformer_mlp_classifier_dual": 1}
    assert len(picked) == expected[name]


def test_a_vocabulary_of_50257_raises_at_model_parallel_2_in_both_packages():
    """WikiText's vocabulary (every ``configs/wikitext-*.yaml``) is odd:
    ``tlie_tpu``'s placement on ``mesh_2d(2)`` and the port's
    ``shard_vocab_parallel`` at m = 2 both raise ``ValueError``."""
    from tlie_tpu.parallel.tp import mesh_2d, shard_vocab_parallel as jax_shard

    with pytest.raises(ValueError, match="divisible by 2"):
        jax_shard({"encoder": {"word_embeddings": {"embedding": jnp.zeros((50257, 16))}}},
                  mesh_2d(2))
    cfg = dict(worker.config("sm")["model"], vocab_size=50257, output_dim=50257)
    model = build_models(cfg, generator=torch.Generator(), device="cpu")[0]
    with pytest.raises(ValueError, match="divisible by 2, but it is equal to 50257"):
        shard_vocab_parallel(model, mesh.Shard(0, 2, vocab=True))


# -- training ------------------------------------------------------------------------


def _gaps(got, want):
    """(largest weight gap, share of the weights within PARAM_ATOL, largest
    running-statistic gap) between two state dicts."""
    w = s = 0.0
    close = total = 0
    for name, v in want.items():
        err = (got[name] - v).abs()
        if name.endswith(("running_mean", "running_var")):
            s = max(s, err.max().item())
        else:
            w = max(w, err.max().item())
            close, total = close + int((err <= PARAM_ATOL).sum()), total + err.numel()
    return w, close / total, s


def _lr_sum(cfg):
    f = train_fields(cfg)
    return sum(max(lr_for_step(s, f[k], f["warmup"], f["total_steps"], f["cosine"], f["lr_min"])
                   for k in ("lr", "ssm_lr")) for s in range(f["total_steps"]))


@pytest.mark.parametrize("job", worker.JOBS)
def test_two_by_two_trains_as_one_process(four_ranks, job):
    """``train.model_parallel: 2`` over 4 ranks against one process: the
    gathered weights within PARAM_ATOL at PARAM_SHARE of the elements and
    within the movement bound everywhere, every BatchNorm statistic within
    STATS_ATOL, each eval's numbers within LOSS_RTOL; every rank's gathered
    state the same, bit for bit (the replicated leaves, and each split
    leaf's rows on the two data ranks that hold them); the weights moved."""
    ref = four_ranks["single"][job]
    ranks = four_ranks["ranks"][job]
    got = ranks[0]
    w, share, s = _gaps(got["state"], ref.model.state_dict())
    assert w <= 2 * _lr_sum(worker.config(job)) + PARAM_ATOL, w
    assert share >= PARAM_SHARE and s <= STATS_ATOL, (share, s)
    assert len(got["history"]) == len(ref.history) == 2
    for h, r in zip(got["history"], ref.history):
        for key in ("train_loss", "test_loss", "test_perf"):
            assert h[key] == pytest.approx(r[key], rel=LOSS_RTOL, abs=1e-6), key
    for other in ranks[1:]:
        for name, v in got["state"].items():
            assert torch.equal(other["state"][name], v), name
    init = build_models(worker.config(job)["model"], generator=torch.Generator().manual_seed(11),
                        device="cpu")[0]
    assert min((got["state"][n] - v).abs().max().item()
               for n, v in init.named_parameters()) > 0


def test_the_gathered_checkpoint_and_its_spectra_are_the_one_process_runs(four_ranks, tmp_path):
    """Rank 0's checkpoint of the ``sm`` job holds the whole model in the
    one-process layout (the same keys and shapes), within the training
    bounds of the one-process checkpoint, and ``eval_eig`` of both gives
    the same η within SPECTRA_RTOL of the largest."""
    from tlie_tpu_torch.analysis import eval_eig

    out = four_ranks["out"]
    ckpts = sorted((out / "ckpt").glob("*.pth"))
    ref_path = four_ranks["single"]["sm"][0]
    assert len(ckpts) == 1 and ref_path
    got, want = restore_checkpoint(str(ckpts[0])), restore_checkpoint(ref_path)
    assert {k: v.shape for k, v in got["model"].items()} == \
        {k: v.shape for k, v in want["model"].items()}
    w, share, _ = _gaps(got["model"], want["model"])
    assert share >= PARAM_SHARE and w <= 2 * _lr_sum(worker.config("sm")) + PARAM_ATOL
    cfg = worker.config("sm")
    batch = worker.split("sm")[1][0][:4]
    eigs = [eval_eig(cfg, {"save_path": str(tmp_path / tag)}, 0.0, path, device="cpu",
                     batch=batch)[0] for tag, path in (("tp", str(ckpts[0])), ("one", ref_path))]
    np.testing.assert_allclose(eigs[0], eigs[1], rtol=0,
                               atol=SPECTRA_RTOL * np.abs(eigs[1]).max())


def test_the_data_sums_on_the_world_group_fail_the_bounds(four_ranks):
    """The control: the BatchNorm LRU job with the data shard's collectives
    on the default group of 4 (the gradients of the two model ranks' rows
    added together) fails the bounds the route's run passes."""
    ref = four_ranks["single"]["lru_batchnorm"]
    w, share, s = _gaps(four_ranks["ranks"]["control"][0]["state"], ref.model.state_dict())
    assert share < PARAM_SHARE, (w, share, s)


def test_a_resume_at_two_by_two_is_the_uninterrupted_run(four_ranks):
    """The ``sm`` job (dropout 0.1) resumed at step 3 from rank 0's
    snapshot (the split leaves and their AdamW moments gathered, and cut
    again on every rank) ends with the uninterrupted run's state, bit for
    bit, on every rank, and its last eval's numbers."""
    for whole, resumed in zip(four_ranks["ranks"]["resume_whole"],
                              four_ranks["ranks"]["resume"]):
        for name, v in whole["state"].items():
            assert torch.equal(resumed["state"][name], v), name
        for key in ("train_loss", "test_loss", "test_perf"):
            assert resumed["history"][-1][key] == whole["history"][-1][key], key


def test_one_step_equals_tlie_tpus_step_on_its_model_mesh(four_ranks):
    """One step of a linear-attention transformer (vocabulary 64) from
    ``tlie_tpu``'s weights on a batch of 8: 4 ranks (2 × 2, 4 rows a data
    rank) against ``make_train_block`` on the conftest's (data 4 × model
    2) mesh.  The loss within 1e-5 relative; each weight within 2e-6 where
    the one-process gradient is at least 1e-2 of its leaf's max|g| (its
    sign settled: Adam's first step is ±lr up to rounding) or exactly 0,
    and within the movement bound 2·lr + 2e-6 everywhere, those elements
    covering at least 60 % of the weights."""
    from tlie_tpu_torch.compat import params_from_jax, params_to_jax

    jparams, jloss = four_ranks["jax_step"]
    params, x, y = four_ranks["step"]
    got = four_ranks["ranks"]["step"]
    assert got[0]["history"][0]["loss"] == pytest.approx(jloss, rel=1e-5)
    model = build_models(worker.STEP_TF, generator=torch.Generator(), device="cpu")[0]
    model.load_state_dict(params_from_jax(params))
    cross_entropy_loss(model(torch.from_numpy(x).long()), torch.from_numpy(y).long()).backward()
    grads, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    got_p, _ = params_to_jax(got[0]["state"])
    n_det = n_all = 0
    for (path, g), w, g0 in zip(jax.tree_util.tree_leaves_with_path(got_p),
                                jax.tree_util.tree_leaves(jparams),
                                jax.tree_util.tree_leaves(grads)):
        err = np.abs(g - w)
        det = (np.abs(g0) >= 1e-2 * np.abs(g0).max()) | (g0 == 0)
        assert err[det].max(initial=0.0) <= 2e-6, path
        assert err.max() <= 2 * worker.STEP_LR + 2e-6, path
        n_det, n_all = n_det + det.sum(), n_all + det.size
    assert n_det >= 0.6 * n_all
    for other in got[1:]:
        for name, v in got[0]["state"].items():
            assert torch.equal(other["state"][name], v), name


# -- serving, the launcher, the schema ----------------------------------------------


@pytest.mark.parametrize("how", ["greedy", "sampled"])
def test_the_decoder_over_four_data_ranks_emits_the_one_process_tokens(four_ranks, how):
    """``Decoder(..., shard=)`` over the 4 ranks (2 prompts each) returns
    the one-process decode's tokens on every rank, greedy and sampled
    (temperature 0.8, top-k 10, one generator seed)."""
    want = four_ranks["decode"][how]
    for rank in four_ranks["ranks"]["decode"]:
        assert torch.equal(rank[how], want)


def test_the_decoder_refuses_a_model_or_time_shard():
    cfg = worker.config("sm")["model"]
    model = build_models(cfg, generator=torch.Generator(), device="cpu")[1]
    for shard in (mesh.Shard(0, 2, vocab=True), mesh.Shard(0, 2, axis=1)):
        with pytest.raises(ValueError, match="more than one axis"):
            Decoder(cfg, model, device="cpu", shard=shard)


def test_launch_takes_the_route_s_process_count(monkeypatch):
    """``launch``'s process count under ``train.model_parallel: 2``:
    ``--nproc`` where 2 divides it, 2 on the CPU without it, every visible
    card on the card; raises where 2 does not divide the count, where fewer
    cards are visible than ``--nproc`` asks for, and beside
    ``--sweep_parallel``; the loop refuses the route without a group and
    where the data size does not divide the batch."""
    from types import SimpleNamespace

    from tlie_tpu_torch import launch
    from tlie_tpu_torch.training import loop

    cfg = {"train": {"batch_size": 8, "model_parallel": 2}}

    def args(**kw):
        return SimpleNamespace(**{"nproc": None, "device": "cuda", "sweep_parallel": False, **kw})

    assert launch._processes(args(device="cpu", nproc=4), cfg) == 4
    assert launch._processes(args(device="cpu"), cfg) == 2
    for bad in (args(device="cpu", nproc=3), args(device="cpu", nproc=4, sweep_parallel=True)):
        with pytest.raises(ValueError):
            launch._processes(bad, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert launch._processes(args(), cfg) == 8
    assert launch._processes(args(nproc=4), cfg) == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="not divisible"):
        launch._processes(args(), cfg)
    with pytest.raises(ValueError, match="one card a process"):
        launch._processes(args(nproc=4), cfg)
    with pytest.raises(ValueError, match="process group"):
        loop._tensor_shards(2, 8)
    monkeypatch.setattr(loop, "process_shard", lambda: mesh.Shard(0, 6))
    monkeypatch.setattr(loop, "mesh_2d", lambda m: (mesh.Shard(0, 3), mesh.Shard(0, 2, vocab=True)))
    with pytest.raises(ValueError, match="batch 8 not divisible by data axis 3"):
        loop._tensor_shards(2, 8)


def test_train_fields_take_the_route_and_turn_the_heads_off():
    """``model_parallel: 2`` is taken, with the sparse and fused heads off
    (``tlie_tpu``'s ``loop.py:302-306``, ``:339-341``); beside
    ``sequence_parallel`` it raises."""
    cfg = worker.config("sm")
    cfg["train"].update(fused_xent=True, sparse_head=True)
    f = train_fields(cfg)
    assert f["model_parallel"] == 2 and not f["sparse_head"] and not f["fused_xent"]
    one = train_fields(dict(cfg, train=dict(cfg["train"], model_parallel=1)))
    assert one["model_parallel"] == 1 and one["sparse_head"] and one["fused_xent"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_fields(dict(cfg, train=dict(cfg["train"], sequence_parallel=2)))


def test_chip_smoke_path_39_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.tensor_parallel_path`` at a tiny cut of
    ``MQAR_SM_ATTENTION_FULL`` and ``MQAR_LRU_FULL`` (d_model and N 32, L
    64, vocabulary 256, batch 8, 4 steps) on the CPU, the flash and scan
    kernels replaced by counting plain versions: the primitives, the route
    at m = 1 in a gloo group of one, the transformer over 2 × 2 and the
    LRU over 1 × 2 against one process, each rank's launches counted, the
    gathered checkpoint's spectra and the decoder over two data ranks."""
    from tlie_tpu_torch import config as config_mod

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True, attention_kernels=True)
    for name in ("MQAR_LRU_FULL", "MQAR_SM_ATTENTION_FULL"):
        tiny = json.loads(json.dumps(getattr(config_mod, name)))
        tiny["dataset"].update(input_seq_length=64, num_kv_pairs=8, vocab_size=256)
        tiny["model"].update(seq_len=64, output_dim=256, hidden_dim=32, state_dim=32)
        if tiny["model"]["layer"] == "lru":
            tiny["model"]["input_dim"] = 256
        else:
            tiny["model"].update(vocab_size=256, max_pos_embed=64, mixer_dim=32)
        tiny["train"]["batch_size"] = 8
        monkeypatch.setattr(config_mod, name, tiny)
    for name, value in (("TP_STEPS", 4), ("TP_TRAIN_EXAMPLES", 128), ("TP_TEST_EXAMPLES", 32),
                        ("TP_PROMPT", 48), ("TP_PRIM_SHAPE", (8, 64, 256, 32))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = cs.tensor_parallel_path(torch.device("cpu"), ARTIFACT_FILES)
    # 4 steps, one eval of 32 // 8 batches on the ranks of data index 0:
    # the transformer's 2 layers, 2 flash launches a forward and 2 of each
    # backward kernel a step; the LRU's 2 layers, 2 scan launches a step
    tf_eval = {"flash_attention_fwd": 2 * (4 + 4), "flash_attention_bwd_dkv": 2 * 4,
               "flash_attention_bwd_dq": 2 * 4}
    tf_rest = dict(tf_eval, flash_attention_fwd=2 * 4)
    assert out["sm"] == [tf_eval, tf_eval, tf_rest, tf_rest]
    lru = {"diag_scan": 2 * (4 + 4), "diag_scan_bwd": 2 * 4}
    assert out["lru"] == [lru, lru]
    assert not mesh.process_shard()
