"""Data parallelism over processes (``tlie_tpu_torch/parallel/mesh.py`` and
the training loop's data-parallel route) on the CPU, in gloo groups:

- a 4-rank run of a tiny MQAR LRU (BatchNorm, dropout 0.1, the sparse head)
  and of a tiny MQAR softmax transformer through the dense and through the
  fused head, on a train split whose shards hold different valid counts:
  the final weights, BatchNorm running statistics and per-eval numbers
  equal the one-process run's, and every rank ends with the same state;
- the negative control: the same LRU run with per-shard means (each rank's
  own valid count and statistics, the gradients averaged) fails that check;
- one 4-rank step of the LRU from ``tlie_tpu``'s weights (carried by
  ``compat``) against ``tlie_tpu``'s scanned block on the conftest's
  8-device data mesh;
- ``chip_smoke.data_parallel_path`` (path 37) rehearsed at world size 1 (in
  this process) and 2 (two processes) over gloo, its 2-rank stacked sweep
  against the one-process stacked sweep.

Two spawns in all: the 4-rank worker (``tests/torch_dp_worker.py``) runs
while this process computes the one-process runs and ``tlie_tpu``'s step;
path 37 starts its own two processes.  Tolerances are stated where used.
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import torch_dp_worker as worker
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import train_fields
from tlie_tpu_torch.parallel import mesh
from tlie_tpu_torch.training import train
from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
from tlie_tpu_torch.training.steps import cross_entropy_loss, head_logits
from tlie_tpu_torch.training.schedules import lr_for_step
from torch_parity import ARTIFACT_FILES, jax_weights, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
JOBS = ("lru", "tf_dense", "tf_fused")
# after 6 steps, a weight of the 4-rank run within PARAM_ATOL of the
# one-process run's at PARAM_SHARE of the elements at least (the sums over
# the group add in another order: 4e-6 at most in the LRU), and within the
# movement bound 2·Σ lr everywhere: Adam's lr·g/(|g| + eps) follows the
# rounding of a gradient that is zero in exact arithmetic (the key bias of
# softmax attention, 64 of the transformer's 30k weights, 8e-5 apart); a
# running statistic within STATS_ATOL, each eval's numbers within LOSS_RTOL
PARAM_ATOL, PARAM_SHARE, STATS_ATOL, LOSS_RTOL = 2e-5, 0.99, 1e-6, 1e-5
STEP_LR = 1e-3


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank worker's outputs beside the one-process runs of the same
    jobs, and ``tlie_tpu``'s step on the 8-device data mesh."""
    out = tmp_path_factory.mktemp("dp")
    _, params, stats = jax_weights(_step_config(), seed=0, stats_seed=1)
    torch.save(params_from_jax(params, stats), out / "init.pt")
    (tx, ty), te = worker.split()
    x, y = tx[:8], ty[:8]
    k = sparse_head_k_for(worker.LRU, ty, te[1])
    np.savez(out / "batch.npz", x=x, y=y, k=k)
    spec = {"jobs": [*JOBS, "step", "control"], "out": str(out), "step_init": str(out / "init.pt"),
            "step_batch": str(out / "batch.npz"), "step_lr": STEP_LR}
    (out / "spec.json").write_text(json.dumps(spec))
    codes = []
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    runner = threading.Thread(target=lambda: codes.append(mesh.spawn(
        [str(ROOT / "tests" / "torch_dp_worker.py"), str(out / "spec.json")], WORLD, env=env,
        timeout=300)))
    runner.start()
    try:
        single = {job: train(worker.config(job), (tx, ty), te, device="cpu") for job in JOBS}
        jax_step = _jax_step(params, stats, x, y, k)
    finally:
        runner.join()
    assert codes == [0]
    ranks = {job: [torch.load(out / f"{job}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)] for job in spec["jobs"]}
    return single, ranks, jax_step, (params, stats, x, y, k)


def _step_config():
    """The LRU of the one-step check, the worker's ``STEP_LRU``."""
    return dict(worker.STEP_LRU, seq_len=worker.MQAR_TINY["input_seq_length"])


def _jax_step(params, stats, x, y, k):
    """One step of ``tlie_tpu``'s scanned block on the 8-device ``data``
    mesh, the state and data replicated and each batch sharded over it, as
    ``tlie_tpu``'s loop lays them (``loop.py:218-283``)."""
    cfg = _step_config()
    jmodel, _, _ = jax_build_models(cfg, padded=False)
    state, _ = create_train_state(
        jmodel, jax.random.PRNGKey(0), in_dim=cfg["input_dim"], batch_size=2,
        seq_len=worker.MQAR_TINY["input_seq_length"], weight_decay=worker.TRAIN["wd"],
        norm="batch", ssm_lr=STEP_LR, ssm_vars=cfg["ssm_lr_vars"], lr=STEP_LR, padded=False,
        betas=(0.9, 0.999), integer_inputs=True)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    data_mesh = Mesh(np.asarray(jax.devices()), ("data",))
    assert data_mesh.shape["data"] == 8
    repl = NamedSharding(data_mesh, PartitionSpec())
    state = jax.device_put(state, repl)
    # a constant rate: no warmup, no decay over the block's one step
    block = jax_scan_loop.make_train_block(
        jmodel, "batch", tuple(sorted(state.opt_state.inner_states)), 0, 1, False, STEP_LR,
        sparse_head_k=int(k), mesh=data_mesh)
    data = jax_scan_loop.put_dataset(x, y, sharding=repl)
    jstate, jloss = block(state, jax.random.PRNGKey(1), data, np.arange(8)[None], 0, STEP_LR,
                          STEP_LR)
    return to_numpy(jstate.params), to_numpy(jstate.batch_stats), float(jloss)


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
    """Σ lr over the run's steps, the larger of its two groups'."""
    f = train_fields(cfg)
    return sum(max(lr_for_step(s, f[k], f["warmup"], f["total_steps"], f["cosine"], f["lr_min"])
                   for k in ("lr", "ssm_lr")) for s in range(f["total_steps"]))


def test_the_shards_hold_different_valid_counts():
    """The premise of the global denominators: the first batch's four
    shards hold different numbers of valid labels."""
    (_, ty), _ = worker.split()
    counts = [(mesh.Shard(r, WORLD).rows(ty[:8]) != -100).sum() for r in range(WORLD)]
    assert len(set(counts)) > 1, counts


@pytest.mark.parametrize("job", JOBS)
def test_four_ranks_take_the_one_process_steps(four_ranks, job):
    """Each job's 4-rank run against its one-process run: the weights
    within PARAM_ATOL at PARAM_SHARE of the elements and within the
    movement bound everywhere, every BatchNorm running statistic within
    STATS_ATOL, each eval's train and test loss and metric within
    LOSS_RTOL; the four ranks end with the same state, bit for bit."""
    single, ranks, _, _ = four_ranks
    ref = single[job]
    got = ranks[job][0]
    w, share, s = _gaps(got["state"], ref.model.state_dict())
    assert w <= 2 * _lr_sum(worker.config(job)) + PARAM_ATOL, w
    assert share >= PARAM_SHARE and s <= STATS_ATOL, (share, s)
    assert len(got["history"]) == len(ref.history) == 2
    for h, r in zip(got["history"], ref.history):
        for key in ("train_loss", "test_loss", "test_perf"):
            assert h[key] == pytest.approx(r[key], rel=LOSS_RTOL), key
    for other in ranks[job][1:]:
        for name, v in got["state"].items():
            assert torch.equal(other["state"][name], v), name
    # the weights moved: the check above compares trained models
    init, _, _ = worker.build_models(worker.config(job)["model"],
                                     generator=torch.Generator().manual_seed(1919), device="cpu")
    assert min((got["state"][n] - v).abs().max().item()
               for n, v in init.named_parameters()) > 0


def test_per_shard_means_fail_the_same_check(four_ranks):
    """The negative control: the LRU job with each rank's own valid count
    and BatchNorm statistics and the gradients averaged (a plain DDP wrap)
    fails the check the route's run passes: fewer than PARAM_SHARE of its
    weights within PARAM_ATOL, its running statistics beyond STATS_ATOL."""
    single, ranks, _, _ = four_ranks
    w, share, s = _gaps(ranks["control"][0]["state"], single["lru"].model.state_dict())
    assert share < PARAM_SHARE and s > 10 * STATS_ATOL, (w, share, s)


def test_one_four_rank_step_equals_tlie_tpus_step_on_the_data_mesh(four_ranks):
    """One step of a one-layer LRU (BatchNorm, the sparse head, dropout 0)
    from ``tlie_tpu``'s weights and moved statistics on a batch of 8: 4 ranks of
    2 rows against ``make_train_block`` on the 8-device data mesh (1 row a
    device).  The loss within 1e-5 relative; the running statistics within
    1e-5; each weight within 2e-6 where its gradient (the port's, on the
    whole batch in one process) is at least 1e-2 of its leaf's max|g|
    (there its sign is settled, and Adam's first step is ±lr up to
    rounding) or exactly 0 (the embedding rows of tokens the batch does not
    hold: weight decay alone moves them), and within the movement bound
    2·lr + 2e-6 everywhere, those elements covering at least 70 % of the
    weights (73 % here: most of the decoder's columns, classes far from
    the batch's labels, take gradients below 1e-2 of its max)."""
    _, ranks, (jparams, jstats, jloss), (params, stats, x, y, k) = four_ranks
    model, _, _ = worker.build_models(_step_config(), generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    cross_entropy_loss(*head_logits(model, torch.from_numpy(x).long(),
                                    torch.from_numpy(y).long(), int(k))).backward()
    grads, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    got = ranks["step"][0]
    assert got["history"][0]["loss"] == pytest.approx(jloss, rel=1e-5)
    got_p, got_s = params_to_jax(got["state"])
    for g, w in zip(jax.tree_util.tree_leaves(got_s), jax.tree_util.tree_leaves(jstats)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    n_det = n_all = 0
    for (path, g), w, g0 in zip(jax.tree_util.tree_leaves_with_path(got_p),
                                jax.tree_util.tree_leaves(jparams),
                                jax.tree_util.tree_leaves(grads)):
        err = np.abs(g - w)
        det = (np.abs(g0) >= 1e-2 * np.abs(g0).max()) | (g0 == 0)
        assert err[det].max(initial=0.0) <= 2e-6, path
        assert err.max() <= 2 * STEP_LR + 2e-6, path
        n_det, n_all = n_det + det.sum(), n_all + det.size
    assert n_det >= 0.7 * n_all


def test_chip_smoke_path_37_runs_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.data_parallel_path`` at a tiny cut of ``MQAR_LRU_FULL``
    (d_model and N 32, L 64, batch 8, 4 steps) on the CPU: the route in a
    gloo group of one in this process and in two processes, each against
    the one-process run from the same seed (weights and statistics), the
    scan's launches counted per rank (the plain versions counted under the
    kernels' names), and the stacked sweep of four seeds over the two ranks
    against the one-process stacked sweep."""
    from tlie_tpu_torch import config as config_mod

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
    tiny = json.loads(json.dumps(config_mod.MQAR_LRU_FULL))
    tiny["dataset"].update(input_seq_length=64, num_kv_pairs=8, vocab_size=256)
    tiny["model"].update(seq_len=64, input_dim=256, output_dim=256, hidden_dim=32, state_dim=32)
    tiny["train"]["batch_size"] = 8
    monkeypatch.setattr(config_mod, "MQAR_LRU_FULL", tiny)
    for name, value in (("DP_STEPS", 4), ("DP_TRAIN_EXAMPLES", 128), ("DP_TEST_EXAMPLES", 32)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    launches = cs.data_parallel_path(torch.device("cpu"), ARTIFACT_FILES)
    # 2 layers, 4 steps, one eval of 32 // 8 batches on rank 0
    assert launches["world_1"] == {"diag_scan": 2 * (4 + 4), "diag_scan_bwd": 2 * 4}
    assert launches["world_2"] == [{"diag_scan": 2 * (4 + 4), "diag_scan_bwd": 2 * 4},
                                   {"diag_scan": 2 * 4, "diag_scan_bwd": 2 * 4}]
    assert launches["sweep_2"] == [{"diag_scan": 2 * (4 + 4), "diag_scan_bwd": 2 * 4}] * 2
    assert not mesh.process_shard()


def test_the_route_follows_data_mesh_rule(monkeypatch):
    """``data_shard`` is ``_data_mesh``'s rule: no group, no route; a batch
    the world size does not divide, or ``train.data_parallel: false``, no
    route; ``train_fields`` reads the flag (true by default) and still
    takes tensor parallelism, which the launcher refuses where its model
    group does not divide the process count; sequence parallelism it takes
    where the world size divides the length, and its route leaves the
    data-parallel one off."""
    assert mesh.data_shard(8) is None
    monkeypatch.setattr(mesh, "process_shard", lambda: mesh.Shard(1, 4))
    assert mesh.data_shard(8) == mesh.Shard(1, 4)
    assert mesh.data_shard(6) is None and mesh.data_shard(8, enabled=False) is None
    cfg = worker.config("lru")
    assert train_fields(cfg)["data_parallel"] is True
    cfg["train"]["data_parallel"] = False
    assert train_fields(cfg)["data_parallel"] is False
    assert train_fields({**cfg, "train": {**cfg["train"], "model_parallel": 2}})[
        "model_parallel"] == 2
    from types import SimpleNamespace

    from tlie_tpu_torch import launch

    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        launch._processes(SimpleNamespace(nproc=3, device="cpu", sweep_parallel=False),
                          {"train": {**cfg["train"], "model_parallel": 2}})
    sp = train_fields({**cfg, "train": {**cfg["train"], "sequence_parallel": 2}})
    assert sp["sequence_parallel"] == 2 and sp["data_parallel"] is False
    with pytest.raises(ValueError, match="not divisible"):
        train_fields({**cfg, "train": {**cfg["train"], "sequence_parallel": 3}})
    rows = mesh.Shard(1, 4).rows(torch.arange(8))
    assert rows.tolist() == [2, 3]


def test_launch_starts_one_process_per_card_where_the_route_applies(monkeypatch):
    """``launch``'s process count: ``--nproc`` as given; on the card, one
    per visible card where more than one is visible and the batch divides
    (every card for a stacked sweep); none with one card or on the CPU."""
    from types import SimpleNamespace

    from tlie_tpu_torch import launch

    cfg = {"train": {"batch_size": 8}}

    def args(**kw):
        return SimpleNamespace(**{"nproc": None, "device": "cuda", "sweep_parallel": False, **kw})

    assert launch._processes(args(nproc=3, device="cpu"), cfg) == 3
    assert launch._processes(args(device="cpu"), cfg) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for n, want in ((1, 0), (4, 4), (3, 0)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        assert launch._processes(args(), cfg) == want
        assert launch._processes(args(sweep_parallel=True), cfg) == (n if n > 1 else 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch._processes(args(), {"train": {"batch_size": 8, "data_parallel": False}}) == 0
