"""Sequence parallelism over processes (``tlie_tpu_torch/parallel/sp.py``,
``ring.py``, the collectives of ``mesh.py`` and the training loop's
sequence-parallel route) on the CPU, in one group of four gloo processes
(``tests/torch_sp_worker.py``, started once for the module):

- the primitives on seeded inputs, each rank holding its time steps,
  against ``tlie_tpu/parallel/sp.py`` and ``ring.py`` on a 4-device ``seq``
  mesh of the conftest's 8 virtual CPU devices (the halo convolution
  against ``tlie_tpu``'s one-device convolution): outputs and the gradients
  of Σ output·w with respect to every input, at 1e-5 (``tests/test_sp.py``
  holds ``tlie_tpu``'s own at 1e-5 and 2e-5);
- ``train.sequence_parallel: 4`` against the one-process run of the same
  config (computed here while the ranks run) for the LRU, the bidirectional
  S5, Mamba-1 and the softmax, linear and norm attention transformers on
  ``tests/test_sp.py``'s tiny MQAR, with a BatchNorm case and a dropout case:
  final weights at ``tlie_tpu``'s rtol 1e-3 / atol 1e-4, every eval's
  numbers, and the four ranks equal;
- the schema's and the launcher's rules, the dropout mask of a rank's steps,
  and ``tlie_tpu``'s trainer accepting the key for S4, which the port
  refuses.
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

import torch_sp_worker as worker
from tlie_tpu_torch.config import train_fields
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.parallel import mesh
from tlie_tpu_torch.training import train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# the primitives: outputs and gradients within PRIM_ATOL + PRIM_RTOL·|ref|
PRIM_RTOL = PRIM_ATOL = 1e-5
# training: the final weights within tlie_tpu's bounds (tests/test_sp.py),
# each eval's losses and metric within LOSS_RTOL
W_RTOL, W_ATOL, LOSS_RTOL = 1e-3, 1e-4, 1e-4


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The worker's outputs (the primitives' per-rank npz, each job's
    per-rank state and history) beside the one-process run of each job."""
    out = tmp_path_factory.mktemp("sp")
    spec = {"jobs": list(worker.JOBS), "out": str(out)}
    (out / "spec.json").write_text(json.dumps(spec))
    codes = []
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    runner = threading.Thread(target=lambda: codes.append(mesh.spawn(
        [str(ROOT / "tests" / "torch_sp_worker.py"), str(out / "spec.json")], WORLD, env=env,
        timeout=300)))
    runner.start()
    try:
        single = {job: train(worker.config(job), *worker.split(job), device="cpu")
                  for job in worker.JOBS}
    finally:
        runner.join()
    assert codes == [0]
    prims = [dict(np.load(out / f"prims-rank{r}.npz")) for r in range(WORLD)]
    ranks = {job: [torch.load(out / f"{job}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)] for job in worker.JOBS}
    return prims, single, ranks


def _jax_primitive(name):
    """``tlie_tpu``'s function of a case on global inputs, as a tuple of
    outputs, over a 4-device ``seq`` mesh."""
    from tlie_tpu.ops.conv import depthwise_causal_conv1d
    from tlie_tpu.parallel.ring import ring_causal_attention
    from tlie_tpu.parallel.sp import seq_mesh, sp_diag_linear_scan, sp_linear_attention

    m = seq_mesh(WORLD)
    if name in ("scan_real", "scan_axis1"):
        return lambda a, b: (sp_diag_linear_scan(a, b, m, axis=1),)
    if name == "scan_complex":
        def f(ar, ai, br, bi):
            h = sp_diag_linear_scan(jax.lax.complex(ar, ai), jax.lax.complex(br, bi), m)
            return jnp.real(h), jnp.imag(h)
        return f
    if name.startswith("scan"):
        return lambda ar, ai, br, bi: tuple(sp_diag_linear_scan(
            (ar, ai), (br, bi), m, reverse=name == "scan_reverse"))
    if name == "linear":
        return lambda q, k, v: (sp_linear_attention(q, k, v, m, scale=0.5),)
    if name == "linear_normalizer":
        return lambda q, k, v: tuple(sp_linear_attention(q, k, v, m, scale=0.5,
                                                         return_normalizer=True, eps=1e-6))
    if name == "ring":
        return lambda q, k, v: (ring_causal_attention(q, k, v, m, scale=0.5),)
    if name.startswith("pool_"):  # tlie_tpu's pools on global arrays
        return {"pool_mean": lambda x: (x.mean(1),), "pool_sum": lambda x: (x.sum(1),),
                "pool_max": lambda x: (x.max(1),), "pool_last": lambda x: (x[:, -1],),
                "pool_cls": lambda x: (x[:, 0],)}[name]
    if name == "halo_conv":  # the port's (C, 1, K) weight is tlie_tpu's (K, C)
        return lambda x, w, b: (depthwise_causal_conv1d(x, w[:, 0].T, b),)
    raise KeyError(name)


@pytest.mark.parametrize("name", list(worker.primitive_inputs()))
def test_primitive_matches_tlie_tpus_on_a_seq_mesh(four_ranks, name):
    """The four ranks' outputs, joined along time, and their gradients
    (joined along time, or summed over the ranks for an input every rank
    holds whole) against ``tlie_tpu``'s sequence-parallel function on the
    mesh (a pool: its reduction on the whole array; each rank's pooled
    output the same): within PRIM_ATOL + PRIM_RTOL·|ref|."""
    prims = four_ranks[0]
    inputs, dims, n_out = worker.primitive_inputs()[name]
    fn = jax.jit(_jax_primitive(name))
    outs = fn(*inputs)
    assert len(outs) == n_out
    ws = worker.output_weights(name, [o.shape for o in outs])

    def loss(*xs):
        return sum(jnp.sum(o * w) for o, w in zip(fn(*xs), ws))

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs)))))(*inputs)
    for i, o in enumerate(outs):
        parts = [p[f"{name}/out{i}"] for p in prims]
        if name.startswith("pool_"):  # every rank's is the whole output
            for part in parts[1:]:
                np.testing.assert_array_equal(part, parts[0])
            got = parts[0]
        else:
            got = np.concatenate(parts, axis=1)
        np.testing.assert_allclose(got, np.asarray(o), rtol=PRIM_RTOL, atol=PRIM_ATOL)
    for i, (g, d) in enumerate(zip(grads, dims)):
        parts = [p[f"{name}/grad{i}"] for p in prims]
        got = np.concatenate(parts, axis=d) if d is not None else np.sum(parts, axis=0)
        np.testing.assert_allclose(got, np.asarray(g), rtol=PRIM_RTOL, atol=PRIM_ATOL)


@pytest.mark.parametrize("job", worker.JOBS)
def test_four_ranks_train_as_one_process(four_ranks, job):
    """``train.sequence_parallel: 4`` (``train.data_parallel`` left at its
    default, true) against the one-process run: every weight and running
    statistic within W_ATOL + W_RTOL·|ref|, each eval's train and test loss
    and metric within LOSS_RTOL, the four ranks' states equal bit for bit,
    and the weights moved."""
    _, single, ranks = four_ranks
    assert "data_parallel" not in worker.config(job, WORLD)["train"]
    ref = single[job]
    got = ranks[job][0]
    for name, want in ref.model.state_dict().items():
        np.testing.assert_allclose(got["state"][name].numpy(), want.numpy(), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=name)
    assert len(got["history"]) == len(ref.history) == 2
    for h, r in zip(got["history"], ref.history):
        for key in ("train_loss", "test_loss", "test_perf"):
            assert h[key] == pytest.approx(r[key], rel=LOSS_RTOL, abs=1e-6), key
    for other in ranks[job][1:]:
        for name, v in got["state"].items():
            assert torch.equal(other["state"][name], v), name
    init = build_models(worker.config(job)["model"], generator=torch.Generator().manual_seed(11),
                        device="cpu")[0]
    assert min((got["state"][n] - v).abs().max().item()
               for n, v in init.named_parameters()) > 0


def test_dropout_masks_are_the_whole_sequences(monkeypatch):
    """Under a time shard each rank's element-wise mask is its steps of the
    one-process mask (the same generator state draws the whole sequence's),
    and a time-shared mask (the SSM backbone's) is the one-process mask."""
    from tlie_tpu_torch.models.backbone import BroadcastDropout
    from tlie_tpu_torch.models.layers import Dropout

    x = torch.ones(3, 8, 5)
    for cls in (Dropout, BroadcastDropout):
        whole = cls(0.5, torch.Generator().manual_seed(3))(x)
        for r in range(WORLD):
            d = cls(0.5, torch.Generator().manual_seed(3))
            d.shard = mesh.Shard(r, WORLD, axis=1)
            np.testing.assert_array_equal(d(mesh.Shard(r, WORLD, axis=1).steps(x)).numpy(),
                                          mesh.Shard(r, WORLD, axis=1).steps(whole).numpy())


@pytest.mark.parametrize("case", ["mamba2", "ssd_lti", "s4", "model_parallel", "indivisible"])
def test_the_schema_refuses_what_the_route_does_not_cover(case):
    """``train_fields`` raises for the Mamba-2 (its SSD), ``SSD_LTI`` and
    S4, beside ``model_parallel`` and on a length the count does not
    divide; with ``data_parallel`` left at true it takes the route and turns
    the data-parallel one off."""
    cfg = worker.config("lru", WORLD)
    f = train_fields(cfg)
    assert f["sequence_parallel"] == WORLD and f["data_parallel"] is False
    if case in ("mamba2", "ssd_lti"):
        cfg["model"] = dict(worker.MODELS["mamba1"], version="mamba2",
                            pseudoLTI=case == "ssd_lti", seq_len=32)
    elif case == "s4":
        cfg["model"] = dict(cfg["model"], layer="s4")
    elif case == "model_parallel":
        cfg["train"]["model_parallel"] = 2
    else:
        cfg["train"]["sequence_parallel"] = 3
    with pytest.raises(ValueError, match="sequence_parallel"):
        train_fields(cfg)


def test_tlie_tpus_trainer_accepts_the_key_for_s4():
    """The fault the port does not carry: ``tlie_tpu``'s config takes
    ``train.sequence_parallel: 4`` for S4, whose convolution has no route,
    and its forward under the ``sequence_parallel`` context runs the whole
    sequence on one device (its output is the one without the context's,
    bit for bit); the port's schema refuses the same config."""
    from tlie_tpu.config import ExperimentConfig
    from tlie_tpu.models.registry import build_models as jax_build_models
    from tlie_tpu.ops.scan import sequence_parallel as jax_sequence_parallel
    from tlie_tpu.parallel.sp import seq_mesh

    cfg = worker.config("lru", WORLD)
    cfg["model"] = dict(cfg["model"], layer="s4", ssm_lr_vars=["log_step"])
    raw = {k: v for k, v in cfg.items() if k != "lang_model"}
    ExperimentConfig(json.loads(json.dumps(raw))).validate()
    model, _, _ = jax_build_models(dict(cfg["model"]), padded=False)
    x = np.random.default_rng(0).integers(0, 64, size=(2, 32)).astype(np.int32)
    variables = model.init(jax.random.PRNGKey(0), x)
    plain = model.apply(variables, x, mutable=["batch_stats"])[0]
    with jax_sequence_parallel(seq_mesh(WORLD)):
        under = model.apply(variables, x, mutable=["batch_stats"])[0]
    np.testing.assert_array_equal(np.asarray(under), np.asarray(plain))
    with pytest.raises(ValueError, match="S4"):
        train_fields(cfg)


def test_a_shard_raises_on_a_length_the_count_does_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        mesh.Shard(0, WORLD, axis=1).steps(torch.zeros(2, 30))
    assert mesh.Shard(2, WORLD, axis=1).steps(torch.arange(8)[None]).tolist() == [[4, 5]]


def test_launch_takes_the_route_s_process_count(monkeypatch):
    """``launch``'s process count under ``train.sequence_parallel: 4``: 4
    on the CPU and on four cards; a ``--nproc`` that differs, fewer cards
    than processes, or ``--sweep_parallel`` raise; without a group the loop
    refuses the route."""
    from types import SimpleNamespace

    from tlie_tpu_torch import launch

    cfg = {"train": {"batch_size": 8, "sequence_parallel": 4}}

    def args(**kw):
        return SimpleNamespace(**{"nproc": None, "device": "cuda", "sweep_parallel": False, **kw})

    assert launch._processes(args(device="cpu"), cfg) == 4
    assert launch._processes(args(device="cpu", nproc=4), cfg) == 4
    for bad in (args(device="cpu", nproc=2), args(device="cpu", sweep_parallel=True)):
        with pytest.raises(ValueError):
            launch._processes(bad, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch._processes(args(), cfg) == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one card a process"):
        launch._processes(args(), cfg)
    with pytest.raises(ValueError, match="process group of 4"):
        mesh.seq_shard(4)


def test_chip_smoke_path_38_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.sequence_parallel_path`` at a tiny cut of
    ``MQAR_LRU_FULL`` and ``MQAR_SM_ATTENTION_FULL`` (d_model and N 32, L
    64, batch 8, 4 steps) on the CPU: the primitives in a gloo group of one
    in this process and in two processes, the two trainings over the two
    ranks against the one-process runs, the scan's launches counted per
    rank (the plain versions counted under the kernels' names)."""
    from tlie_tpu_torch import config as config_mod
    from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
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
    for name, value in (("SP_STEPS", 4), ("SP_TRAIN_EXAMPLES", 128), ("SP_TEST_EXAMPLES", 32)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = cs.sequence_parallel_path(torch.device("cpu"), ARTIFACT_FILES)
    # 2 layers, 4 steps, one eval of 32 // 8 batches on each rank
    assert out["world_2"] == {"lru": [{"diag_scan": 2 * (4 + 4), "diag_scan_bwd": 2 * 4}] * 2,
                              "sm": [{}, {}]}
    assert not mesh.process_shard()
