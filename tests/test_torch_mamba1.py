"""The port's Mamba-1 (``version: mamba1``, ``configs/mqar-mamba1-small.yaml``)
against tlie_tpu's: the init distributions, the layer against a sequential
float64 oracle, the scan call on the (B, L, d_inner·N) view against
tlie_tpu's ``diag_linear_scan(axis=1)`` on (B, L, d_inner, N), the model's
logits and every parameter's gradient through weights carried by the
port's ``params_from_jax`` (tlie_tpu's own ``torch_state_dict_to_flax`` has
no rule for ``x_proj`` or ``dt_proj``), the block's two dropout masks and
the evaluation-mode identity, ``eig_mamba1`` and eval_eig's artifacts, the
resolved config, ``launch`` end to end on the CPU, and a rehearsal of
``chip_smoke``'s path 18.

The layer is d_model 16, d_state 4, expansion 2 (d_inner 32, dt_rank 1), L
12, batch 3; the model the config at those widths with vocab 50.  Inputs are
made with numpy from a seed; JAX runs jitted at HIGHEST matmul precision
(tests/conftest.py).  Parity runs at dropout 0.  Tolerances are stated where
they are used.
"""

import copy
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_mamba1 as jax_eig_mamba1
from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu.data.mqar import MQAR as JaxMQAR
from tlie_tpu.models import mamba2 as jax_mamba2
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.ops.scan import diag_linear_scan as jax_diag_linear_scan
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.analysis.extractors import eig_mamba1
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import MQAR_MAMBA1_SMALL, load_yaml
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models.mamba2 import Mamba1, MambaBlock
from tlie_tpu_torch.ops.scan import diag_linear_scan
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
from tlie_tpu_torch.training.state import make_family_optimizer
from tlie_tpu_torch.training.steps import head_logits
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "configs" / "mqar-mamba1-small.yaml"
D, N, EXPAND, L, B = 16, 4, 2, 12, 3
D_INNER = EXPAND * D


def small_model_config(**over):
    """The config's model at d_model 16, d_state 4, L 12, vocab 50."""
    cfg = dict(MQAR_MAMBA1_SMALL["model"], hidden_dim=D, state_dim=N, seq_len=L, vocab_size=50,
               output_dim=50, dropout=0.0)
    cfg.update(over)
    return cfg


def _jax_layer_params(seed=0):
    layer = jax_mamba2.Mamba1(d_model=D, d_state=N, d_conv=4, expand=EXPAND)
    u = np.random.default_rng(seed).standard_normal((B, L, D)).astype(np.float32)
    return layer, u, to_numpy(jax.jit(layer.init)(jax.random.PRNGKey(seed), u)["params"])


def _port_layer(params):
    """The port's Mamba1 carrying a flax layer tree (through the block rules
    of ``compat``)."""
    sd = params_from_jax({"blocks_0": {"mamba": params}})
    layer = Mamba1(D, torch.Generator(), d_state=N, d_conv=4, expand=EXPAND)
    layer.load_state_dict({k[len("blocks.0.mamba."):]: v for k, v in sd.items()})
    return layer


def _silu(x):
    return x / (1.0 + np.exp(-x))


def _oracle(u, layer: Mamba1):
    """The whole Mamba-1 layer in float64, one time step at a time, from the
    port's parameters (tests/test_mamba1.py's oracle in nn.Linear layouts)."""
    p = {k: v.detach().double().numpy() for k, v in layer.state_dict().items()}
    u = u.astype(np.float64)
    xz = u @ p["in_proj.weight"].T
    x, z = xz[..., :D_INNER], xz[..., D_INNER:]
    w, K = p["conv1d.weight"][:, 0], p["conv1d.weight"].shape[-1]
    xc = np.zeros_like(x)
    for t in range(L):
        acc = p["conv1d.bias"].copy()
        for k in range(K):
            s = t - (K - 1) + k
            if s >= 0:
                acc = acc + w[:, k] * x[:, s]
        xc[:, t] = acc
    x = _silu(xc)
    x_db = x @ p["x_proj.weight"].T
    r = layer.dt_rank
    dt = np.log1p(np.exp(x_db[..., :r] @ p["dt_proj.weight"].T + p["dt_proj.bias"]))
    B_mat, C_mat = x_db[..., r: r + N], x_db[..., r + N:]
    A = -np.exp(p["A_log"])
    h = np.zeros((B, D_INNER, N))
    y = np.zeros((B, L, D_INNER))
    for t in range(L):
        h = np.exp(dt[:, t][:, :, None] * A) * h + (dt[:, t] * x[:, t])[:, :, None] * \
            B_mat[:, t][:, None, :]
        y[:, t] = np.einsum("bdn,bn->bd", h, C_mat[:, t])
    y = (y + p["D"] * x) * _silu(z)
    return y @ p["out_proj.weight"].T


# -- the layer ------------------------------------------------------------------------

def test_init_distributions():
    """tlie_tpu's Mamba-1 init (``tests/test_mamba1.py:82``): A_log =
    log(1..N) for every channel, D = 1, softplus(dt_proj.bias) a log-uniform
    Δ in [0.001, 0.1], dt_proj.weight U(±dt_rank^−½), the projections
    U(±1/√fan_in) and no bias on in_proj, x_proj and out_proj; dt_rank =
    ⌈d_model/16⌉ (4 at the config's 64); the parameter names are the
    reference's."""
    layer = Mamba1(32, torch.Generator().manual_seed(3), d_state=16)
    assert layer.dt_rank == 2 and Mamba1(64, torch.Generator()).dt_rank == 4
    np.testing.assert_allclose(layer.A_log.detach().numpy(),
                               np.log(np.arange(1, 17))[None, :].repeat(64, 0), rtol=1e-6)
    np.testing.assert_array_equal(layer.D.detach().numpy(), 1.0)
    dt = torch.nn.functional.softplus(layer.dt_proj.bias.detach()).double().numpy()
    assert dt.min() >= 0.001 * 0.99 and dt.max() <= 0.1 * 1.01
    # log-uniform on [ln 0.001, ln 0.1]: the logs' std is 4.605/√12 = 1.33
    assert 1.0 < np.log(dt).std() < 1.7
    assert layer.dt_proj.weight.shape == (64, 2)
    assert layer.dt_proj.weight.abs().max() <= 2 ** -0.5 + 1e-7
    assert layer.in_proj.bias is None and layer.x_proj.bias is None and layer.out_proj.bias is None
    assert layer.in_proj.weight.abs().max() <= 32 ** -0.5
    assert layer.x_proj.weight.shape == (2 + 32, 64)
    _, _, jparams = _jax_layer_params()
    sd = params_from_jax({"blocks_0": {"mamba": jparams}})
    assert {k.split(".")[3] for k in sd} == {
        "in_proj", "conv1d", "x_proj", "dt_proj", "A_log", "D", "out_proj"}


def test_layer_matches_the_sequential_oracle_and_tlie_tpu():
    """The port's layer on tlie_tpu's weights against the float64
    sequential oracle (2e-4 relative, 1e-5 absolute, as tests/test_mamba1.py
    holds tlie_tpu's) and against tlie_tpu's layer (2e-6 absolute)."""
    jlayer, u, params = _jax_layer_params(1)
    layer = _port_layer(params)
    with torch.no_grad():
        got = layer(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, _oracle(u, layer), rtol=2e-4, atol=1e-5)
    want = np.asarray(jax.jit(jlayer.apply)({"params": params}, u))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_the_lattice_view_scan_is_tlie_tpus_axis_1_scan(reverse):
    """``diag_linear_scan`` on the contiguous (B, L, d_inner·N) view of a
    time-varying decay and input equals tlie_tpu's
    ``diag_linear_scan(a, bx, axis=1)`` on (B, L, d_inner, N), values and
    the gradients of a weighted sum for a and bx, 1e-6 of each one's max;
    the views are the tensors themselves, not copies."""
    rng = np.random.default_rng(2 + reverse)
    a = rng.uniform(0.0, 1.0, (B, L, D_INNER, N)).astype(np.float32)
    bx = rng.standard_normal((B, L, D_INNER, N)).astype(np.float32)
    w = rng.standard_normal((B, L, D_INNER, N)).astype(np.float32)

    def jloss(a, bx):
        return jnp.sum(jax_diag_linear_scan(a, bx, axis=1, reverse=reverse) * w)

    want = np.asarray(jax_diag_linear_scan(a, bx, axis=1, reverse=reverse))
    jda, jdb = jax.grad(jloss, argnums=(0, 1))(a, bx)
    ta, tb = (torch.from_numpy(t).requires_grad_() for t in (a, bx))
    view_a, view_b = ta.reshape(B, L, -1), tb.reshape(B, L, -1)
    assert view_a.data_ptr() == ta.data_ptr() and view_b.is_contiguous()
    h = diag_linear_scan(view_a, view_b, reverse=reverse)
    (h.view(B, L, D_INNER, N) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(h.detach().view(B, L, D_INNER, N).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    for got, ref in ((ta.grad, jda), (tb.grad, jdb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


# -- the model --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The cut config at dropout 0, tlie_tpu's weights for it, and an MQAR
    split (L 12, vocab 50) with K for the sparse head."""
    model_cfg = small_model_config()
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=False)
    x0 = np.zeros((1, L), np.int32)
    params = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), x0)["params"])
    data = MQAR(input_seq_length=L, num_kv_pairs=2, vocab_size=50, num_train_examples=96,
                num_test_examples=32)
    train, test = data.split("train"), data.split("test")
    return model_cfg, jeval, params, train, test, sparse_head_k_for(model_cfg, train[1], test[1])


def _port(model_cfg, params):
    model, eval_model, family = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    assert family == "mamba" and isinstance(model.blocks[0].mamba, Mamba1)
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


def test_logits_match_jax(small):
    """The eval forward on 3 test examples, 2e-5 of max|logit|."""
    model_cfg, jeval, params, _, test, _ = small
    x = test[0][:B]
    want = np.asarray(jax.jit(jeval.apply)({"params": params}, x.astype(np.int32)))
    _, model = _port(model_cfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_every_gradient_matches_jax(small):
    """The sparse-head loss (1e-5 relative) and the gradient of every leaf,
    dt_proj and A_log (the scan backward's da) included, within 1e-4 of that
    leaf's max|g|."""
    model_cfg, jeval, params, train, _, k = small

    def jloss(params, x, y):
        feats = jeval.apply({"params": params}, x, method=type(jeval).features)
        _, pos = jax.lax.top_k((y != -100).astype(jnp.int32), k)
        f_sel = jnp.take_along_axis(feats, pos[..., None], axis=1)
        logits = f_sel @ params["decoder"]["kernel"] + params["decoder"]["bias"]
        return jax_scan_loop.cross_entropy_loss(logits, jnp.take_along_axis(y, pos, axis=1))

    x, y = train[0][:16], train[1][:16]
    lval, jgrads = jax.jit(jax.value_and_grad(jloss))(params, x.astype(np.int32),
                                                       y.astype(np.int32))
    model, _ = _port(model_cfg, params)
    loss = cross_entropy_loss(*head_logits(model, torch.from_numpy(x), torch.from_numpy(y), k))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(lval), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    assert set(got["blocks_1"]["mamba"]) == {"in_proj", "conv1d", "x_proj", "dt_proj", "A_log",
                                             "D", "out_proj"}
    assert len(jax.tree_util.tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=str(path))


def test_compat_carries_x_proj_and_dt_proj_both_ways_exactly(small):
    """``blocks.{i}.mamba.{x_proj,dt_proj}.weight`` (transposed) and
    ``dt_proj.bias``: params_from_jax then params_to_jax gives tlie_tpu's
    tree back bit for bit."""
    model_cfg, _, params, _, _, _ = small
    sd = params_from_jax(params)
    assert sd["blocks.0.mamba.x_proj.weight"].shape == (1 + 2 * N, D_INNER)
    assert sd["blocks.1.mamba.dt_proj.weight"].shape == (D_INNER, 1)
    assert flax_path("blocks.1.mamba.dt_proj.bias") == ("params", "blocks_1", "mamba", "dt_proj",
                                                        "bias")
    back, stats = params_to_jax(sd)
    assert stats is None
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(back)] == [p for p, _ in leaves]
    for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    model, _ = _port(model_cfg, params)
    assert set(model.state_dict()) == set(sd)


# -- dropout ----------------------------------------------------------------------------

@pytest.mark.parametrize("glu", [True, False], ids=["glu", "no_glu"])
def test_block_draws_two_dropout_masks_and_is_the_identity_in_eval(glu):
    """The block's one Dropout runs twice, after the GELU and after the GLU
    (twice in a row without it): two masks drawn one after the other from
    its generator, kept values scaled by 1/(1 − rate); a block in evaluation
    mode equals the block at dropout 0 on the same weights."""
    cfg = small_model_config(dropout=0.25, glu=glu)
    blk = MambaBlock(cfg, torch.Generator().manual_seed(0))
    blk.drop.generator = torch.Generator().manual_seed(5)
    u = torch.randn(B, L, D)
    with torch.no_grad():
        out = blk.train()(u)
        g = torch.Generator().manual_seed(5)
        x = torch.nn.functional.gelu(blk.mamba(blk.norm(u)))
        x = x * torch.empty(x.shape).bernoulli_(0.75, generator=g) / 0.75
        if glu:
            x = blk.glu(x)
        x = x * torch.empty(x.shape).bernoulli_(0.75, generator=g) / 0.75
        torch.testing.assert_close(out, x + u, rtol=0, atol=0)
        plain = MambaBlock(small_model_config(glu=glu), torch.Generator())
        plain.load_state_dict(blk.state_dict())
        torch.testing.assert_close(blk.eval()(u), plain(u), rtol=0, atol=0)


def test_dropout_masks_come_from_the_model_generator():
    """Two models built from one seed draw the same training-mode outputs
    (the registry's dropout generator is seeded from the weights' one),
    and their outputs differ from the evaluation-mode ones."""
    cfg = small_model_config(dropout=0.1)
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 50, (B, L)))
    outs = []
    for _ in range(2):
        model, eval_model, _ = build_models(cfg, generator=torch.Generator().manual_seed(4),
                                            device="cpu")
        with torch.no_grad():
            outs.append((model(x), eval_model(x)))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    assert not torch.equal(outs[0][0], outs[0][1])


# -- the spectra ------------------------------------------------------------------------

def test_eig_mamba1_matches_jax():
    """``eig_mamba1`` against tlie_tpu's on the same weights and inputs, 1e-5
    relative, (B, L, d_inner·N), inside (0, 1)."""
    jlayer, u, p = _jax_layer_params(4)
    layer = _port_layer(p)
    want = np.asarray(jax.jit(jax_eig_mamba1, static_argnames=("d_inner", "dt_rank"))(
        u, p["in_proj"]["kernel"], None, p["conv1d"]["weight"], p["conv1d"]["bias"],
        p["x_proj"]["kernel"], p["dt_proj"]["kernel"], p["dt_proj"]["bias"], p["A_log"],
        d_inner=D_INNER, dt_rank=jlayer.rank))
    with torch.no_grad():
        got = eig_mamba1(torch.from_numpy(u), layer.in_proj.weight, None, layer.conv1d.weight,
                         layer.conv1d.bias, layer.x_proj.weight, layer.dt_proj.weight,
                         layer.dt_proj.bias, layer.A_log, D_INNER, layer.dt_rank).numpy()
    assert got.shape == want.shape == (B, L, D_INNER * N)
    assert np.all((got > 0) & (got < 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_eval_eig_artifacts_match_tlie_tpu(small, tmp_path):
    """From one port checkpoint (the small model after two large steps, so
    that dt_proj and A_log have moved), both packages write the same 12
    artifacts under the same name: λ (B, L, d_inner·N, layers) within 1e-5
    relative, the percentages within 1e-5 and the report's trained lines
    equal; the init spectra inside (0, 1]."""
    model_cfg, _, params, train, test, k = small
    args = copy.deepcopy(MQAR_MAMBA1_SMALL)
    args["model"] = model_cfg
    args["dataset"].update(input_seq_length=L, num_kv_pairs=2, vocab_size=50)
    model, _ = _port(model_cfg, params)
    opt, clip = make_family_optimizer(model, "mamba", model_cfg, args["train"],
                                      {"lr": 0.05, "wd": 0.1, "betas": (0.9, 0.999)})
    x, y = torch.from_numpy(train[0][:16]), torch.from_numpy(train[1][:16])
    for _ in range(2):
        train_step(model, opt, x, y, {"regular": 0.05}, k, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    batch = test[0][:8]
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(batch.astype(np.int32), test[1][:8], {})], ckpt, 0.5,
                           params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and pdir.startswith("MQARdmodel16")
    pfiles = sorted(os.listdir(tmp_path / "port" / pdir))
    assert pfiles == sorted(os.listdir(tmp_path / "jax" / jdir)) == ARTIFACT_FILES
    eig, eig_init = port_out[0], port_out[1]
    assert eig.shape == eig_init.shape == (8, L, D_INNER * N, 2) and eig.dtype == np.float32
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=1e-5, atol=0)
    assert np.all((eig_init > 0) & (eig_init <= 1))
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    with torch.no_grad():
        live = extract_attention_family(model.eval(), torch.from_numpy(batch), model_cfg)
    np.testing.assert_array_equal(live, eig)


# -- the config and launch ----------------------------------------------------------------

def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    exp = jax_load_experiment(YAML)
    data = JaxMQAR(**exp.dataset)

    class _Shape:
        l_max = data.l_max
        train_inputs = range(data.num_train_examples)

    exp.derive_runtime_fields(_Shape())
    assert MQAR_MAMBA1_SMALL == exp.raw


def test_launch_trains_checkpoints_and_analyses_mamba1_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on the config cut to 6 steps with an eval every 3,
    L 16, 4 pairs, 192 train and 32 test examples, at its dropout 0.1: the
    checkpoint, the 12 artifacts, and λ (8, 16, 2048, 2) from the
    checkpoint inside [0, 1]."""
    cfg = load_yaml(YAML)
    cfg["save"] = str(tmp_path / "checkpoint" / "mqar-mamba1-small")
    cfg["train"].update(total_steps=6, eval_every=3)
    cfg["dataset"].update(input_seq_length=16, num_kv_pairs=4, num_train_examples=192,
                          num_test_examples=32)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 8, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 6:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, 16, 128 * 16, 2) and np.all((eig >= 0) & (eig <= 1))


# -- the card run's path 18, rehearsed ----------------------------------------------

def test_chip_smoke_path_18_runs_on_the_cpu_with_counting_plain_kernels(monkeypatch):
    """``chip_smoke.mamba1_path`` on the config's own widths and split (L
    64, 20,000 train and 512 test examples) at 4 steps with an eval every
    2, the card's timers and profiler stubbed and the scan kernels replaced
    by counting plain versions: 2 + 2 scan launches a training step and 2 a
    forward, the checkpoint's spectra, the card step against float64, the
    step timing and the kernels at the trained model's own decay all run
    as on the card."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
    for name, value in (("M1_STEPS", 4), ("M1_EVAL_EVERY", 2), ("M1_ANALYSIS_BATCH", 8)):
        monkeypatch.setattr(cs, name, value)
    launches, (times, errs, a_range) = cs.mamba1_path(torch.device("cpu"), ARTIFACT_FILES,
                                                      torch.zeros(4))
    # training alone is held exactly inside the path; the forward also
    # launches in the forward phase and the eigen-analysis
    n_eval = 2 * (512 // 32)
    assert launches["diag_scan_bwd"] == 2 * 4 and launches["diag_scan"] > 2 * (4 + n_eval)
    assert not any(v for k, v in launches.items() if not k.startswith("diag_scan"))
    assert set(times) == {"diag_scan", "diag_scan_rev", "diag_scan_bwd"}
    assert 0.0 <= a_range[0] <= a_range[1] <= 1.0 and errs["fwd"][0] <= 1e-5
