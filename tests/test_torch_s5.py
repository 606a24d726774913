"""The port's S5 against tlie_tpu's on the CPU: the copied HiPPO functions
(bit for bit), the layer's forward and gradients (ZOH and bilinear, conj-sym
on and off, bidirectional on and off, clipped eigenvalues, every C_init's
shapes), the small MQAR model (``configs/mqar-s5-small.yaml``: logits and
gradients), ``create_train_state_s5``'s optimiser over two steps, the
spectra and eval_eig's artifacts, teacher-forced decoding, the bidirectional
decoder's raise, ``compat`` both ways, ``launch`` end to end, the scan's
(P,) decay through the kernels' routing, and the card run's path 12
rehearsed.

Weights are drawn by JAX, carried with ``compat``; inputs are made with
numpy from a seed; JAX runs jitted at HIGHEST matmul precision.  Tolerances
are stated where they are used: float32 on both sides, the port's
sequential scan against JAX's associative one."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tlie_tpu.analysis.eval_eig import _extract_ssm_family, _ssm_layer_params
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_s5 as jax_eig_s5
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models import initializers as jinit
from tlie_tpu.models.s5 import init_S5 as jax_init_S5
from tlie_tpu.training.state import create_train_state_s5
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
from tlie_tpu_torch.analysis.extractors import eig_s5
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import MQAR_S5_FULL, load_yaml, train_fields
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models import initializers as tinit
from tlie_tpu_torch.models.s5 import init_S5
from tlie_tpu_torch.ops import scan as scan_ops
from tlie_tpu_torch.training.state import S5_SSM_VARS, make_family_optimizer
from torch_parity import Jitted, jax_apply, jax_weights, port_model, to_numpy, tokens

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")
ROOT = Path(__file__).resolve().parents[1]
SMALL_YAML = "configs/mqar-s5-small.yaml"
FULL_YAML = "configs/tasks/mqar/mqar-s5.yaml"
# float32 forward on both sides, the same products in other orders
FWD_RTOL_OF_MAX = 2e-5
# gradients: sums over batch and time in other orders, the scan's gradient
# summed over L and B for Λ̄
GRAD_RTOL_OF_MAX = 2e-5


def small_config():
    cfg = load_yaml(ROOT / SMALL_YAML)
    cfg["model"]["seq_len"] = cfg["dataset"]["input_seq_length"]
    return cfg


def tiny_config():
    """The small config cut further (d_model and state 16, vocab 64, L 16)
    where a test builds tlie_tpu's state or inits several variants."""
    cfg = small_config()
    cfg["model"].update(hidden_dim=16, state_dim=16, input_dim=64, output_dim=64, seq_len=16)
    return cfg


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the HiPPO copies -------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128])
def test_hippo_copies_are_bit_equal(n):
    """make_hippo, make_nplr_hippo and make_dplr_hippo (Λ, P, B, V, B_orig)
    give tlie_tpu's arrays bit for bit, dtypes included: the eigh's
    eigenvector phases too."""
    assert np.array_equal(tinit.make_hippo(n), jinit.make_hippo(n))
    for got, want in zip(tinit.make_nplr_hippo(n), jinit.make_nplr_hippo(n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(tinit.make_dplr_hippo(n), jinit.make_dplr_hippo(n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("conj_sym", [True, False])
def test_init_S5_constants_are_bit_equal(conj_sym):
    """Λ, V and V⁻¹ of the block-diagonal init are tlie_tpu's bits."""
    cfg = {"num_blocks": 4, "conj_sym": conj_sym}
    want = jax_init_S5(32, 8, **cfg).keywords
    got = init_S5(32, 8, torch.Generator(), **cfg)
    for i, key in enumerate(("Lambda_re_init", "Lambda_im_init", "V_re", "V_im", "Vinv_re",
                             "Vinv_im")):
        assert np.array_equal(got.args[i], want[key]) and got.args[i].dtype == np.float32
    assert got.keywords["P"] == want["P"] == (16 if conj_sym else 32)


def test_init_draws_follow_their_distributions():
    """The random inits cannot match JAX's draws: log Δ is uniform on
    [log dt_min, log dt_max], D standard normal, B = V⁻¹ B_real with the
    lecun fan-in, C̃ = C V."""
    seq = init_S5(128, 64, torch.Generator().manual_seed(3), num_blocks=8,
                  dt_min=0.001, dt_max=0.1)()
    step = torch.exp(seq.log_step).flatten()
    assert seq.log_step.shape == (64, 1) and bool((step >= 0.001).all() & (step <= 0.1).all())
    assert seq.B.shape == (64, 64, 2) and seq.C.shape == (64, 64, 2) and seq.D.shape == (64,)
    # B_real (2P, H) has variance 1/(2P) an entry; V⁻¹'s P rows are orthonormal
    # (half of each block's eigenvectors, conj-sym), so |V⁻¹ b|² summed over the
    # state has mean P/(2P) = 1/2 a column
    b = torch.complex(seq.B[..., 0], seq.B[..., 1]).detach()
    assert 0.45 < float((b.abs() ** 2).sum(0).mean()) < 0.55


# -- the layer ------------------------------------------------------------------------------

H, N_STATE, L = 8, 16, 32
LAYER_CASES = [
    dict(discretization=d, conj_sym=cs, bidirectional=bd, clip_eigs=clip)
    for d, cs, bd, clip in (("zoh", True, False, False), ("zoh", False, False, True),
                            ("zoh", True, True, False), ("zoh", False, True, False),
                            ("bilinear", True, False, True), ("bilinear", False, False, False),
                            ("bilinear", True, True, False), ("bilinear", False, True, True))
]


def _layers(case, c_init="lecun_normal"):
    cfg = dict(num_blocks=2, C_init=c_init, **case)
    jlayer = jax_init_S5(N_STATE, H, **cfg)()
    u = np.random.default_rng(0).standard_normal((2, L, H)).astype(np.float32)
    params = to_numpy(jax.jit(jlayer.init)(jax.random.PRNGKey(1), u)["params"])
    layer = init_S5(N_STATE, H, torch.Generator(), **cfg)()
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return jlayer, params, layer, u


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: "-".join(
    [c["discretization"], "conj" if c["conj_sym"] else "full",
     "bidir" if c["bidirectional"] else "causal"] + (["clip"] if c["clip_eigs"] else [])))
def test_layer_forward_and_gradients_match_jax(case):
    """y and the gradients of every leaf and of u for the loss Σ y·w, within
    2e-5 of each one's largest magnitude."""
    jlayer, params, layer, u = _layers(case)
    w = np.random.default_rng(1).standard_normal((2, L, H)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jlayer.apply({"params": p}, x) * w)

    want_y = np.asarray(jax.jit(jlayer.apply)({"params": params}, u))
    want_gp, want_gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, u)
    ut = torch.from_numpy(u).requires_grad_()
    y = layer(ut)
    (y * torch.from_numpy(w)).sum().backward()
    assert rel_to_max(y.detach(), want_y) <= FWD_RTOL_OF_MAX
    assert rel_to_max(ut.grad, want_gu) <= GRAD_RTOL_OF_MAX
    for name, p in layer.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape, name
        assert rel_to_max(p.grad, want_gp[name]) <= GRAD_RTOL_OF_MAX, name


@pytest.mark.parametrize("c_init", ["lecun_normal", "trunc_standard_normal", "complex_normal"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_c_init_shapes_match_jax(c_init, bidirectional):
    case = dict(discretization="zoh", conj_sym=True, bidirectional=bidirectional,
                clip_eigs=False)
    jlayer, params, layer, u = _layers(case, c_init)
    shapes = {k: tuple(v.shape) for k, v in layer.state_dict().items()}
    assert shapes == {k: tuple(np.shape(v)) for k, v in params.items()}
    with torch.no_grad():
        got = layer(torch.from_numpy(u)).numpy()
    assert rel_to_max(got, jax.jit(jlayer.apply)({"params": params}, u)) <= FWD_RTOL_OF_MAX


def test_scan_takes_the_decay_as_a_P_pair(monkeypatch):
    """The layer hands diag_linear_scan Λ̄ as its (P,) pair, which the
    kernels read at batch and time stride 0, and the backward's da comes
    back at (P,): checked through the card's routing with counting plain
    kernels standing in for the CUDA ones."""
    seen = []

    def fwd(a, b, reverse=False):
        seen.append(("fwd", tuple(a[0].shape), scan_ops._a_strides(a[0], b[0].shape), reverse))
        return scan_ops.diag_scan_plain(a, b, reverse)

    def bwd(a, h, g, reverse=False):
        da, d = scan_ops.diag_scan_bwd_plain(a, h, g, reverse)
        seen.append(("bwd", tuple(da[0].shape), reverse))
        return da, d

    monkeypatch.setattr(scan_ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(scan_ops, "diag_scan_cuda", fwd)
    monkeypatch.setattr(scan_ops, "diag_scan_bwd_cuda", bwd)
    case = dict(discretization="zoh", conj_sym=True, bidirectional=True, clip_eigs=False)
    _, _, layer, u = _layers(case)
    layer(torch.from_numpy(u)).sum().backward()
    P = N_STATE // 2
    assert sorted(seen, key=str) == sorted([("fwd", (P,), (0, 0), False),
                                            ("fwd", (P,), (0, 0), True),
                                            ("bwd", (P,), False), ("bwd", (P,), True)], key=str)
    assert layer.Lambda_re.grad.abs().sum() > 0 and layer.log_step.grad.abs().sum() > 0


# -- the small model ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    jeval, params, stats = jax_weights(cfg["model"], seed=3)
    return cfg, jeval, params, stats


def test_small_model_logits_and_gradients_match_jax(small):
    """configs/mqar-s5-small.yaml in eval mode (running BatchNorm statistics
    drawn away from their init): the logits, and the gradient of every leaf
    for the mean CE over the labelled positions."""
    cfg, jeval, params, stats = small
    mc = cfg["model"]
    model = port_model(mc, params, stats)
    x = tokens(mc, batch=2, seed=5)
    y = np.random.default_rng(6).integers(-1, mc["output_dim"], x.shape)
    want = jax_apply(jeval, params, stats, x)

    def loss(p):
        logits = jeval.apply({"params": p, "batch_stats": stats}, x)
        lp = jax.nn.log_softmax(logits)
        mask = y >= 0
        picked = jnp.take_along_axis(lp, np.maximum(y, 0)[..., None], -1)[..., 0]
        return -jnp.sum(picked * mask) / mask.sum()

    want_g = params_from_jax(to_numpy(jax.jit(jax.grad(loss))(params)))
    logits = model(torch.from_numpy(x).long())
    assert rel_to_max(logits.detach(), want) <= FWD_RTOL_OF_MAX
    yt = torch.from_numpy(y).long()
    torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), yt.reshape(-1),
                                      ignore_index=-1).backward()
    for name, p in model.named_parameters():
        assert rel_to_max(p.grad, want_g[name]) <= GRAD_RTOL_OF_MAX, name


def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    from tlie_tpu.config import load_experiment

    exp = load_experiment(FULL_YAML)

    class _Shape:
        l_max = 512
        train_inputs = range(100000)

    exp.derive_runtime_fields(_Shape())
    assert MQAR_S5_FULL == exp.raw


def test_optimizer_steps_match_create_train_state_s5():
    """Two steps of create_train_state_s5's optax groups against the port's:
    Λ and log_step on Adam at ssm_lr; B, C, D, the norms and the dense
    layers on AdamW at lr with wd; both at optax's default betas although
    the config asks for others (the train.betas here), and B decayed
    although ssm_lr_vars lists it."""
    cfg = tiny_config()
    jeval, _, stats = jax_weights(cfg["model"], seed=3)
    cfg["train"]["betas"] = [0.8, 0.95]
    tcfg, mc = cfg["train"], cfg["model"]
    assert "B" in mc["ssm_lr_vars"]
    state, _ = create_train_state_s5(
        Jitted(jeval), jax.random.PRNGKey(0), mc["input_dim"], 2, mc["seq_len"], tcfg["wd"], "batch",
        tcfg["ssm_lr"], mc["ssm_lr_vars"], tcfg["lr"], False, tuple(tcfg["betas"]),
        integer_inputs=True)
    jparams = to_numpy(state.params)
    model = port_model(mc, jparams, stats)
    f = train_fields(cfg)
    opt, clip = make_family_optimizer(model, "s5", mc, tcfg, f)
    assert clip is None
    groups = {g["name"]: g for g in opt.param_groups}
    assert all(g["betas"] == (0.9, 0.999) for g in opt.param_groups)
    names = {id(p): n for n, p in model.named_parameters()}
    ssm_names = {names[id(p)].split(".")[-1] for p in groups["ssm"]["params"]}
    assert ssm_names == {"Lambda_re", "Lambda_im", "log_step"} and set(S5_SSM_VARS) > ssm_names
    assert groups["ssm"]["weight_decay"] == 0.0 and groups["regular"]["weight_decay"] == tcfg["wd"]

    opt_state = state.tx.init(state.params)
    jp = state.params
    rng = np.random.default_rng(9)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda v: rng.standard_normal(np.shape(v)).astype(np.float32), to_numpy(jp))
        updates, opt_state = jax.jit(state.tx.update)(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, g in params_from_jax(grads).items():
            dict(model.named_parameters())[n].grad = g.clone()
        opt.step()
    want = params_from_jax(to_numpy(jp))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


# -- spectra and eval_eig ------------------------------------------------------------------------

def test_eig_s5_matches_jax(small):
    """exp(ΛΔ) of every layer within 1e-5 of tlie_tpu's, complex64 (N, layers)."""
    cfg, _, params, stats = small
    sd = params_from_jax(params, stats)
    for lp in ssm_layer_params(sd):
        want = jax_eig_s5({k: v.numpy() for k, v in lp.items()})
        got = eig_s5(lp).numpy()
        np.testing.assert_allclose(got.real, np.asarray(want[0]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.imag, np.asarray(want[1]), rtol=0, atol=1e-5)
    got = extract_ssm_family(ssm_layer_params(sd), cfg["model"])
    want = _extract_ssm_family(_ssm_layer_params(params), cfg["model"])
    assert got.dtype == want.dtype and got.shape == want.shape == (32, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eval_eig_artifacts_match_jax(small, tmp_path):
    """The same 12 artifacts, the trained spectra and their binned
    percentages equal to tlie_tpu's; the init spectra (the port's own draw
    of Δ) with tlie_tpu's Λ: |λ| = exp(Re Λ·Δ) for a Δ in [dt_min, dt_max]."""
    cfg, _, params, stats = small
    mc = cfg["model"]
    want = jax_eval_eig(cfg, {"save_path": str(tmp_path / "jax")}, None, cfg["dataset"], None,
                        "unused", 0.5, params=params)
    got = eval_eig(cfg, {"save_path": str(tmp_path / "port")}, 0.5,
                   params_from_jax(params, stats), device="cpu")
    (jrun,), (prun,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    assert jrun == prun
    assert sorted(os.listdir(tmp_path / "jax" / jrun)) == sorted(os.listdir(tmp_path / "port" / prun))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])
    eig_init = got[1]
    lam_re = jax_init_S5(mc["state_dim"], mc["hidden_dim"], **mc).keywords["Lambda_re_init"]
    step = np.log(np.abs(eig_init)) / lam_re[:, None]
    assert np.all(step >= mc["dt_min"] * (1 - 1e-4)) and np.all(step <= mc["dt_max"] * (1 + 1e-4))


# -- serving ------------------------------------------------------------------------------------

def test_teacher_forced_decode_matches_jax(small):
    """The step path against tlie_tpu's (stepwise logits 2e-5), prefill
    through the scan against the full forward, greedy tokens equal."""
    cfg, jeval, params, stats = small
    mc = cfg["model"]
    model = port_model(mc, params, stats)
    dec = Decoder(mc, model.state_dict(), device="cpu")
    jdec = JaxDecoder(mc, params, batch_stats=stats)
    x = tokens(mc, batch=2, seed=21)
    got = dec.stepwise_logits(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jdec.stepwise_logits(x)), rtol=0, atol=2e-5)
    with torch.no_grad():
        full = model(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, full, rtol=0, atol=2e-5)
    _, last = dec.prefill(x[:, :40])
    np.testing.assert_allclose(last.numpy(), full[:, 39], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(dec.generate(x[:, :40], 6).numpy(),
                                  np.asarray(jdec.generate(x[:, :40], 6)))


def test_bidirectional_s5_decoder_raises(small):
    cfg = dict(small[0]["model"], bidirectional=True)
    _, model, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="bidirectional"):
        Decoder(cfg, model, device="cpu")


# -- compat and launch -----------------------------------------------------------------------

@pytest.mark.parametrize("c_init, bidirectional", [("lecun_normal", False),
                                                   ("trunc_standard_normal", True),
                                                   ("complex_normal", True)])
def test_compat_round_trip(c_init, bidirectional):
    """params_to_jax inverts params_from_jax on S5's tree (C1/C2 when
    bidirectional), and the port's weights taken back to JAX give the
    port's logits."""
    mc = dict(tiny_config()["model"], C_init=c_init, bidirectional=bidirectional)
    jeval, params, stats = jax_weights(mc, seed=2)
    back, back_stats = params_to_jax(params_from_jax(params, stats))
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for path, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(v, flat[path])
    _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(4), device="cpu")
    p2, s2 = params_to_jax(model.state_dict())
    x = tokens(mc, batch=1, seed=8)
    with torch.no_grad():
        got = model(torch.from_numpy(x).long()).numpy()
    assert rel_to_max(got, jax_apply(jeval, p2, s2, x)) <= FWD_RTOL_OF_MAX


def _cut_config(tmp_path, yaml_path, steps=10):
    cfg = load_yaml(ROOT / yaml_path)
    cfg["save"] = "./checkpoint/" + Path(yaml_path).stem
    cfg["train"].update(total_steps=steps, eval_every=steps // 2)
    cfg["dataset"].update(num_train_examples=256, num_test_examples=64)
    path = tmp_path / "cut.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_launch_trains_checkpoints_and_analyses_on_the_cpu(tmp_path):
    """``python -m tlie_tpu_torch.launch`` on a cut of the small config:
    10 steps, the checkpoint, eval_eig's artifacts with (P, layers) spectra."""
    path = _cut_config(tmp_path, SMALL_YAML)
    proc = subprocess.run(
        [sys.executable, "-m", "tlie_tpu_torch.launch", "--config", str(path),
         "--analysis_config", str(ROOT / "configs/analysis/mqar.yaml"), "--device", "cpu"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step 10: train loss" in proc.stdout and "Finished!" in proc.stdout
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("mqar-s5-small-seed-1919-layers-2") and ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis_results")
    assert np.load(tmp_path / "analysis_results" / run / "eig.npy").shape == (32, 2)


def test_sweeps_serial_runs_and_stacked_raises(tmp_path):
    """``--sweep`` trains two seeds one after another; ``--sweep_parallel``
    (which refused S5 until the scan's Functions had ``vmap`` rules) trains
    them stacked, each point checkpointed under its seed and journaled, and
    each stacked checkpoint equals its serial one at dropout 0 within 1e-5
    (the stacked step batches the same float32 products)."""
    from tlie_tpu_torch import launch

    base = _cut_config(tmp_path, SMALL_YAML, steps=4)
    cfg = yaml.safe_load(base.read_text())
    cfg["model"]["dropout"] = 0.0
    base.write_text(yaml.safe_dump(cfg))
    found = {}
    for mode in ("--sweep", "--sweep_parallel"):
        sweep = tmp_path / mode / "sweep.yaml"
        sweep.parent.mkdir()
        sweep.write_text(yaml.safe_dump({"base_config": str(base),
                                         "sweep": {"seed": [1919, 2222]}}))
        cwd = os.getcwd()
        try:
            os.chdir(sweep.parent)
            assert launch.main(["--config", str(sweep), mode, "--device", "cpu"]) == 0
        finally:
            os.chdir(cwd)
        ckpts = sorted(c for c in os.listdir(sweep.parent / "checkpoint") if c.endswith(".pth"))
        assert [c.split("-layers")[0] for c in ckpts] == ["mqar-s5-small-seed-1919",
                                                           "mqar-s5-small-seed-2222"]
        found[mode] = [torch.load(sweep.parent / "checkpoint" / c, weights_only=True)["model"]
                       for c in ckpts]
    for serial, stacked in zip(found["--sweep"], found["--sweep_parallel"]):
        for name, want in serial.items():
            np.testing.assert_allclose(stacked[name].numpy(), want.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


# -- the card run's path 12, rehearsed ------------------------------------------------------------

def test_chip_smoke_path_12_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.ssm_family_path`` for S5 at a tiny size on the CPU, with
    the card's timers and profiler stubbed and counting plain versions in
    place of the scan kernels: the forward against the CPU, training, the
    checkpoint and its spectra, serving, the card step against float64, and
    the launch counts (the scan's forward and backward, two of each a
    training step)."""
    from torch_parity import run_ssm_path

    launches, steps = run_ssm_path(monkeypatch, MQAR_S5_FULL, "s5")
    assert launches["diag_scan_bwd"] >= 2 * steps and launches["diag_scan"] >= 2 * steps
