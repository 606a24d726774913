"""The port's S4 against tlie_tpu's on the CPU: the FFT convolution and the
Cauchy reduction, ``discrete_dplr``, the generating-function kernel
``s4_kernel_dplr``, the layer in CNN and RNN modes (forward and gradients)
and the two modes against each other, the small MQAR model
(``configs/mqar-s4-small.yaml``: logits and gradients), ``create_train_state``'s
generic optimiser groups over two steps, the eigensolver and the binned
spectra, eval_eig's artifacts, teacher-forced decoding, ``compat`` (complex
P and B included), ``launch`` end to end, and the card run's path 13
rehearsed.

Weights are drawn by JAX, carried with ``compat``; inputs are made with
numpy from a seed; JAX runs jitted at HIGHEST matmul precision.

**The Nyquist frequency.**  At ω = −1 the bilinear map gives |g| ≈ 1.6e16·2/Δ,
and tlie_tpu's pair reciprocal c/(c² + d²) overflows float32 for Δ below
about 0.00177, so tlie_tpu's kernel loses that frequency there; the port's
complex division keeps it, as numpy's and JAX's own complex arithmetic do
(:func:`test_nyquist_bin_is_kept_where_tlie_tpu_loses_it` pins both).  The
tests that hold the port to tlie_tpu's values therefore carry weights with
every Δ at or above 0.002; the small config's init draws Δ from [0.001,
0.1], so its carried log_step is raised to log 0.002 where it lies below."""

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

from tlie_tpu.analysis.binning import RADIUS_THRESHOLDS as JAX_RADIUS_T
from tlie_tpu.analysis.binning import PHASE_THRESHOLDS as JAX_PHASE_T
from tlie_tpu.analysis.binning import threshold_analysis_ssm as jax_threshold
from tlie_tpu.analysis.eval_eig import _extract_ssm_family, _ssm_layer_params
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_s4 as jax_eig_s4
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models import s4 as js4
from tlie_tpu.models.initializers import make_dplr_hippo
from tlie_tpu.ops import fft_conv as jfft
from tlie_tpu.ops.eig import eigvals_pair
from tlie_tpu.training.state import create_train_state
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
from tlie_tpu_torch.analysis.extractors import eig_s4
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import MQAR_S4_FULL, load_yaml, train_fields
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import s4 as ts4
from tlie_tpu_torch.ops import fft_conv as tfft
from tlie_tpu_torch.ops.eig import eigvals
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import Jitted, jax_apply, jax_weights, port_model, to_numpy, tokens

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")
ROOT = Path(__file__).resolve().parents[1]
SMALL_YAML = "configs/mqar-s4-small.yaml"
FULL_YAML = "configs/tasks/mqar/mqar-s4.yaml"
# float32 on both sides: the port's complex64 products and torch.fft against
# tlie_tpu's pair products and matmul DFT, the same sums in other orders
FWD_RTOL_OF_MAX = 2e-5
GRAD_RTOL_OF_MAX = 2e-5
# the smallest Δ at which tlie_tpu keeps the Nyquist frequency (above)
DT_KEPT = 0.002


def small_config():
    cfg = load_yaml(ROOT / SMALL_YAML)
    cfg["model"]["seq_len"] = cfg["dataset"]["input_seq_length"]
    return cfg


def rel_to_max(got, want):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def raise_steps(params):
    """Every layer's log_step raised to log DT_KEPT where it lies below."""
    for name, layer in params["encoder"].items():
        if name.startswith("layers_"):
            ls = layer["seq"]["log_step"]
            layer["seq"]["log_step"] = np.maximum(ls, np.log(DT_KEPT)).astype(np.float32)
    return params


def cx(pair):
    return torch.complex(torch.as_tensor(np.asarray(pair[0])), torch.as_tensor(np.asarray(pair[1])))


def jpair(z):
    z = np.asarray(z, np.complex64)
    return jnp.asarray(z.real), jnp.asarray(z.imag)


# -- the FFT convolution and the Cauchy reduction ---------------------------------------------

@pytest.mark.parametrize("L", [7, 64, 100])
def test_causal_fft_conv_matches_direct_and_jax(L):
    rng = np.random.default_rng(L)
    u = rng.standard_normal((3, 5, L)).astype(np.float32)
    K = rng.standard_normal((5, L)).astype(np.float32)
    direct = np.stack([np.stack([np.convolve(u[b, h].astype(np.float64), K[h])[:L]
                                 for h in range(5)]) for b in range(3)])
    got = tfft.causal_fft_conv(torch.from_numpy(u), torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=2e-5 * np.abs(direct).max())
    want = np.asarray(jfft.causal_fft_conv(jnp.asarray(u), jnp.asarray(K)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(direct).max())


def test_cauchy_dot_matches_jax():
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(16) + 1j * rng.standard_normal(16)).astype(np.complex64)
    lam = (-0.5 + 1j * rng.standard_normal(16) * 5).astype(np.complex64)
    omega = np.exp(-2j * np.pi * np.arange(32) / 32).astype(np.complex64)
    got = tfft.cauchy_dot(*(torch.from_numpy(x) for x in (v, omega, lam))).numpy()
    want = np.asarray(jfft.cauchy_dot(jnp.asarray(v), jnp.asarray(omega), jnp.asarray(lam)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- the discretisation and the kernel ------------------------------------------------------------

def _dplr_channel(N, seed):
    lam, p, b, _, _ = make_dplr_hippo(N)
    lam = np.minimum(lam.real, -1e-4) + 1j * lam.imag
    rng = np.random.default_rng(seed)
    c = ((rng.standard_normal(N) + 1j * rng.standard_normal(N)) * 0.5**0.5)
    return [x.astype(np.complex64) for x in (lam, p, b, c)]


@pytest.mark.parametrize("N, L, step", [(8, 16, 0.05), (16, 64, 0.01), (32, 64, 0.002)])
def test_discrete_dplr_matches_jax(N, L, step):
    """Ā, B̄ within 1e-5 of their largest magnitude; C̄, which goes through
    Ā^L and an inverse of I − Ā^L (complex64 here, tlie_tpu's real 2N×2N
    embedding there), within 1e-4."""
    lam, p, b, c = _dplr_channel(N, N)
    want = js4.discrete_dplr(jpair(lam), jpair(p), jpair(p), jpair(b), jpair(c),
                             jnp.float32(step), L)
    got = ts4.discrete_dplr(*(torch.from_numpy(x) for x in (lam, p, p, b, c)),
                            torch.tensor(step, dtype=torch.float32), L)
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        w = np.asarray(w[0]) + 1j * np.asarray(w[1])
        assert g.shape == w.shape
        assert rel_to_max(g.numpy(), w) <= tol


def _layer_params(N, H, L, steps, seed=0):
    """An S4 layer's parameters as tlie_tpu's init gives them, with the
    log steps given."""
    layer = js4.init_S4(N, H, C_init="complex_normal", seq_len=L)()
    u = np.zeros((1, L, H), np.float32)
    params = to_numpy(jax.jit(layer.init)(jax.random.PRNGKey(seed), u)["params"])
    params["log_step"] = np.log(np.asarray(steps, np.float32))[None, :]
    return layer, params


def _kernels(params, L):
    lam = (jnp.clip(params["Lambda_re"], max=-1e-4), jnp.asarray(params["Lambda_im"]))
    pr = lambda w: (jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1]))  # noqa: E731
    step = np.exp(params["log_step"][0])
    want = np.asarray(js4.s4_kernel_dplr(lam, pr(params["P"]), pr(params["B"]),
                                         pr(params["C"]), jnp.asarray(step), L))
    got = ts4.s4_kernel_dplr(cx(lam), cx(pr(params["P"])), cx(pr(params["B"])),
                             cx(pr(params["C"])), torch.from_numpy(step), L).numpy()
    return got, want


@pytest.mark.parametrize("L", [16, 64, 512])
def test_s4_kernel_matches_jax(L):
    """The (H, L) kernels at Δ from DT_KEPT to 0.1, within 2e-5 of each
    channel's largest tap."""
    steps = np.geomspace(DT_KEPT, 0.1, 6)
    _, params = _layer_params(16, 6, L, steps)
    got, want = _kernels(params, L)
    for h in range(6):
        assert rel_to_max(got[h], want[h]) <= FWD_RTOL_OF_MAX, h


def test_nyquist_bin_is_kept_where_tlie_tpu_loses_it():
    """At Δ = 0.001 the port's kernel is the float64 materialisation
    K_l = C̄ Ā^l B̄ (the tolerance of tlie_tpu's own materialisation test),
    while tlie_tpu's differs from it by the Nyquist frequency alone: its
    spectrum is 0 there and the port's elsewhere."""
    L, N = 64, 16
    _, params = _layer_params(N, 2, L, [0.001, 0.05])
    got, want = _kernels(params, L)
    f_got, f_want = np.fft.fft(got, axis=-1), np.fft.fft(want, axis=-1)
    others = np.arange(L) != L // 2
    np.testing.assert_allclose(f_want[:, others], f_got[:, others], rtol=0,
                               atol=2e-5 * np.abs(f_got).max())
    assert abs(f_want[0, L // 2]) < 1e-9 < 1e-2 * abs(f_got[0, L // 2])  # Δ = 0.001: lost
    assert abs(f_want[1, L // 2] - f_got[1, L // 2]) < 2e-5 * np.abs(f_got).max()  # kept
    for h in range(2):  # the float64 materialisation
        lam = np.minimum(params["Lambda_re"][:, h], -1e-4) + 1j * params["Lambda_im"][:, h]
        p = params["P"][:, h, 0] + 1j * params["P"][:, h, 1]
        b = params["B"][:, h, 0] + 1j * params["B"][:, h, 1]
        c = params["C"][:, h, 0] + 1j * params["C"][:, h, 1]
        ab, bb, cb = (x.numpy() for x in ts4.discrete_dplr(
            *(torch.from_numpy(np.asarray(x, np.complex128)) for x in (lam, p, p, b, c)),
            torch.tensor(np.exp(float(params["log_step"][0, h])), dtype=torch.float64), L))
        ref = np.array([(cb @ np.linalg.matrix_power(ab, l) @ bb)[0, 0].real for l in range(L)])
        np.testing.assert_allclose(got[h], ref, rtol=1e-3, atol=1e-3)


# -- the layer -------------------------------------------------------------------------------

def _layers(decode, L=32, N=8, H=4):
    steps = np.geomspace(DT_KEPT, 0.1, H)
    jlayer = js4.init_S4(N, H, C_init="complex_normal", seq_len=L, decode=decode)()
    _, params = _layer_params(N, H, L, steps)
    layer = ts4.init_S4(N, H, torch.Generator(), C_init="complex_normal", seq_len=L,
                        decode=decode)()
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    u = np.random.default_rng(2).standard_normal((2, L, H)).astype(np.float32)
    return jlayer, params, layer, u


def _port_grads(layer, u, w, dtype):
    """(y, {leaf: gradient}, du) of Σ y·w through a copy of ``layer`` in ``dtype``."""
    import copy

    layer = copy.deepcopy(layer).to(dtype)
    ut = torch.from_numpy(u).to(dtype).requires_grad_()
    y = layer(ut)
    (y * torch.from_numpy(w).to(dtype)).sum().backward()
    return y.detach(), {n: p.grad for n, p in layer.named_parameters()}, ut.grad


@pytest.mark.parametrize("decode", [False, True], ids=["cnn", "rnn"])
def test_layer_forward_and_gradients_match_jax(decode):
    """y and the gradient of every leaf and of u for Σ y·w within 2e-5 of
    each one's largest magnitude; log_step's against the port's own float64
    gradient (1e-5), since tlie_tpu's loses its Nyquist term
    (test_log_step_gradient_keeps_the_nyquist_term).  RNN mode goes through
    Ā^L and (I − Ā^L)⁻¹ in float32: here the port's gradients lie within
    1.1e-4 of float64 and tlie_tpu's within 3.3e-5, so the two are held to
    3e-4 of each other, y to 1e-4."""
    jlayer, params, layer, u = _layers(decode)
    grad_tol = 3e-4 if decode else GRAD_RTOL_OF_MAX
    w = np.random.default_rng(3).standard_normal(u.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jlayer.apply({"params": p}, x) * w)

    want_y = np.asarray(jax.jit(jlayer.apply)({"params": params}, u))
    want_gp, want_gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, u)
    y, grads, du = _port_grads(layer, u, w, torch.float32)
    assert rel_to_max(y, want_y) <= (1e-4 if decode else FWD_RTOL_OF_MAX)
    assert rel_to_max(du, want_gu) <= grad_tol
    for name, g in grads.items():
        if name != "log_step" or decode:
            assert rel_to_max(g, want_gp[name]) <= grad_tol, name
    if not decode:
        _, g64, _ = _port_grads(layer, u, w, torch.float64)
        assert rel_to_max(grads["log_step"], g64["log_step"]) <= 1e-5


def test_log_step_gradient_keeps_the_nyquist_term():
    """The CNN mode's log_step gradient against central differences of the
    float64 forward (whose float32 version is tlie_tpu's forward within
    2e-5): the port's float32 autograd within 1e-5 of their largest
    magnitude.  tlie_tpu's pair reciprocal squares |g − Λ| ≈ 1e19 in its
    derivative at the Nyquist root, which overflows float32 at every Δ,
    so its gradient loses that frequency's term: more than 1e-2 off here."""
    jlayer, params, layer, u = _layers(False)
    w = np.random.default_rng(3).standard_normal(u.shape).astype(np.float32)
    _, grads, _ = _port_grads(layer, u, w, torch.float32)
    want_gp = jax.jit(jax.grad(lambda p: jnp.sum(jlayer.apply({"params": p}, u) * w)))(params)
    import copy

    l64 = copy.deepcopy(layer).double()
    u64, w64 = torch.from_numpy(u).double(), torch.from_numpy(w).double()
    fd = np.zeros(l64.log_step.shape[1])
    eps = 1e-6
    with torch.no_grad():
        for h in range(len(fd)):
            vals = []
            for sign in (1, -1):
                l64.log_step[0, h] += sign * eps
                vals.append(float((l64(u64) * w64).sum()))
                l64.log_step[0, h] -= sign * eps
            fd[h] = (vals[0] - vals[1]) / (2 * eps)
    assert rel_to_max(grads["log_step"][0], fd) <= 1e-5
    assert rel_to_max(np.asarray(want_gp["log_step"])[0], fd) > 1e-2


def test_cnn_and_rnn_modes_agree():
    """The port's two modes within tlie_tpu's own bound for them
    (tests/test_models_ssm.py::test_s4_cnn_matches_rnn_mode: rtol 1e-3,
    atol 3e-3), at Δ from 0.001, and on a prefix shorter than l_max."""
    _, params, cnn, u = _layers(False)
    _, _, rnn, _ = _layers(True)
    for layer in (cnn, rnn):
        with torch.no_grad():
            layer.log_step.copy_(torch.log(torch.linspace(0.001, 0.1, 4)))
    x = torch.from_numpy(u)
    with torch.no_grad():
        np.testing.assert_allclose(cnn(x).numpy(), rnn(x).numpy(), rtol=1e-3, atol=3e-3)
        np.testing.assert_allclose(cnn(x[:, :20]).numpy(), rnn(x).numpy()[:, :20], rtol=1e-3,
                                   atol=3e-3)
    with pytest.raises(ValueError, match="l_max"):
        cnn(torch.zeros(1, 33, 4))


# -- the small model --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    jeval, params, stats = jax_weights(cfg["model"], seed=3)
    return cfg, jeval, raise_steps(params), stats


def test_small_model_logits_and_gradients_match_jax(small):
    """configs/mqar-s4-small.yaml in eval mode (running statistics drawn
    away from their init): the logits and the gradient of every leaf for the
    mean CE over the labelled positions."""
    cfg, jeval, params, stats = small
    mc = cfg["model"]
    model = port_model(mc, params, stats)
    x = tokens(mc, batch=2, seed=5)
    y = np.random.default_rng(6).integers(-1, mc["output_dim"], x.shape)
    want = jax_apply(jeval, params, stats, x)

    def loss(p):
        lp = jax.nn.log_softmax(jeval.apply({"params": p, "batch_stats": stats}, x))
        mask = y >= 0
        picked = jnp.take_along_axis(lp, np.maximum(y, 0)[..., None], -1)[..., 0]
        return -jnp.sum(picked * mask) / mask.sum()

    want_g = params_from_jax(to_numpy(jax.jit(jax.grad(loss))(params)))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = model.to(dtype)
        m.zero_grad()
        logits = m(torch.from_numpy(x).long())
        if dtype == torch.float32:
            assert rel_to_max(logits.detach(), want) <= FWD_RTOL_OF_MAX
        torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                          torch.from_numpy(y).long().reshape(-1),
                                          ignore_index=-1).backward()
        grads[dtype] = {n: p.grad.clone() for n, p in m.named_parameters()}
    # log_step's against the port's float64 gradient: tlie_tpu's loses its
    # Nyquist term (test_log_step_gradient_keeps_the_nyquist_term)
    for name, g in grads[torch.float32].items():
        want_leaf = grads[torch.float64][name] if name.endswith("log_step") else want_g[name]
        assert rel_to_max(g, want_leaf) <= GRAD_RTOL_OF_MAX, name


def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    from tlie_tpu.config import load_experiment

    exp = load_experiment(FULL_YAML)

    class _Shape:
        l_max = 512
        train_inputs = range(100000)

    exp.derive_runtime_fields(_Shape())
    assert MQAR_S4_FULL == exp.raw


def test_optimizer_steps_match_create_train_state(small):
    """Two steps of create_train_state's groups against the port's: the
    config's ssm_lr_vars (Λ, P, B, log_step) on Adam at ssm_lr, the rest on
    AdamW at lr with wd, both at the config's train.betas."""
    cfg = small_config()
    cfg["model"].update(hidden_dim=16, state_dim=8, input_dim=64, output_dim=64, seq_len=16)
    cfg["train"]["betas"] = [0.8, 0.95]
    tcfg, mc = cfg["train"], cfg["model"]
    jeval, _, stats = jax_weights(mc, seed=3)
    state, _ = create_train_state(
        Jitted(jeval), jax.random.PRNGKey(0), mc["input_dim"], 2, mc["seq_len"], tcfg["wd"],
        "batch", tcfg["ssm_lr"], mc["ssm_lr_vars"], tcfg["lr"], False, tuple(tcfg["betas"]),
        integer_inputs=True)
    jp = state.params
    model = port_model(mc, to_numpy(jp), stats)
    opt, clip = make_family_optimizer(model, "s4", mc, tcfg, train_fields(cfg))
    assert clip is None and all(g["betas"] == (0.8, 0.95) for g in opt.param_groups)
    names = {id(p): n.split(".")[-1] for n, p in model.named_parameters()}
    groups = {g["name"]: {names[id(p)] for p in g["params"]} for g in opt.param_groups}
    assert groups["ssm"] == {"Lambda_re", "Lambda_im", "P", "B", "log_step"}
    opt_state = state.tx.init(jp)
    rng = np.random.default_rng(9)
    params = dict(model.named_parameters())
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda v: rng.standard_normal(np.shape(v)).astype(np.float32), to_numpy(jp))
        updates, opt_state = jax.jit(state.tx.update)(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, g in params_from_jax(grads).items():
            params[n].grad = g.clone()
        opt.step()
    want = params_from_jax(to_numpy(jp))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


# -- the eigensolver and the spectra --------------------------------------------------------------

def _abar(N=32, step=0.05):
    lam, p, _, _ = _dplr_channel(N, 0)
    ab, _, _ = ts4.discrete_dplr(*(torch.from_numpy(x) for x in (lam, p, p, p, p)),
                                 torch.tensor(step), 16)
    return ab


def test_host_eigvals_are_tlie_tpus_bits():
    ab = _abar()
    got = eigvals(ab).numpy()
    want = eigvals_pair((jnp.asarray(ab.real.numpy()), jnp.asarray(ab.imag.numpy())))
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got.real, np.asarray(want[0]))
    np.testing.assert_array_equal(got.imag, np.asarray(want[1]))


def test_device_eigvals_bin_as_the_host_ones():
    """torch.linalg.eigvals against LAPACK: Ā's eigenvectors have condition
    about 1e15, so single eigenvalues may move beyond rounding; the binned
    radii may differ by at most one eigenvalue of 32 changing bins, as
    tlie_tpu's own device solver is held (tests/test_eig_device.py)."""
    ab = _abar()
    r_dev = np.abs(eigvals(ab, impl="device").numpy())[:, None]
    r_host = np.abs(eigvals(ab).numpy())[:, None]
    np.testing.assert_allclose(jax_threshold(r_dev, JAX_RADIUS_T),
                               jax_threshold(r_host, JAX_RADIUS_T), atol=3.2)
    with pytest.raises(ValueError, match="impl"):
        eigvals(ab, impl="qr")


def test_eig_s4_binned_statistics_match_jax(small):
    """Channel 1's Ā eigenvalues from the carried weights, binned by radius
    and phase: equal to tlie_tpu's percentages, every layer; and complex P
    and B arrays (a reference checkpoint's) give the same spectrum."""
    cfg, _, params, stats = small
    mc = cfg["model"]
    sd = params_from_jax(params, stats)
    got = extract_ssm_family(ssm_layer_params(sd), mc)
    want = _extract_ssm_family(_ssm_layer_params(params), mc)
    assert got.dtype == np.complex64 and got.shape == want.shape == (mc["state_dim"], 2)
    for thr, fn in ((JAX_RADIUS_T, np.abs), (JAX_PHASE_T, lambda z: np.angle(z, deg=True))):
        np.testing.assert_array_equal(jax_threshold(fn(got), thr), jax_threshold(fn(want), thr))
    lp = {k: v.numpy() for k, v in ssm_layer_params(sd)[0].items()}
    complex_lp = dict(lp, P=lp["P"][..., 0] + 1j * lp["P"][..., 1],
                      B=lp["B"][..., 0] + 1j * lp["B"][..., 1])
    np.testing.assert_array_equal(eig_s4(complex_lp, 1, mc["seq_len"]).numpy(),
                                  eig_s4(lp, 1, mc["seq_len"]).numpy())
    w = jax_eig_s4(complex_lp, 1, mc["seq_len"])
    assert np.asarray(w[0]).shape == (mc["state_dim"],)


def test_eval_eig_artifacts_match_jax(small, tmp_path):
    """The same 12 artifacts and the trained spectra's binned percentages
    equal to tlie_tpu's; the init spectra inside the unit disc."""
    cfg, _, params, stats = small
    want = jax_eval_eig(cfg, {"save_path": str(tmp_path / "jax")}, None, cfg["dataset"], None,
                        "unused", 0.5, params=params)
    got = eval_eig(cfg, {"save_path": str(tmp_path / "port")}, 0.5,
                   params_from_jax(params, stats), device="cpu")
    (jrun,), (prun,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    assert jrun == prun
    assert sorted(os.listdir(tmp_path / "jax" / jrun)) == sorted(os.listdir(tmp_path / "port" / prun))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])
    assert got[1].shape == want[1].shape and np.all(np.abs(got[1]) < 1)


# -- serving ------------------------------------------------------------------------------------

def test_teacher_forced_decode_matches_jax(small):
    """The dense DPLR step path against tlie_tpu's (1e-4: C̄ through Ā^L
    and an inverse in other arithmetic) and against the port's CNN forward
    (tlie_tpu's 5e-3 of tests/test_decode.py::test_decode_s4_cnn_vs_step);
    prefill runs stepwise; greedy tokens equal to tlie_tpu's."""
    cfg, jeval, params, stats = small
    mc = cfg["model"]
    model = port_model(mc, params, stats)
    dec = Decoder(mc, model, device="cpu")
    jdec = JaxDecoder(mc, params, batch_stats=stats)
    x = tokens(mc, batch=2, seed=21)
    got = dec.stepwise_logits(x).numpy()
    want = np.asarray(jdec.stepwise_logits(x))
    assert rel_to_max(got, want) <= 1e-4
    with torch.no_grad():
        full = model(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, full, rtol=5e-3, atol=5e-3)
    cache, last = dec.prefill(x[:, :40])
    np.testing.assert_allclose(last.numpy(), got[:, 39], rtol=0, atol=1e-6)
    assert cache[0].shape == (2, mc["hidden_dim"], mc["state_dim"]) and cache[0].is_complex()
    np.testing.assert_array_equal(dec.generate(x[:, :40], 6).numpy(),
                                  np.asarray(jdec.generate(x[:, :40], 6)))


# -- compat and launch ------------------------------------------------------------------------

def test_compat_round_trip_and_complex_p_b(small):
    """params_to_jax inverts params_from_jax on S4's tree, and a tree with
    complex P and B (as the reference's checkpoints store them) loads as
    their trailing (re, im) layout."""
    cfg, jeval, params, stats = small
    sd = params_from_jax(params, stats)
    back, back_stats = params_to_jax(sd)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    for path, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(v, flat[path])
    cparams = jax.tree_util.tree_map(lambda v: v, params)
    for name, layer in cparams["encoder"].items():
        if name.startswith("layers_"):
            for k in ("P", "B"):
                w = layer["seq"][k]
                layer["seq"][k] = w[..., 0] + 1j * w[..., 1]
    csd = params_from_jax(cparams, stats)
    assert all(torch.equal(csd[k], sd[k]) for k in sd)


def test_launch_trains_checkpoints_and_analyses_on_the_cpu(tmp_path):
    cfg = load_yaml(ROOT / SMALL_YAML)
    cfg["save"] = "./checkpoint/mqar-s4-small"
    cfg["train"].update(total_steps=10, eval_every=5)
    cfg["dataset"].update(num_train_examples=256, num_test_examples=64)
    (tmp_path / "cut.yaml").write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "tlie_tpu_torch.launch", "--config", str(tmp_path / "cut.yaml"),
         "--analysis_config", str(ROOT / "configs/analysis/mqar.yaml"), "--device", "cpu"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step 10: train loss" in proc.stdout and "Finished!" in proc.stdout
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("mqar-s4-small-seed-1919-layers-2") and ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis_results")
    assert np.load(tmp_path / "analysis_results" / run / "eig.npy").shape == (64, 2)


# -- the card run's path 13, rehearsed ----------------------------------------------------------

def test_chip_smoke_path_13_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.ssm_family_path`` for S4 at a tiny size on the CPU, the
    card stubbed: every check of the path, and no port kernel launched."""
    from torch_parity import run_ssm_path

    launches, _ = run_ssm_path(monkeypatch, MQAR_S4_FULL, "s4")
    assert not any(launches.values())
