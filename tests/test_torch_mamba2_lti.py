"""The port's Mamba-2 classifier (the dense input encoder and the pooled
heads) and its pseudo-LTI variant ``SSD_LTI`` against tlie_tpu's on the CPU:
the ``SSD_LTI`` core with ``dt_limit`` and ``learnable_init_states``, the
model's logits and every gradient for each pooling, the weights both ways
through ``compat`` and through tlie_tpu's ``torch_state_dict_to_flax``,
``eig_mamba2_lti``, eval_eig's artifacts of both CIFAR Mamba configs on a
float batch, and one AdamW step against ``make_train_block``.

The model is the CIFAR config at 2 layers, d_model 32, 2 heads of 16, N 16,
L 64 and chunks of 16 (the SSD runs four chunks: its inter-chunk arm), one
input feature.  Inputs are made with numpy from a seed; JAX runs jitted at
HIGHEST matmul precision (tests/conftest.py).  Tolerances are stated where
they are used.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.analysis.compat import torch_state_dict_to_flax
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_mamba2_lti as jax_eig_mamba2_lti
from tlie_tpu.models import mamba2 as jax_mamba2
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state_adamw
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.analysis.extractors import eig_mamba2_lti
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import CIFAR_MAMBA2_FULL, CIFAR_MAMBA2_LTI_FULL
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models.mamba2 import SSD, SSD_LTI
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, schedules, train_step
from tlie_tpu_torch.training.scan_loop import batch_indices, put_dataset
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import ARTIFACT_FILES, to_numpy

torch.set_num_threads(1)

D, HEADS, N, L, CHUNK, B = 32, 2, 16, 64, 16, 3
# float32 on both sides, the same products summed in other orders: outputs
# and logits within 2e-5 of their max, each gradient within 1e-4 of its
# leaf's max (the tolerances of tests/test_torch_mamba2.py); spectra 1e-5
OUT_RTOL_OF_MAX, GRAD_RTOL_OF_MAX, EIG_RTOL = 2e-5, 1e-4, 1e-5


def small(full=CIFAR_MAMBA2_FULL, **over):
    """The CIFAR Mamba config's model at the small widths, chunks of 16."""
    return dict(full["model"], num_layers=2, hidden_dim=D, num_heads=HEADS, state_dim=N,
                seq_len=L, chunk_size=CHUNK, **over)


def features(n=B, seed=0):
    return np.random.default_rng(seed).standard_normal((n, L, 1)).astype(np.float32)


def _jax_init(module, *inputs, seed=0):
    return to_numpy(jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)["params"])


def _sub(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


# -- the SSD_LTI core ----------------------------------------------------------------------

_LTI_CASES = {
    "plain": dict(),
    "dt_limit": dict(dt_limit=(0.0, 0.5)),
    "init_states": dict(learnable_init_states=True),
    "init_states_dt_limit": dict(learnable_init_states=True, dt_limit=(0.0, 0.5)),
    "two_groups": dict(ngroups=2),
}


@pytest.mark.parametrize("case", sorted(_LTI_CASES))
def test_ssd_lti_core_and_its_gradients_match_flax(case):
    """``SSD_LTI`` (d_model 32, 2 heads of 16, N 16, four chunks of 16) on
    flax's weights: the output within 2e-5 of its max, and the gradients of
    a weighted sum for every parameter and the input within 1e-4 of each
    one's max.  ``dt_limit`` (0, 0.5) clamps β ≡ 1 to 0.5, halving every
    step; learnable_init_states is drawn away from its zero init."""
    kw = dict(d_state=N, headdim=D // HEADS, chunk_size=CHUNK, **_LTI_CASES[case])
    rng = np.random.default_rng(1)
    u = rng.standard_normal((B, L, D)).astype(np.float32)
    w = rng.standard_normal((B, L, D)).astype(np.float32)
    jm = jax_mamba2.SSD_LTI(d_model=D, **kw)
    p = _jax_init(jm, u)
    if "init_states" in p:
        p["init_states"] = rng.standard_normal(p["init_states"].shape).astype(np.float32)

    def jloss(p, u):
        y = jm.apply({"params": p}, u)
        return jnp.sum(y * w), y

    (_, want), (jgp, jgu) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(p, u)
    port = SSD_LTI(D, torch.Generator(), **kw)
    port.load_state_dict(_sub(params_from_jax({"blocks_0": {"mamba": p}}), "blocks.0.mamba."))
    tu = torch.from_numpy(u).requires_grad_()
    y = port(tu)
    (y * torch.from_numpy(w)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=OUT_RTOL_OF_MAX * np.abs(want).max())
    got = params_to_jax({f"blocks.0.mamba.{n}": q.grad for n, q in port.named_parameters()})[0]
    got = got["blocks_0"]["mamba"]
    leaves = jax.tree_util.tree_leaves_with_path(to_numpy(jgp))
    assert len(jax.tree_util.tree_leaves(got)) == len(leaves)
    for (path, g), (_, ref) in zip(jax.tree_util.tree_leaves_with_path(got), leaves):
        np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(ref).max(),
                                   err_msg=str(path))
    jgu = np.asarray(jgu)
    np.testing.assert_allclose(tu.grad.numpy(), jgu, rtol=0,
                               atol=GRAD_RTOL_OF_MAX * np.abs(jgu).max())


def test_ssd_lti_layout_and_init():
    """in_proj is d_inner + 2·ngroups·N + ngroups wide (not + nheads); A ~
    U(−8, −2) per head, D ones, softplus(dt_bias) in [0.001, 0.1]; the
    names are the reference's (``A``, not ``A_log``); nheads must divide
    N·ngroups."""
    port = SSD_LTI(64, torch.Generator().manual_seed(3), d_state=16, headdim=4)  # 16 heads
    assert port.in_proj.weight.shape == (64 + 2 * 16 + 1, 64) and port.khead_dim == 1
    A = port.A.detach()
    assert A.shape == (16,) and -8.0 <= A.min() and A.max() <= -2.0 and A.std() > 1.0
    assert torch.equal(port.D.detach(), torch.ones(16))
    dt = torch.nn.functional.softplus(port.dt_bias.detach())
    assert 1e-3 - 1e-7 <= dt.min() and dt.max() <= 0.1 + 1e-7
    assert {n for n, _ in port.named_parameters()} == {
        "in_proj.weight", "dt_bias", "A", "D", "conv1d.weight", "conv1d.bias", "out_proj.weight"}
    jp = _jax_init(jax_mamba2.SSD_LTI(d_model=64, d_state=16, headdim=4),
                   np.zeros((1, 8, 64), np.float32))
    assert jp["in_proj"]["kernel"].shape == (64, 64 + 2 * 16 + 1)
    assert -8.0 <= jp["A"].min() and jp["A"].max() <= -2.0
    with pytest.raises(ValueError, match="divide"):
        SSD_LTI(64, torch.Generator(), d_state=6, headdim=16)  # 4 heads, N 6


# -- the pooled model with the dense encoder --------------------------------------------------

def _jax_model(model_cfg, seed=0):
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=False)
    return jeval, _jax_init(jeval, features(1), seed=seed)


def _port(model_cfg, params):
    model, eval_model, family = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    assert family == "mamba"
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


@pytest.mark.parametrize("pooling,lti", [("mean", False), ("mean", True), ("max", False),
                                         ("last", True)],
                         ids=["mean-ssd", "mean-lti", "max-ssd", "last-lti"])
def test_pooled_logits_and_every_gradient_match_jax(pooling, lti):
    """The dense encoder (one feature → 32), two blocks and the pooled
    decoder on 3 float sequences, each pooling and both cores: logits
    within 2e-5 of their max, the CE
    loss within 1e-5 relative, and every leaf's gradient (the encoder's, A
    or A_log and dt_bias among them) within 1e-4 of its max."""
    model_cfg = small(pooling=pooling, pseudoLTI=lti)
    jeval, params = _jax_model(model_cfg)
    x = features()
    y = np.array([3, 0, 7])

    def jloss(params):
        logits = jeval.apply({"params": params}, x)
        return jax_scan_loop.cross_entropy_loss(logits, y), logits

    (jl, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model, _ = _port(model_cfg, params)
    assert isinstance(model.blocks[0].mamba, SSD_LTI if lti else SSD)
    logits = model(torch.from_numpy(x))
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    want = np.asarray(want)
    assert logits.shape == want.shape == (B, 10)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=OUT_RTOL_OF_MAX * np.abs(want).max())
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert set(got["encoder"]) == {"kernel", "bias"}
    assert ("A" if lti else "A_log") in got["blocks_1"]["mamba"]
    leaves = jax.tree_util.tree_leaves_with_path(to_numpy(jgrads))
    assert len(jax.tree_util.tree_leaves(got)) == len(leaves)
    for (path, g), (_, ref) in zip(jax.tree_util.tree_leaves_with_path(got), leaves):
        np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(ref).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("lti", [False, True], ids=["ssd", "lti"])
def test_compat_carries_the_encoder_and_A_both_ways(lti):
    """``encoder.weight`` (transposed) and ``encoder.bias`` ↔
    ``params/encoder/{kernel,bias}``, ``blocks.{i}.mamba.A`` ↔
    ``blocks_i/mamba/A``: params_from_jax then params_to_jax gives flax's
    tree back bit for bit, and tlie_tpu's own ``torch_state_dict_to_flax``
    maps the port's state_dict onto the same tree; the SSM backbone's
    ``encoder.encoder`` keeps its own rule."""
    model_cfg = small(pseudoLTI=lti)
    _, params = _jax_model(model_cfg)
    model, _ = _port(model_cfg, params)
    sd = model.state_dict()
    assert sd["encoder.weight"].shape == (D, 1) and sd["encoder.bias"].shape == (D,)
    assert flax_path("encoder.weight") == ("params", "encoder", "kernel")
    assert flax_path("encoder.encoder.weight") == ("params", "encoder", "encoder", "kernel")
    assert flax_path("blocks.1.mamba.A") == ("params", "blocks_1", "mamba", "A")
    mine, stats = params_to_jax(sd)
    theirs = torch_state_dict_to_flax(sd, "mamba")
    assert stats is None
    for a, b, c in zip(jax.tree_util.tree_leaves_with_path(mine),
                       jax.tree_util.tree_leaves_with_path(theirs),
                       jax.tree_util.tree_leaves_with_path(params)):
        assert a[0] == b[0] == c[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[1])


def test_features_stay_unpooled_for_the_fused_head():
    """``features`` is the backbone before pooling, (B, L, d), and the pooled
    logits are the decoder of its mean."""
    model_cfg = small()
    model, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")[:2]
    x = torch.from_numpy(features())
    with torch.no_grad():
        f = model.features(x)
        assert f.shape == (B, L, D)
        torch.testing.assert_close(model(x), model.decoder(f.mean(1)), rtol=0, atol=0)


# -- the spectra ----------------------------------------------------------------------------

def test_eig_mamba2_lti_matches_jax():
    """λ = exp(−softplus(A)) broadcast to (B, L, nheads), 1e-5 relative,
    constant over the batch and time."""
    A = np.random.default_rng(4).uniform(-8, 3, 5).astype(np.float32)
    x = features()
    want = np.asarray(jax.jit(jax_eig_mamba2_lti, static_argnames=("nheads",))(x, A))
    got = eig_mamba2_lti(torch.from_numpy(x), torch.from_numpy(A)).numpy()
    assert got.shape == want.shape == (B, L, 5)
    np.testing.assert_allclose(got, want, rtol=EIG_RTOL, atol=0)
    assert (got == got[:1, :1]).all() and np.all((got > 0) & (got < 1))


@pytest.mark.parametrize("full", [CIFAR_MAMBA2_FULL, CIFAR_MAMBA2_LTI_FULL], ids=["ssd", "lti"])
def test_eval_eig_artifacts_match_tlie_tpu_on_a_float_batch(full, tmp_path):
    """From one port checkpoint (the small model after two large steps, so
    that A or A_log and dt_bias have moved), both packages write the same 12
    artifacts under the same name from 8 float sequences: λ (8, 64, 2,
    layers) within 1e-5 relative, the percentages within 1e-5, the report's
    trained lines equal; the pseudo-LTI λ is exp(−softplus(A)) of the
    checkpoint, constant over the batch and time."""
    model_cfg = small(full)
    args = copy.deepcopy(full)
    args["model"] = model_cfg
    _, params = _jax_model(model_cfg)
    model, _ = _port(model_cfg, params)
    opt, clip = make_family_optimizer(model, "mamba", model_cfg, args["train"],
                                      {"lr": 0.05, "wd": 0.0, "betas": (0.9, 0.999)})
    x = torch.from_numpy(features(8, seed=5))
    y = torch.from_numpy(np.arange(8) % 10)
    for _ in range(2):
        train_step(model, opt, x, y, {"regular": 0.05}, None, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    batch = features(8, seed=6)
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(batch, np.zeros(8, np.int64), {"lengths": L})], ckpt, 0.5,
                           params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and pdir.startswith("CIFAR-10dmodel32")
    assert sorted(os.listdir(tmp_path / "port" / pdir)) == sorted(
        os.listdir(tmp_path / "jax" / jdir)) == ARTIFACT_FILES
    eig, eig_init = port_out[0], port_out[1]
    assert eig.shape == eig_init.shape == (8, L, HEADS, 2) and eig.dtype == np.float32
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=EIG_RTOL, atol=0)
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
    if full is CIFAR_MAMBA2_LTI_FULL:
        for i in range(2):
            lam = torch.exp(-torch.nn.functional.softplus(model.blocks[i].mamba.A)).detach()
            np.testing.assert_allclose(eig[..., i], np.broadcast_to(lam.numpy(), (8, L, HEADS)),
                                       rtol=EIG_RTOL, atol=0)
            assert (eig[..., i] == eig[:1, :1, :, i]).all()


# -- one AdamW step -----------------------------------------------------------------------

def test_adamw_step_matches_make_train_block():
    """One AdamW step behind optax's global-norm clip at dropout 0, on a
    float split of 6 sequences (batch 2) with the loop's warmup rate,
    against tlie_tpu's ``make_train_block``: the loss within 1e-5 relative,
    the parameters within 2e-6 where |g| is at least 1e-2 of its leaf's max
    and within the movement bound 2·lr + 2e-6 everywhere."""
    model_cfg = small()
    tc = dict(CIFAR_MAMBA2_FULL["train"], wd=0.05)
    lr, warmup, total = 0.01, 2, 10
    x, y = features(6, seed=7), np.array([1, 4, 4, 9, 0, 2])
    jmodel, _, _ = jax_build_models(dict(model_cfg), padded=False)
    state, _ = create_train_state_adamw(
        jmodel, jax.random.PRNGKey(0), in_dim=1, batch_size=2, seq_len=L,
        weight_decay=tc["wd"], lr=lr, betas=(0.9, 0.999), integer_inputs=False, param_group=None)
    params = to_numpy(state.params)
    block = jax_scan_loop.make_train_block(jmodel, "layer", ("regular",), warmup, total, True,
                                           1e-6)
    idx = batch_indices(np.random.default_rng(0), 6, 2, 1)
    jstate, jloss = block(state, jax.random.PRNGKey(1), jax_scan_loop.put_dataset(x, y), idx,
                          0, lr, lr)
    model, _ = _port(model_cfg, params)
    opt, clip = make_family_optimizer(model, "mamba", model_cfg, tc,
                                      {"lr": lr, "wd": tc["wd"], "betas": (0.9, 0.999)})
    data = put_dataset(x, y, "cpu")
    assert data.inputs.dtype == torch.float32
    rate = schedules.lr_for_step(0, lr, warmup, total, True, 1e-6)
    i = torch.from_numpy(idx[0]).long()
    loss = float(train_step(model, opt, data.inputs[i], data.labels[i], {"regular": rate}, None,
                            clip_norm=clip))
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})[0]
    got, _ = params_to_jax(model.state_dict())
    for (path, g), w, gr in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(to_numpy(jstate.params)),
                                jax.tree_util.tree_leaves(grads)):
        err = np.abs(g - w)
        det = np.abs(gr) >= 1e-2 * np.abs(gr).max()
        assert err[det].max(initial=0.0) <= 2e-6, path
        assert err.max() <= 2 * rate + 2e-6, path
