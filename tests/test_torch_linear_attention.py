"""The port's linear attention against tlie_tpu's: the chunked op (values and
gradients, with and without the normaliser, float32 and bfloat16) against
the port's recurrent form and JAX's chunked form, ``_pick_chunk`` and
``cumulative_key_normalizer``; the small MQAR linear-attention transformer's
logits and masked-CE gradients through weights carried by ``compat.py``,
``eig_att_linear`` and eval_eig's artifacts, the decoder (step path,
prefill, greedy tokens, with and without the conv); the configs under
``configs/`` and the sweep grid through both ``load_experiment``s; the init
η distribution; and ``launch`` end to end on the CPU.

The model is ``configs/mqar-lin-attention-small.yaml`` shrunk (2 layers,
d_model 32, two heads of 16, vocab 64) at L 40 (ragged against the chunk of
128: both packages pick 8) and L 64.  Inputs are made with numpy from a
seed; JAX runs jitted at HIGHEST matmul precision (tests/conftest.py).
Parity runs at dropout 0.  Tolerances are stated where they are used.
"""

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.eval_eig import _extract_attention_family
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_att_linear as jax_eig_att_linear
from tlie_tpu.config import expand_sweep as jax_expand_sweep
from tlie_tpu.config import load_experiment as jax_load_experiment
from tlie_tpu.config import load_sweep as jax_load_sweep
from tlie_tpu.config.schema import iter_sweep as jax_iter_sweep
from tlie_tpu.data.mqar import MQAR as JaxMQAR
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.ops import linear_attention as jla
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.analysis.extractors import eig_att_linear
from tlie_tpu_torch.compat import params_to_jax
from tlie_tpu_torch.config import (
    MQAR_LIN_ATTENTION_FULL, expand_sweep, iter_sweep, load_experiment, load_sweep, load_yaml,
)
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.ops import linear_attention as pla
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
from tlie_tpu_torch.training.state import make_family_optimizer
from tlie_tpu_torch.training.steps import head_logits
from torch_parity import jax_sparse_loss, jax_transformer_params, port_transformer, to_numpy

torch.set_num_threads(1)

SMALL_YAML = "configs/mqar-lin-attention-small.yaml"
FULL_YAML = "configs/tasks/mqar/mqar-lin-attention.yaml"
L = 40
ARTIFACTS = 12


def small_config(length=L):
    """The small YAML shrunk: d_model 32, two heads of 16, vocab 64."""
    cfg = jax_load_experiment(SMALL_YAML).raw
    cfg["dataset"].update(input_seq_length=length, num_kv_pairs=4, vocab_size=64,
                          num_train_examples=128, num_test_examples=64)
    cfg["model"].update(hidden_dim=32, state_dim=32, num_heads=2, vocab_size=64, output_dim=64,
                        max_pos_embed=64, seq_len=length)
    return cfg


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    model_cfg = dict(cfg["model"], dropout=0.0)
    data = MQAR(**cfg["dataset"])
    train, test = data.split("train"), data.split("test")
    return cfg, model_cfg, train, test, sparse_head_k_for(model_cfg, train[1], test[1])


# -- the op -------------------------------------------------------------------

def _qkv(B, Ln, H, Dk, Dv, seed):
    """Positive features (the elu+1 of normal draws), as the models feed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (np.exp(np.minimum(rng.standard_normal(s), 0))  # noqa: E731
                    + np.maximum(rng.standard_normal(s), 0)).astype(np.float32)
    return f(B, Ln, H, Dk), f(B, Ln, H, Dk), rng.standard_normal((B, Ln, H, Dv)).astype(np.float32)


@pytest.mark.parametrize("Ln", [40, 64, 256], ids=["ragged_l40", "l64", "l256_two_chunks"])
@pytest.mark.parametrize("normalizer", [False, True], ids=["plain", "normalizer"])
def test_chunked_matches_recurrent_and_jax_float32(Ln, normalizer):
    """y against the port's recurrent form and JAX's chunked form, 1e-5 of
    max|y| (float32 sums in other orders); n against JAX's 1e-5 relative;
    the gradients of q, k and v through a random cotangent on y (and n),
    against torch autograd of the recurrent form and jax.grad, 1e-5 of each
    gradient's max."""
    q, k, v = _qkv(2, Ln, 2, 8, 6, seed=Ln)
    rng = np.random.default_rng(1)
    wy = rng.standard_normal(v.shape).astype(np.float32)
    wn = rng.standard_normal(v.shape[:3]).astype(np.float32)
    scale = 0.25

    def jloss(q, k, v):
        out = jla.chunked_linear_attention(q, k, v, scale=scale, return_normalizer=normalizer)
        y, n = out if normalizer else (out, None)
        return jnp.sum(y * wy) + (jnp.sum(n * wn) if normalizer else 0.0), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pla.chunked_linear_attention(*t, scale=scale, return_normalizer=normalizer)
    y, n = out if normalizer else (out, None)
    loss = (y * torch.from_numpy(wy)).sum() + ((n * torch.from_numpy(wn)).sum() if normalizer
                                               else 0.0)
    grads = torch.autograd.grad(loss, t)
    r = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y_rec = pla.recurrent_linear_attention(*r, scale=scale)
    n_rec = pla.cumulative_key_normalizer(r[0], r[1] * scale)
    loss_rec = (y_rec * torch.from_numpy(wy)).sum() + (
        (n_rec * torch.from_numpy(wn)).sum() if normalizer else 0.0)
    grads_rec = torch.autograd.grad(loss_rec, r)

    jy = np.asarray(jout[0] if normalizer else jout)
    tol = 1e-5 * np.abs(jy).max()
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0, atol=tol)
    np.testing.assert_allclose(y.detach().numpy(), y_rec.detach().numpy(), rtol=0, atol=tol)
    if normalizer:
        assert n.dtype == torch.float32 and n.shape == (2, Ln, 2)
        np.testing.assert_allclose(n.detach().numpy(), np.asarray(jout[1]), rtol=1e-5)
        np.testing.assert_allclose(n.detach().numpy(), n_rec.detach().numpy(), rtol=1e-5)
    for g, gj, gr in zip(grads, jg, grads_rec):
        gj = np.asarray(gj)
        gtol = 1e-5 * np.abs(gj).max()
        np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=gtol)
        np.testing.assert_allclose(g.numpy(), gr.numpy(), rtol=0, atol=gtol)


@pytest.mark.parametrize("normalizer", [False, True], ids=["plain", "normalizer"])
def test_chunked_matches_jax_and_recurrent_in_bfloat16(normalizer):
    """bfloat16 inputs at a ragged L 40: y in bfloat16 within 3e-2 of max|y|
    of JAX's and of the float32 recurrent form on the same rounded inputs
    (each einsum's output is rounded to 8 bits of mantissa, 4e-3 a
    rounding, in another order); n in float32 from the upcast q and k,
    1e-5 relative to JAX's and to the float32 recurrent normaliser; the
    gradients of q, k, v within 3e-2 of each one's max of JAX's."""
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(2, L, 2, 8, 6, seed=3))
    w = np.random.default_rng(2).standard_normal((2, L, 2, 6)).astype(np.float32)

    def jloss(q, k, v):
        out = jla.chunked_linear_attention(q, k, v, return_normalizer=normalizer)
        y = out[0] if normalizer else out
        return jnp.sum(y.astype(jnp.float32) * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).requires_grad_()
         for a in (q, k, v)]
    out = pla.chunked_linear_attention(*t, return_normalizer=normalizer)
    y = out[0] if normalizer else out
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(), t)
    f32 = [x.detach().float() for x in t]
    y_rec = pla.recurrent_linear_attention(*f32)
    jy = np.asarray(jnp.asarray(jout[0] if normalizer else jout, jnp.float32))
    tol = 3e-2 * np.abs(jy).max()
    np.testing.assert_allclose(y.detach().float().numpy(), jy, rtol=0, atol=tol)
    np.testing.assert_allclose(y.detach().float().numpy(), y_rec.numpy(), rtol=0, atol=tol)
    if normalizer:
        n = out[1]
        assert n.dtype == torch.float32
        np.testing.assert_allclose(n.detach().numpy(), np.asarray(jout[1]), rtol=1e-5)
        np.testing.assert_allclose(n.detach().numpy(),
                                   pla.cumulative_key_normalizer(f32[0], f32[1]).numpy(),
                                   rtol=1e-5)
    for g, gj in zip(grads, jg):
        gj = np.asarray(jnp.asarray(gj, jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), gj, rtol=0, atol=3e-2 * np.abs(gj).max())


def test_chunk_choice_normaliser_eps_and_sequence_parallel():
    """``_pick_chunk`` equals the reference's for every L to 300 at chunk
    128 and 64; ``cumulative_key_normalizer`` equals JAX's (1e-6 relative)
    and ``eps`` replaces an exact zero in both forms; under the
    ``sequence_parallel`` context, in a gloo group of one, the call takes
    the sequence-parallel route and equals the plain chunked form."""
    for Ln in range(1, 301):
        for pref in (128, 64):
            assert pla._pick_chunk(Ln, pref) == jla._pick_chunk(Ln, pref)
    q, k, _ = _qkv(2, 24, 2, 4, 4, seed=5)
    q[0, :3] = 0.0  # an exact-zero normaliser at three positions
    want = np.asarray(jax.jit(jla.cumulative_key_normalizer, static_argnums=2)(q, k, 1e-3))
    got = pla.cumulative_key_normalizer(torch.from_numpy(q), torch.from_numpy(k), eps=1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert bool((got[0, :3] == 1e-3).all())
    _, n = pla.chunked_linear_attention(*(torch.from_numpy(a) for a in _qkv(2, 24, 2, 4, 4, 5)),
                                        return_normalizer=True, eps=7.0)
    q_t = torch.from_numpy(q)
    _, n0 = pla.chunked_linear_attention(q_t, torch.from_numpy(k), torch.ones(2, 24, 2, 4),
                                         return_normalizer=True, eps=7.0)
    assert bool((n0[0, :3] == 7.0).all()) and bool((n > 0).all())
    from tlie_tpu_torch.ops.scan import sequence_parallel
    from tlie_tpu_torch.parallel import mesh, sp

    mesh.init_process_group("cpu", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
    try:
        routed = []
        real = sp.sp_linear_attention
        sp.sp_linear_attention = lambda *a, **kw: routed.append(1) or real(*a, **kw)
        try:
            with sequence_parallel(mesh.Shard(0, 1, axis=1)):
                y_sp, n_sp = pla.chunked_linear_attention(q_t, q_t, q_t, return_normalizer=True,
                                                          eps=7.0)
        finally:
            sp.sp_linear_attention = real
    finally:
        mesh.destroy_process_group()
    y, n = pla.chunked_linear_attention(q_t, q_t, q_t, return_normalizer=True, eps=7.0)
    assert routed == [1]
    np.testing.assert_allclose(y_sp.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n_sp.numpy(), n.numpy(), rtol=1e-6, atol=1e-6)


# -- the model ----------------------------------------------------------------

_VARIANTS = {"small": {}, "conv_full": {"dim_conv": 4}, "conv_qk_glu": {"dim_conv": 3,
                                                                         "conv_type": "qk",
                                                                         "mixer": "glu"}}


@pytest.mark.parametrize("length", [L, 64], ids=["ragged_l40", "l64"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_logits_match_jax(variant, length):
    """The eval forward's log-probs on 4 examples, 2e-5 absolute (the
    normalised context is O(1) and the logits O(10))."""
    cfg = dict(small_config(length)["model"], dropout=0.0, **_VARIANTS[variant])
    jeval, params = jax_transformer_params(cfg, seed=3)
    x = np.random.default_rng(length).integers(0, 64, (4, length)).astype(np.int32)
    want = jax.nn.log_softmax(jax.jit(jeval.apply)({"params": params}, x))
    _, model = port_transformer(cfg, params)
    assert model.layers[0].attention.lin_att
    with torch.no_grad():
        got = torch.log_softmax(model(torch.from_numpy(x).long()), -1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


def test_every_gradient_of_the_masked_ce_matches_jax(small):
    """The sparse-head masked CE (1e-5 relative) and the gradient of every
    leaf within 1e-4 of that leaf's max|g| (float32 sums in other orders)."""
    _, model_cfg, train, _, k = small
    jeval, params = jax_transformer_params(model_cfg, seed=0)
    x, y = train[0][:32], train[1][:32]
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_sparse_loss(jeval, k)))(
        params, x.astype(np.int32), y.astype(np.int32))
    model, _ = port_transformer(model_cfg, params)
    loss = cross_entropy_loss(*head_logits(model, torch.from_numpy(x), torch.from_numpy(y), k))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    assert len(jax.tree_util.tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=str(path))


def test_eig_att_linear_matches_jax_and_guards_zeros():
    """``eig_att_linear`` against tlie_tpu's, 1e-5 relative (the BASELINE.json
    tolerance); an exact-zero ν becomes 2e-23 in both."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, L, 8)).astype(np.float32)
    W = (rng.standard_normal((8, 2 * 6 + 8)) * 0.7).astype(np.float32)
    b = rng.standard_normal(2 * 6 + 8).astype(np.float32)
    fn = jax.jit(jax_eig_att_linear, static_argnums=(3, 4, 5))
    want = np.asarray(fn(x, W, b, 6, 8, 2))
    got = eig_att_linear(torch.from_numpy(x), torch.from_numpy(W.T.copy()), torch.from_numpy(b),
                         6, 2).numpy()
    assert got.shape == want.shape == (3, L - 1, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # q's features vanish (elu(-inf)+1 = 0) at the first step: ν = 2e-23 there
    b0 = b.copy()
    b0[:3] = -np.inf
    want0 = np.asarray(fn(x, W, b0, 6, 8, 2))
    got0 = eig_att_linear(torch.from_numpy(x), torch.from_numpy(W.T.copy()),
                          torch.from_numpy(b0), 6, 2).numpy()
    np.testing.assert_allclose(got0, want0, rtol=1e-5, atol=0)


def test_eval_eig_artifacts_match_tlie_tpu(small, tmp_path):
    """From one port checkpoint (the small model after two large steps),
    both packages write the same 12 artifacts under the same name: the
    trained η within 1e-5 relative, the percentages within 1e-5, the
    report's trained lines equal; the port's extractor dispatches on
    ``attention_fn`` and raises on an unknown one."""
    cfg, model_cfg, train, test, k = small
    args = copy.deepcopy(cfg)
    args["model"] = model_cfg
    _, params = jax_transformer_params(model_cfg, seed=1)
    model, _ = port_transformer(model_cfg, params)
    opt, clip = make_family_optimizer(model, "transformer", model_cfg, cfg["train"],
                                      {"lr": 0.05, "wd": 0.1, "betas": (0.9, 0.999)})
    x, y = torch.from_numpy(train[0][:32]), torch.from_numpy(train[1][:32])
    for _ in range(2):
        train_step(model, opt, x, y, {"regular": 0.05}, k, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    batch = test[0][:16]
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=batch)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(batch.astype(np.int32), test[1][:16], {})], ckpt, 0.5,
                           params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir
    pfiles = sorted(os.listdir(tmp_path / "port" / pdir))
    assert pfiles == sorted(os.listdir(tmp_path / "jax" / jdir)) and len(pfiles) == ARTIFACTS
    eig = port_out[0]
    assert eig.shape == port_out[1].shape == (16, L - 1, 2, 2) and eig.dtype == np.float32
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=1e-5, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    with pytest.raises(RuntimeError, match="unsupported attention_fn"):
        extract_attention_family(model, x[:2], dict(model_cfg, attention_fn="rnn-attention"))


def test_init_eta_spectra_match_tlie_tpus_distribution():
    """Init η of the small model on one batch, pooled over six seeds in each
    package (the draws cannot match across frameworks, ROADMAP rule 2):
    the 5/25/50/75/95 % quantiles of log η per layer within 0.1 (a
    seed-to-seed spread of about 0.03 measured at this size)."""
    cfg = dict(small_config(64)["model"], dropout=0.0)
    x = np.random.default_rng(0).integers(0, 64, (16, 64)).astype(np.int32)
    jeval, _ = jax_transformer_params(cfg, seed=0)
    init = jax.jit(jeval.init)
    jax_eta, port_eta = [], []
    for s in range(6):
        p = init(jax.random.PRNGKey(s), x[:1])["params"]
        jax_eta.append(np.asarray(_extract_attention_family(jeval, p, x, cfg)))
        _, m, _ = build_models(cfg, generator=torch.Generator().manual_seed(s), device="cpu")
        port_eta.append(extract_attention_family(m, torch.from_numpy(x).long(), cfg))
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    for layer in range(cfg["num_layers"]):
        want = np.quantile(np.log(np.stack(jax_eta)[..., layer]), qs)
        got = np.quantile(np.log(np.stack(port_eta)[..., layer]), qs)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1)


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_stepwise_and_prefill_match_the_full_forward(small, variant):
    """The step path over (S, key sum) and the conv's tail against the full
    forward, 2e-5 of max|logit|; prefill's last logits likewise, and its
    state equal to the state the steps reach (1e-5 of max|S|)."""
    cfg = dict(small[1], **_VARIANTS[variant])
    _, params = jax_transformer_params(cfg, seed=9)
    _, model = port_transformer(cfg, params)
    dec = Decoder(cfg, model, device="cpu")
    x = torch.from_numpy(small[3][0][:3])
    with torch.no_grad():
        full = model(x)
    tol = 2e-5 * full.abs().max().item()
    torch.testing.assert_close(dec.stepwise_logits(x), full, rtol=0, atol=tol)
    cache, last = dec.prefill(x[:, :20], 30)
    torch.testing.assert_close(last, full[:, 19], rtol=0, atol=tol)
    stepped = dec.init_cache(3, 30)
    for t in range(20):
        stepped, _ = dec.step(stepped, x[:, t], t)
    assert len(cache) == cfg["num_layers"]
    for c, s in zip(cache, stepped):
        assert c[-2].shape == (3, 2, 16, 16) and c[-1].shape == (3, 2, 16)
        for a, b in zip(c, s):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
    # then steps from the prefilled state, against the full forward
    _, logits = dec.step(cache, x[:, 20], 20)
    torch.testing.assert_close(logits, full[:, 20], rtol=0, atol=tol)


def test_prefill_state_and_greedy_tokens_match_jax(small):
    """Prefill's logits and (conv tail, S, key sum) against tlie_tpu's
    Decoder on the same weights (2e-5 of each one's max), and 8 greedy
    tokens (equal); positions past the table raise."""
    cfg = dict(small[1], **_VARIANTS["conv_full"])
    _, params = jax_transformer_params(cfg, seed=7)
    model, _ = port_transformer(cfg, params)
    jdec, dec = JaxDecoder(cfg, params), Decoder(cfg, model.state_dict(), device="cpu")
    prompt = small[3][0][:3, :24]
    jcache, jlogits = jdec.prefill(prompt.astype(np.int32), 32)
    cache, logits = dec.prefill(prompt, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=2e-5)
    for c, jc in zip(cache, jcache):
        assert len(c) == len(jc) == 3
        for a, b in zip(c, jc):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-5 * np.abs(b).max())
    want = np.asarray(jdec.generate(prompt.astype(np.int32), 8))
    np.testing.assert_array_equal(dec.generate(prompt, 8).numpy(), want)
    with pytest.raises(ValueError, match="max_pos_embed"):
        dec.generate(prompt, 64 - 24 + 1)


# -- configs ------------------------------------------------------------------

CONFIGS = sorted(glob.glob("configs/**/*.yaml", recursive=True))


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_resolves_alike_in_both_packages(path):
    """``load_experiment`` gives the same dict in both packages, or raises
    the same ValueError (analysis and sweep files have no sections); a sweep
    file gives the same base, mapping, grid and points through
    ``load_sweep``, ``expand_sweep`` and ``iter_sweep``."""
    try:
        want = jax_load_experiment(path).raw
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            load_experiment(path)
    else:
        assert load_experiment(path).raw == want
    if "base_config" in load_yaml(path):
        jbase, jsweep = jax_load_sweep(path)
        base, sweep = load_sweep(path)
        assert base.raw == jbase.raw and sweep == jsweep
        assert expand_sweep(sweep) == jax_expand_sweep(jsweep)
        assert [c.raw for c in iter_sweep(base, sweep)] == [c.raw for c in
                                                            jax_iter_sweep(jbase, jsweep)]


def test_the_north_star_sweep_grid_and_the_full_config():
    """The 8k seed × LR sweep's 16 points in JAX's order, and
    ``MQAR_LIN_ATTENTION_FULL`` equal to the YAML as tlie_tpu resolves it
    (derive_runtime_fields with its MQAR dataset)."""
    base, sweep = load_sweep("configs/sweep/mqar-lin-attention-seeds-lrs-8k.yaml")
    grid = expand_sweep(sweep)
    assert len(grid) == 16 and grid == jax_expand_sweep(jax_load_sweep(
        "configs/sweep/mqar-lin-attention-seeds-lrs-8k.yaml")[1])
    assert grid[1] == {("seed",): 1919, ("train", "lr"): 0.00046416}
    assert base.layer == "transformer" and base.model["attention_fn"] == "lin-attention"
    exp = jax_load_experiment(FULL_YAML)
    data = JaxMQAR(**exp.dataset)

    class _Shape:
        l_max = data.l_max
        train_inputs = range(data.num_train_examples)

    exp.derive_runtime_fields(_Shape())
    assert MQAR_LIN_ATTENTION_FULL == exp.raw
    mine = load_experiment(FULL_YAML).derive_runtime_fields(_Shape())
    assert mine.raw == exp.raw and mine.checkpoint_name() == exp.checkpoint_name()


# -- launch ---------------------------------------------------------------------

def test_launch_trains_checkpoints_and_analyses_lin_attention_small_on_the_cpu(tmp_path,
                                                                             monkeypatch, capsys):
    """``launch.main`` on ``configs/mqar-lin-attention-small.yaml`` cut to 20
    steps, 2 evals and 512 training examples, with ``save`` and the
    analysis ``save_path`` under a temporary directory: the checkpoint, the
    12 artifacts, and η from the checkpoint (8 analysis examples, L 64, one
    head, two layers), finite and positive."""
    cfg = load_yaml(SMALL_YAML)
    cfg["save"] = str(tmp_path / "checkpoint" / "mqar-lin-attention-small")
    cfg["train"].update(total_steps=20, eval_every=10)
    cfg["dataset"].update(num_train_examples=512, num_test_examples=64)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 8, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 20:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("mqar-lin-attention-small-seed-1919") and ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    files = os.listdir(tmp_path / "analysis" / run)
    assert len(files) == ARTIFACTS and run.startswith("MQARdmodel64")
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, 63, 1, 2) and np.all(eig > 0) and np.isfinite(eig).all()


def test_sequence_dataset_registry_matches_tlie_tpu():
    """The port's ``SequenceDataset`` registry builds the small config's
    MQAR as tlie_tpu's does: equal split arrays after ``setup()``, and the
    same batches from ``test_dataloader`` and the shuffled
    ``train_dataloader`` (one seed); WikiText is registered too."""
    from tlie_tpu.data.base import SequenceDataset as JaxSequenceDataset
    from tlie_tpu_torch.data import DATASETS, SequenceDataset, WikiText

    assert DATASETS is SequenceDataset.registry and DATASETS["wikitext"] is WikiText
    cfg = small_config()["dataset"]
    mine, theirs = DATASETS["mqar"](**cfg), JaxSequenceDataset.registry["mqar"](**cfg)
    mine.setup()
    theirs.setup()
    assert (mine.l_max, mine.d_output, str(mine)) == (theirs.l_max, theirs.d_output, "mqar")
    for split in ("train_inputs", "train_labels", "test_inputs", "test_labels"):
        np.testing.assert_array_equal(getattr(mine, split), getattr(theirs, split))
    for name, kw in (("test_dataloader", {}), ("train_dataloader", {"shuffle": True})):
        ours, ref = getattr(mine, name)(16, **kw), getattr(theirs, name)(16, **kw)
        assert len(ours) == len(ref) == 64 // 16 * (2 if name == "train_dataloader" else 1)
        for (x, y, aux), (jx, jy, jaux) in zip(ours, ref):
            np.testing.assert_array_equal(x, np.asarray(jx))
            np.testing.assert_array_equal(y, np.asarray(jy))
            assert aux == jaux == {"lengths": cfg["input_seq_length"]}
    with pytest.raises(ValueError, match="name mismatch"):
        DATASETS["mqar"](_name_="wikitext")
