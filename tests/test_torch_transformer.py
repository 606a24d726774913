"""The port's softmax transformer against tlie_tpu's: the position table and
element-wise dropout, the model's logits (with and without the conv, the GLU
mixer, the xla choice) and every gradient through weights carried by
``params_from_jax``, two AdamW + global-norm-clip steps, the key names
against ``tlie_tpu/analysis/compat.py``, ``eig_att_softmax`` and eval_eig's
artifacts, greedy decoding and the step path, the ``ValueError`` past the
position table, the full config, and ``launch`` end to end on the CPU.

The model is ``configs/mqar-sm-attention-small.yaml`` shrunk further
(d_model 32, two heads of 16, vocab 64, L 32).  Inputs are made with numpy
from a seed; JAX runs jitted at HIGHEST matmul precision (tests/conftest.py).
Parity runs at dropout 0 (the dropout streams cannot match).  Tolerances are
stated where they are used.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.compat import torch_state_dict_to_flax
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_att_softmax as jax_eig_att_softmax
from tlie_tpu.config import load_experiment
from tlie_tpu.data.mqar import MQAR as JaxMQAR
from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models import layers as jax_layers
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state_adamw
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.extractors import eig_att_softmax, eta_softmax_from_qk
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.config import MQAR_SM_ATTENTION_FULL, load_yaml
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import Transformer, build_models
from tlie_tpu_torch.models.layers import Dropout, TokenEmbeddings
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, schedules, train_step
from tlie_tpu_torch.training.scan_loop import batch_indices, put_dataset, sparse_head_k_for
from tlie_tpu_torch.training.state import make_family_optimizer
from tlie_tpu_torch.training.steps import head_logits
from torch_parity import to_numpy

torch.set_num_threads(1)

SMALL_YAML = "configs/mqar-sm-attention-small.yaml"
FULL_YAML = "configs/tasks/mqar/mqar-sm-attention.yaml"
L, MAX_POS = 32, 40  # the position table reaches 8 steps past the training length


def small_config():
    """The small YAML shrunk: d_model 32, two heads of 16, vocab 64, L 32."""
    cfg = load_experiment(SMALL_YAML).raw
    cfg["dataset"].update(input_seq_length=L, num_kv_pairs=4, vocab_size=64,
                          num_train_examples=128, num_test_examples=64)
    cfg["model"].update(hidden_dim=32, state_dim=32, num_heads=2, vocab_size=64, output_dim=64,
                        max_pos_embed=MAX_POS, seq_len=L)
    return cfg


def _jax_params(model_cfg, seed=0):
    _, jeval, _ = jax_build_models(model_cfg, padded=False)
    toks = np.zeros((1, model_cfg["seq_len"]), np.int32)
    return jeval, to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(seed), toks)["params"])


def _port(model_cfg, params):
    model, eval_model, family = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    assert family == "transformer" and isinstance(model, Transformer)
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


@pytest.fixture(scope="module")
def small():
    """The shrunk config at dropout 0, JAX weights, and an MQAR split with K
    for the sparse head."""
    cfg = small_config()
    model_cfg = dict(cfg["model"], dropout=0.0)
    jeval, params = _jax_params(model_cfg)
    data = MQAR(**cfg["dataset"])
    train, test = data.split("train"), data.split("test")
    k = sparse_head_k_for(model_cfg, train[1], test[1])
    assert k == 4
    return cfg, model_cfg, jeval, params, train, test, k


# -- layers -------------------------------------------------------------------

def test_token_and_position_embeddings_match_flax():
    """TokenEmbeddings with its position table through carried weights
    (equal: two gathers and one add), and the table's bound."""
    ids = np.random.default_rng(0).integers(0, 50, (2, 12)).astype(np.int32)
    jm = jax_layers.TokenEmbeddings(16, 50, 12)
    p = to_numpy(jax.jit(jm.init)(jax.random.PRNGKey(0), ids)["params"])
    emb = TokenEmbeddings(16, 50, torch.Generator(), 12)
    sd = params_from_jax({"encoder": p})
    emb.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    assert emb.position_embeddings.weight.shape == (12, 16)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, ids))
    np.testing.assert_array_equal(emb(torch.from_numpy(ids).long()).detach().numpy(), want)
    with pytest.raises(IndexError):
        emb(torch.zeros(1, 13, dtype=torch.long))


def test_dropout_is_elementwise_and_draws_from_the_model_generator(small):
    """In training mode the mask is element-wise (not shared over time as
    the SSM backbone's), kept values are scaled by 1/(1-rate), and two models
    built from one seed draw the same masks; in evaluation it is the
    identity."""
    cfg = small[0]
    model_cfg = dict(cfg["model"])  # dropout 0.1
    outs = []
    for _ in range(2):
        model, eval_model, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(5),
                                            device="cpu")
        drops = [m for m in model.modules() if isinstance(m, Dropout)]
        assert len(drops) == 1 + 2 * model_cfg["num_layers"]
        assert all(m.generator is drops[0].generator is not None for m in drops)
        y = model.drop(torch.ones(4, L, 32))
        outs.append(y)
        torch.testing.assert_close(eval_model.drop(torch.ones(3, 5)), torch.ones(3, 5))
    y = outs[0]
    assert bool(((y == 0) | (y == torch.tensor(1.0) / 0.9)).all())
    assert 0.05 < float((y == 0).float().mean()) < 0.15
    assert not torch.equal(y[:, 0], y[:, 1])  # not broadcast over time
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# -- the model ----------------------------------------------------------------

_VARIANTS = {
    "mqar_small": {},
    "conv_full": {"dim_conv": 4},
    "conv_qk_glu": {"dim_conv": 3, "conv_type": "qk", "mixer": "glu"},
    "dqk_differs_xla": {"state_dim": 16},
    "use_flash_false": {"use_flash": False},
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_logits_match_jax(small, variant):
    """The eval forward on 4 test examples, 2e-5 of max|logit|; the xla
    path where the config chooses it (head dims differ, or use_flash off)."""
    _, model_cfg, _, _, _, test, _ = small
    cfg = dict(model_cfg, **_VARIANTS[variant])
    jeval, params = _jax_params(cfg, seed=3)
    x = test[0][:4]
    want = np.asarray(jax.jit(jeval.apply)({"params": params}, x.astype(np.int32)))
    _, model = _port(cfg, params)
    impl = model.layers[0].attention.impl
    assert impl == ("xla" if variant in ("dqk_differs_xla", "use_flash_false") else None)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def _jax_sparse_loss(model, k):
    def loss(params, x, y):
        feats = model.apply({"params": params}, x, method=type(model).features)
        _, pos = jax.lax.top_k((y != -100).astype(jnp.int32), k)
        f_sel = jnp.take_along_axis(feats, pos[..., None], axis=1)
        y_sel = jnp.take_along_axis(y, pos, axis=1)
        return jax_scan_loop.cross_entropy_loss(f_sel @ params["decoder"]["kernel"], y_sel)
    return loss


def test_every_gradient_matches_jax(small):
    """The sparse-head loss (1e-5 relative) and the gradient of every leaf,
    within 1e-4 of that leaf's max|g| (f32 sums in other orders); on the CPU
    the attention's backward is FlashAttentionFn's plain dK/dV and dQ."""
    _, model_cfg, jeval, params, train, _, k = small
    x, y = train[0][:32], train[1][:32]
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_sparse_loss(jeval, k)))(
        params, x.astype(np.int32), y.astype(np.int32))
    model, _ = _port(model_cfg, params)
    loss = cross_entropy_loss(*head_logits(model, torch.from_numpy(x), torch.from_numpy(y), k))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(got_leaves) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(got_leaves, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=str(path))


@pytest.mark.parametrize("decoder_scale", [1.0, 30.0], ids=["init_weights", "decoder_x30"])
def test_adamw_clip_steps_match_make_train_block(small, decoder_scale):
    """Two AdamW steps behind optax's global-norm clip at a rate of 1e-3
    against ``make_train_block``: the mean loss (1e-5 relative), and the
    parameters 2e-6 absolute where both steps' |g| are at least 1e-2 of
    their leaf's max or the gradient is exactly 0 (rows of tokens and
    positions the batches do not touch: weight decay alone moves them),
    within the movement bound 2·Σ lr + 2e-6 everywhere (Adam divides each
    element by its own magnitude; see tests/test_torch_mamba2.py).  Over 40 %
    of the elements with a gradient are held to the 2e-6.  With the decoder
    scaled by 30 the raw gradient norm is above 1, so the clip acts."""
    cfg, model_cfg, _, params, train, _, k = small
    params = copy.deepcopy(params)
    params["decoder"]["kernel"] = params["decoder"]["kernel"] * decoder_scale
    tc = dict(cfg["train"], warmup_steps=0)
    lr = 1e-3
    n_steps = 2
    jmodel, _, _ = jax_build_models(model_cfg, padded=False)
    state, _ = create_train_state_adamw(
        jmodel, jax.random.PRNGKey(0), in_dim=model_cfg["input_dim"], batch_size=2,
        seq_len=model_cfg["seq_len"], weight_decay=tc["wd"], lr=lr, betas=(0.9, 0.999),
        integer_inputs=True, param_group=None)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    groups = tuple(sorted(state.opt_state.inner_states))
    assert groups == ("regular",)
    block = jax_scan_loop.make_train_block(jmodel, "layer", groups, 0, tc["total_steps"],
                                           tc["cosine_anneal"], 1e-6, sparse_head_k=k)
    idx = batch_indices(np.random.default_rng(0), len(train[0]), tc["batch_size"], n_steps)
    jstate, jloss = block(state, jax.random.PRNGKey(1), jax_scan_loop.put_dataset(*train), idx,
                          0, lr, lr)

    model, _ = _port(model_cfg, params)
    f = {"lr": lr, "ssm_lr": lr, "wd": tc["wd"], "betas": (0.9, 0.999)}
    opt, clip = make_family_optimizer(model, "transformer", model_cfg, tc, f)
    assert clip == 1.0 and [g["name"] for g in opt.param_groups] == ["regular"]
    data = put_dataset(*train, "cpu")
    losses, lr_sum, gs = [], 0.0, []
    for s in range(n_steps):
        rate = schedules.lr_for_step(s, lr, 0, tc["total_steps"], tc["cosine_anneal"], 1e-6)
        i = torch.from_numpy(idx[s]).long()
        losses.append(float(train_step(model, opt, data.inputs[i], data.labels[i],
                                       {"regular": rate}, k, clip_norm=clip)))
        lr_sum += rate
        gs.append(params_to_jax({n: p.grad for n, p in model.named_parameters()})[0])
    assert np.mean(losses) == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax(model.state_dict())
    n_det = n_all = 0
    for (path, g), w, g1, g2 in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree_util.tree_leaves(to_numpy(jstate.params)),
                                    jax.tree_util.tree_leaves(gs[0]),
                                    jax.tree_util.tree_leaves(gs[1])):
        err = np.abs(g - w)
        det = ((np.abs(g1) >= 1e-2 * np.abs(g1).max()) & (np.abs(g2) >= 1e-2 * np.abs(g2).max()))
        assert err[det | (g1 == 0)].max(initial=0.0) <= 2e-6, path
        assert err.max() <= 2 * lr_sum + 2e-6, path
        n_det, n_all = n_det + det.sum(), n_all + (g1 != 0).sum()
    assert n_det > 0.4 * n_all
    for g in gs:
        norm = np.sqrt(sum(float(np.sum(np.square(x))) for x in jax.tree_util.tree_leaves(g)))
        if decoder_scale > 1:
            assert norm == pytest.approx(1.0, rel=1e-5)
        else:
            assert norm < 1.0


@pytest.mark.parametrize("variant", ["mqar_small", "conv_qk_glu"])
def test_state_dict_keys_are_the_reference_names(small, variant):
    """The port's state_dict converts through tlie_tpu's own
    ``torch_state_dict_to_flax(..., "transformer")`` to the tree
    params_to_jax gives and to flax's own tree; params_to_jax inverts
    params_from_jax exactly; both LayerNorms of a block are one module."""
    _, model_cfg, _, _, _, _, _ = small
    cfg = dict(model_cfg, **_VARIANTS[variant])
    _, params = _jax_params(cfg, seed=1)
    model, _ = _port(cfg, params)
    sd = model.state_dict()
    assert {"encoder.word_embeddings.weight", "encoder.position_embeddings.weight",
            "layers.0.attention.Wqkv.weight", "layers.1.attention.out_proj.bias",
            "layers.1.norm.weight", "norm.bias", "decoder.weight"} <= set(sd)
    assert "decoder.bias" not in sd and "layers.0.norm2.weight" not in sd
    mine, stats = params_to_jax(sd)
    assert stats is None
    theirs = torch_state_dict_to_flax(sd, "transformer")
    for a, b, c in zip(jax.tree_util.tree_leaves_with_path(mine),
                       jax.tree_util.tree_leaves_with_path(theirs),
                       jax.tree_util.tree_leaves_with_path(params)):
        assert a[0] == b[0] == c[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[1])
    back = params_from_jax(mine)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_registry_refuses_what_is_not_ported(small):
    _, model_cfg, _, _, _, _, _ = small
    g = torch.Generator()
    # use_gate, the classifier head (tests/test_torch_transformer_classifier.py),
    # the dual MATCH head (tests/test_torch_aan_dual.py), bf16 compute
    # (tests/test_torch_bf16_families.py), the hybrid mixer and the dense
    # encoder (tests/test_torch_transformer_options.py) are ported
    for ported in ({"use_gate": True}, {"classifier": True, "pooling": "mean", "mixer_dim": 8},
                   {"classifier": True, "pooling": "mean", "mixer_dim": 8, "dual": True},
                   {"compute_dtype": "bfloat16"}, {"mixer": "hybrid"},
                   {"embedding": False, "input_dim": 3}):
        build_models(dict(model_cfg, **ported), generator=g, device="cpu")
    for bad in ({"compute_dtype": "float16"},):
        with pytest.raises(NotImplementedError):
            build_models(dict(model_cfg, **bad), generator=g, device="cpu")
    with pytest.raises(RuntimeError):
        build_models(dict(model_cfg, mixer="moe"), generator=g, device="cpu")
    with pytest.raises(RuntimeError):
        build_models(dict(model_cfg, attention_fn="rnn-attention"), generator=g, device="cpu")
    model, eval_model, _ = build_models(model_cfg, generator=g, device="cpu")
    assert model.training and not eval_model.training
    assert all(p is q for p, q in zip(model.parameters(), eval_model.parameters()))


def test_full_config_dict_is_the_yaml_as_tlie_tpu_resolves_it():
    exp = load_experiment(FULL_YAML)
    data = JaxMQAR(**exp.dataset)

    class _Shape:
        l_max = data.l_max
        train_inputs = range(data.num_train_examples)

    exp.derive_runtime_fields(_Shape())
    assert MQAR_SM_ATTENTION_FULL == exp.raw
    assert load_yaml(FULL_YAML) == load_experiment(FULL_YAML).raw


# -- eigen-analysis -----------------------------------------------------------

def test_eig_att_softmax_matches_jax_and_keeps_the_masked_row_max_quirk():
    """``eig_att_softmax`` against tlie_tpu's (1e-5 relative: float32 sums
    of L exps), and ``eta_softmax_from_qk`` in float64 against the formula
    written out: ν_t = Σ_{s≤t} exp(q_t·k_s − m_t) + (L−1−t), the masked
    entries each adding exp(0) = 1, m_t the row max with those zeros in it
    (1e-12)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 10, 8)).astype(np.float32)
    W = (rng.standard_normal((8, 2 * 6 + 8)) * 0.7).astype(np.float32)
    b = rng.standard_normal(2 * 6 + 8).astype(np.float32)
    want = np.asarray(jax.jit(jax_eig_att_softmax, static_argnums=(3, 4, 5))(x, W, b, 6, 8, 2))
    got = eig_att_softmax(torch.from_numpy(x), torch.from_numpy(W.T.copy()), torch.from_numpy(b),
                          6, 2).numpy()
    assert got.shape == want.shape == (3, 9, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

    q, k = rng.standard_normal((2, 2, 7, 1, 3)) * 2.0
    Ln = q.shape[1]
    scores = np.einsum("bthd,bshd->bts", q, k)
    se, m = np.zeros((2, Ln)), np.zeros((2, Ln))
    for t in range(Ln):
        m[:, t] = np.max(np.concatenate([scores[:, t, : t + 1], np.zeros((2, Ln - 1 - t))], 1), 1)
        se[:, t] = np.exp(scores[:, t, : t + 1] - m[:, t:t + 1]).sum(1) + (Ln - 1 - t)
    eta = se[:, :-1] / se[:, 1:] * np.exp(m[:, :-1] - m[:, 1:])
    port = eta_softmax_from_qk(torch.from_numpy(q), torch.from_numpy(k))[..., 0].numpy()
    np.testing.assert_allclose(port, eta, rtol=1e-12, atol=0)


def test_eval_eig_artifacts_match_tlie_tpu(small, tmp_path):
    """From one port checkpoint (the small model after two large steps),
    both packages write the same artifact set under the same name: the
    trained η within 1e-5 relative (a ratio of float32 sums of exps, which
    after these steps reaches 1e7), the trained percentages (radius, phase, mean,
    std) within 1e-5 and the report's trained lines equal.  The init spectra
    come from each package's own generator and are held to their shape and
    to η > 0."""
    cfg, model_cfg, _, params, train, test, k = small
    args = copy.deepcopy(cfg)
    args["model"] = model_cfg
    model, _ = _port(model_cfg, params)
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
    assert pfiles == sorted(os.listdir(tmp_path / "jax" / jdir)) and len(pfiles) == 12
    eig, eig_init = port_out[0], port_out[1]
    assert eig.shape == eig_init.shape == np.asarray(jax_out[0]).shape == (16, L - 1, 2, 2)
    assert eig.dtype == np.float32 and np.all(eig_init > 0)
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=1e-5, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    saved = yaml.safe_load((tmp_path / "port" / pdir / "used_config.yaml").read_text())
    assert saved["model"]["layer"] == "transformer"
    with pytest.raises(ValueError, match="analysis batch"):
        eval_eig(args, {"save_path": str(tmp_path / "none")}, 0.5, ckpt, device="cpu")


# -- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders(small):
    cfg = dict(small[1], **_VARIANTS["conv_qk_glu"])
    _, params = _jax_params(cfg, seed=7)
    model, eval_model = _port(cfg, params)
    return cfg, params, JaxDecoder(cfg, params), Decoder(cfg, model.state_dict(), device="cpu"), \
        eval_model


@pytest.mark.parametrize("variant", ["mqar_small", "conv_qk_glu"])
def test_stepwise_and_prefill_match_the_full_forward(small, variant):
    """The step path over the KV cache (and the conv's tail) against the
    full forward, 2e-5 of max|logit|; prefill's last logits and cache
    likewise."""
    cfg = dict(small[1], **_VARIANTS[variant])
    _, params = _jax_params(cfg, seed=9)
    _, model = _port(cfg, params)
    dec = Decoder(cfg, model, device="cpu")
    x = torch.from_numpy(small[5][0][:3])
    with torch.no_grad():
        full = model(x)
    tol = 2e-5 * full.abs().max().item()
    torch.testing.assert_close(dec.stepwise_logits(x), full, rtol=0, atol=tol)
    cache, last = dec.prefill(x[:, :20], 30)
    torch.testing.assert_close(last, full[:, 19], rtol=0, atol=tol)
    assert len(cache) == cfg["num_layers"] and cache[0][-1].shape == (3, 30, 2, 16)
    assert bool((cache[0][-1][:, 20:] == 0).all())


def test_prefill_cache_and_greedy_tokens_match_jax(decoders, small):
    """Prefill's logits and KV cache (2e-5 absolute) and greedy tokens
    (equal) against tlie_tpu's Decoder on the same weights."""
    cfg, _, jdec, dec, _ = decoders
    prompt = small[5][0][:3, :24]
    jcache, jlogits = jdec.prefill(prompt.astype(np.int32), 32)
    cache, logits = dec.prefill(prompt, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=2e-5)
    for c, jc in zip(cache, jcache):
        assert len(c) == len(jc) == 3  # conv tail, k cache, v cache
        for a, b in zip(c, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    want = np.asarray(jdec.generate(prompt.astype(np.int32), 8))
    got = dec.generate(prompt, 8).numpy()
    assert got.shape == (3, 32)
    np.testing.assert_array_equal(got, want)


def test_positions_past_the_table_raise(decoders, small):
    """L0 + n_new past max_pos_embed raises ValueError in generate, prefill
    and step, where tlie_tpu's decoder gathers NaN from past its table."""
    cfg, params, jdec, dec, model = decoders
    prompt = small[5][0][:2]  # L0 = 32, the table holds 40
    assert dec.generate(prompt, MAX_POS - L).shape == (2, MAX_POS)
    with pytest.raises(ValueError, match="max_pos_embed"):
        dec.generate(prompt, MAX_POS - L + 1)
    with pytest.raises(ValueError, match="max_pos_embed"):
        dec.prefill(prompt, MAX_POS + 1)
    cache, logits = dec.prefill(prompt, MAX_POS)
    with pytest.raises(ValueError, match="max_pos_embed"):
        dec.step(cache, torch.zeros(2, dtype=torch.long), MAX_POS)
    long = np.concatenate([prompt, prompt[:, : MAX_POS + 1 - L]], axis=1).astype(np.int32)
    assert np.isnan(np.asarray(jdec.stepwise_logits(long))[:, -1]).all()
    with pytest.raises(ValueError, match="max_pos_embed"):
        dec.stepwise_logits(long)


def test_positions_past_the_kv_cache_raise(decoders, small):
    """A KV cache of ``max_len`` below ``max_pos_embed``: the step at
    position ``max_len`` lies inside the position table, so the cache's own
    bound must raise (``Decoder._mha_step``), not the table's."""
    cfg, params, jdec, dec, model = decoders
    prompt = small[5][0][:2]  # L0 = 32, the table holds 40
    max_len = L + 2
    assert max_len < MAX_POS
    cache, _ = dec.prefill(prompt, max_len)
    tok = torch.zeros(2, dtype=torch.long)
    cache, _ = dec.step(cache, tok, L)
    cache, _ = dec.step(cache, tok, L + 1)
    with pytest.raises(ValueError, match="past the KV cache of 34"):
        dec.step(cache, tok, max_len)


# -- launch ---------------------------------------------------------------------

def test_launch_trains_checkpoints_and_analyses_the_transformer_on_the_cpu(tmp_path, monkeypatch,
                                                                          capsys):
    """``launch.main`` on a cut copy of the small config (20 steps, 2 evals,
    512 training examples, dropout 0.1 as configured): the checkpoint, the 12
    artifacts, and η from the checkpoint equal to eig_att_softmax of the
    trained weights (1e-6)."""
    cfg = load_yaml(SMALL_YAML)
    cfg["save"] = str(tmp_path / "checkpoint" / "mqar-sm-attention-small")
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
    assert "step 20:" in out and "Finished!" in out and "sparse decoder head" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    files = os.listdir(tmp_path / "analysis" / run)
    assert len(files) == 12 and run.startswith("MQARdmodel128")
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, 63, 1, 2) and np.all(eig > 0)


# -- the card run's path 5, rehearsed ------------------------------------------

def test_chip_smoke_path_5_runs_on_the_cpu_with_counting_plain_kernels(monkeypatch):
    """``chip_smoke.transformer_path`` at a tiny size on the CPU, with the
    card's timers stubbed and the three kernel wrappers replaced by counting
    plain versions: every check of the path (kernels against plain, the
    forward against the CPU, training, the checkpoint's spectra, serving,
    the step against float64, the exact launch counts) runs as on the card."""
    import importlib.util

    from tlie_tpu_torch import config as port_config
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    for name, stub in (("synchronize", lambda *a, **k: None), ("Event", Event),
                       ("_sleep", lambda *a: None), ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, stub)
    for key in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, key, LAUNCHES[key])

    def counting(name, fn):
        def launch(*args):
            LAUNCHES[name] += 1
            return fn(*args)
        return launch

    monkeypatch.setattr(fa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fa, "flash_attention_fwd_cuda",
                        counting("flash_attention_fwd", fa.flash_attention_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv_cuda",
                        counting("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq_cuda",
                        counting("flash_attention_bwd_dq", fa.flash_attention_bwd_dq_plain))
    monkeypatch.setattr(cs, "top_device_ops", lambda fn, k=6: (fn(), [])[1])
    tiny = copy.deepcopy(MQAR_SM_ATTENTION_FULL)
    tiny["dataset"].update(input_seq_length=64, num_kv_pairs=8, vocab_size=256)
    tiny["train"]["batch_size"] = 32
    tiny["model"].update(seq_len=64, max_pos_embed=64, vocab_size=256, output_dim=256,
                         hidden_dim=32, state_dim=32)
    monkeypatch.setattr(port_config, "MQAR_SM_ATTENTION_FULL", tiny)
    monkeypatch.setattr(cs, "ATTN_SHAPES", {"mqar_b4_l64_h1_d32": (4, 64, 1, 32),
                                            "ragged_b3_l77_h3_d40": (3, 77, 3, 40)})
    monkeypatch.setattr(cs, "TF_STEPS", 4)
    monkeypatch.setattr(cs, "TF_EVAL_EVERY", 2)
    monkeypatch.setattr(cs, "TF_PROMPT", 48)
    data = MQAR(input_seq_length=64, num_kv_pairs=8, vocab_size=256, num_train_examples=256,
                num_test_examples=96)
    test_x, test_y = data.split("test")
    files = sorted([f"{k}.npy" for k in ("eig", "eig_init", "percentage", "percentage_init",
                                          "percentage_phase", "percentage_phase_init",
                                          "percentage_mean", "percentage_init_mean",
                                          "percentage_std", "percentage_init_std")]
                   + ["percentage_file.txt", "used_config.yaml"])
    launches, times, errs = cs.transformer_path(
        torch.device("cpu"), torch.Generator().manual_seed(0), torch.empty(1024), test_x, test_y,
        data.split("train"), files)
    # 2 per forward: 6 in the forward phase (the checked one, one untimed and
    # three timed, one profiled) and its CPU reference (counted here, where
    # every tensor is routed to the counting wrappers), 4 steps, 3 eval
    # batches twice, 8 in eval_eig and serving; 2 of each backward per step
    assert launches["flash_attention_fwd"] == 2 * (6 + 1 + 4 + 6 + 8)
    assert launches["flash_attention_bwd_dkv"] == launches["flash_attention_bwd_dq"] == 2 * 4
    assert set(times) == set(errs) == {"flash_attention_fwd", "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq"}
