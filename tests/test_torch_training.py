"""The port's training pieces against tlie_tpu's: the training-mode layer
(flax BatchNorm statistics, broadcast dropout), the schedules and plateau,
the optimiser groups, the masked CE and accuracy, the sparse decoder head,
the batch order, and whole optimiser steps from identical weights.

Parity runs at dropout 0: the dropout streams of the two frameworks cannot
match, so the masks are held to their shape, scale and keep rate instead.
Tolerances are stated where they are used; JAX runs jitted at HIGHEST
matmul precision (tests/conftest.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tlie_tpu.models.backbone import SequenceLayer as JaxSequenceLayer
from tlie_tpu.models.lru import LRU as JaxLRU
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training import schedules as jax_schedules
from tlie_tpu.training.state import _grouped_tx, create_train_state
from tlie_tpu.training.steps import compute_accuracy as jax_accuracy
from tlie_tpu.training.steps import cross_entropy_loss as jax_ce
from tlie_tpu_torch.compat import params_from_jax, params_to_jax
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import LRU, build_models
from tlie_tpu_torch.models.backbone import BroadcastDropout, SequenceLayer
from tlie_tpu_torch.training import compute_accuracy, cross_entropy_loss, train_step
from tlie_tpu_torch.training import schedules
from tlie_tpu_torch.training.scan_loop import (
    batch_indices, eval_indices, evaluate, put_dataset, sparse_head_k_for,
)
from tlie_tpu_torch.training.state import make_optimizer, param_groups
from tlie_tpu_torch.training.steps import head_logits, sparse_positions
from torch_parity import jax_weights, small_config, to_numpy

torch.set_num_threads(1)


# -- the training-mode layer --------------------------------------------------

_LAYERS = [("full_glu", False, "batch"), ("half_glu1", True, "batch"),
           ("half_glu2", False, "layer"), ("gelu", True, "layer")]


@pytest.mark.parametrize("activation, prenorm, norm", _LAYERS,
                         ids=[f"{a}-{'pre' if p else 'post'}-{n}" for a, p, n in _LAYERS])
def test_train_mode_layer_matches_flax(activation, prenorm, norm):
    """Outputs and updated batch_stats of one training-mode SequenceLayer at
    dropout 0 (2e-5 absolute: f32, summation order only)."""
    d_model, n, batch, length = 12, 10, 3, 20
    ssm = functools.partial(JaxLRU, n, d_model, r_min=0.9, r_max=0.99)
    jlayer = JaxSequenceLayer(ssm=ssm, d_model=d_model, dropout=0.0, activation=activation,
                              training=True, prenorm=prenorm, norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, length, d_model)).astype(np.float32) * 2 + 0.5
    variables = to_numpy(jax.jit(jlayer.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    stats = variables.get("batch_stats")
    if stats:
        stats["normalize"]["mean"] = rng.normal(0, 0.3, d_model).astype(np.float32)
        stats["normalize"]["var"] = rng.uniform(0.5, 1.5, d_model).astype(np.float32)
    apply = jax.jit(functools.partial(jlayer.apply, mutable=["batch_stats"]))
    want, updates = apply(variables, jnp.asarray(x))

    layer = SequenceLayer(lambda: LRU(n, d_model, torch.Generator(), 0.9, 0.99), d_model,
                          torch.Generator(), activation, prenorm, norm, dropout=0.0).train()
    full = params_from_jax({"encoder": {"layers_0": variables["params"]}, "decoder": {}},
                           {"encoder": {"layers_0": stats}} if stats else None)
    layer.load_state_dict({k[len("encoder.layers.0."):]: v for k, v in full.items()})
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    if norm == "batch":
        new = updates["batch_stats"]["normalize"]
        np.testing.assert_allclose(layer.normalize.running_mean.numpy(), np.asarray(new["mean"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(layer.normalize.running_var.numpy(), np.asarray(new["var"]),
                                   rtol=0, atol=1e-6)


def test_dropout_masks_broadcast_over_time():
    """One mask per (example, feature): values 0 or 1/(1-p), constant along
    time, kept at rate 1-p (within 4 standard deviations over 2048 draws);
    the identity in eval mode; the same masks from the same seed."""
    p = 0.25
    x = torch.ones(64, 8, 32)
    gen = torch.Generator().manual_seed(3)
    drop = BroadcastDropout(p, gen).train()
    y = drop(x)
    assert torch.equal(y, y[:, :1].expand_as(y))
    values = torch.unique(y).tolist()
    assert len(values) == 2 and values[0] == 0.0 and values[1] == pytest.approx(1 / (1 - p))
    keep = (y[:, 0] > 0).float().mean().item()
    assert abs(keep - (1 - p)) < 4 * np.sqrt(p * (1 - p) / (64 * 32))
    gen.manual_seed(3)
    assert torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


def test_train_and_eval_models_share_weights_and_statistics():
    cfg = dict(small_config()["model"], input_dim=32, output_dim=32, hidden_dim=8,
               state_dim=8, seq_len=16)
    model, eval_model, family = build_models(cfg, generator=torch.Generator().manual_seed(0),
                                             device="cpu")
    assert family == "lru" and model.training and not eval_model.training
    for (n, p), (m, q) in zip(model.named_parameters(), eval_model.named_parameters()):
        assert n == m and p is q
    for b, c in zip(model.buffers(), eval_model.buffers()):
        assert b is c
    model(torch.zeros(2, 16, dtype=torch.long))  # training forward: statistics move
    torch.testing.assert_close(eval_model.encoder.layers[0].normalize.running_mean,
                               model.encoder.layers[0].normalize.running_mean)


# -- schedules, plateau, optimiser groups ------------------------------------

@pytest.mark.parametrize("warmup, cosine", [(60, True), (0, True), (60, False)])
def test_loop_lr_matches_traced_lr(warmup, cosine):
    """The loop's per-step rate against ``_traced_lr``, which computes in f32:
    within 1e-6 of the base rate."""
    total, base, lr_min = 600, 0.004, 1e-7
    steps = np.arange(0, total + 50)
    want = np.asarray(jax.jit(jax_scan_loop._traced_lr, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(steps), base, warmup, total, cosine, lr_min))
    got = np.array([schedules.lr_for_step(int(s), base, warmup, total, cosine, lr_min)
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * base)


def test_schedules_and_plateau_match_jax():
    """schedule_for_step within 1e-6 of the base rate (JAX's cosine is f32);
    the plateau states equal."""
    for step in range(0, 700, 7):
        for cosine in (True, False):
            args = (step, 60, 600, cosine, 0.004, 0.001, 1e-7)
            np.testing.assert_allclose(schedules.schedule_for_step(*args),
                                       jax_schedules.schedule_for_step(*args), rtol=0,
                                       atol=1e-6 * 0.004)
    accs = [0.1, 0.2, 0.2, 0.15, 0.19, 0.3, 0.3, 0.3, 0.3, 0.3, 0.29]
    got = schedules.PlateauState(0.004, 0.001, 0, -np.inf)
    want = jax_schedules.PlateauState(0.004, 0.001, 0, -np.inf)
    for acc in accs:
        got = schedules.reduce_lr_on_plateau(got, acc, factor=0.5, patience=2, lr_min=1e-4)
        want = jax_schedules.reduce_lr_on_plateau(want, acc, factor=0.5, patience=2, lr_min=1e-4)
        assert tuple(got) == tuple(want)


def _optax_membership(params, ssm_vars):
    """{flax leaf path: group} read off the masks optax builds."""
    tx = _grouped_tx(ssm_vars, 1e-3, 1e-3, 0.01, (0.9, 0.999))
    inner = tx.init(params).inner_states
    out = {}
    for group in ("ssm", "regular"):
        mu = inner[group].inner_state.inner_state[0].mu
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                mu, is_leaf=lambda x: type(x).__name__ == "MaskedNode")[0]:
            if type(leaf).__name__ != "MaskedNode":
                out[tuple(k.key for k in path)] = group
    return out


@pytest.mark.parametrize("ssm_vars", [None, ["nu_log", "theta_log", "gamma_log", "B_re"]],
                         ids=["config", "lru_names"])
def test_param_groups_match_optax_labels(ssm_vars):
    """The config's ``ssm_lr_vars`` name no LRU leaf, so every parameter is
    ``regular`` in both packages; with LRU leaf names the groups split."""
    cfg = small_config()["model"]
    ssm_vars = cfg["ssm_lr_vars"] if ssm_vars is None else ssm_vars
    _, params, stats = jax_weights(cfg)
    model, _, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    want = _optax_membership(params, ssm_vars)
    got = {}
    for group, members in param_groups(model, ssm_vars).items():
        tree, _ = params_to_jax({name: p for name, p in members})
        for path, _leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            got[tuple(k.key for k in path)] = group
    assert got == want
    assert set(want.values()) == ({"regular"} if ssm_vars == cfg["ssm_lr_vars"]
                                  else {"ssm", "regular"})
    opt = make_optimizer(model, ssm_vars, 0.004, 0.001, 0.01, (0.9, 0.999))
    decay = {g["name"]: g["weight_decay"] for g in opt.param_groups}
    assert decay.get("regular") == 0.01 and decay.get("ssm", 0.0) == 0.0


# -- loss, accuracy, sparse head, batch order ---------------------------------

def _labelled_logits(seed, shape=(4, 24), vocab=40):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (vocab,)) * 3).astype(np.float32)
    labels = np.where(rng.random(shape) < 0.7, -100, rng.integers(0, vocab, shape))
    hit = (labels >= 0) & (rng.random(shape) < 0.5)
    logits[hit, labels[hit]] = 20.0
    return logits, labels


def test_cross_entropy_and_accuracy_match_jax():
    """Masked mean CE and accuracy over −100 labels (1e-6 relative)."""
    logits, labels = _labelled_logits(0)
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    want = float(jax.jit(jax_ce)(jnp.asarray(logits), jnp.asarray(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    acc = float(compute_accuracy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert acc == pytest.approx(float(jax_accuracy(jnp.asarray(logits), jnp.asarray(labels))),
                                abs=1e-7)
    none = np.full_like(labels, -100)  # no valid position: 0, not NaN
    assert float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("kv, length", [(8, 64), (4, 32), (16, 64)])
def test_sparse_head_k_and_positions_match_jax(kv, length):
    data = MQAR(input_seq_length=length, num_kv_pairs=kv, vocab_size=256,
                num_train_examples=64, num_test_examples=32)
    (_, ytr), (_, yte) = data.split("train"), data.split("test")
    cfg = small_config()["model"]
    k = sparse_head_k_for(cfg, ytr, yte)
    assert k == jax_scan_loop.sparse_head_k_for(cfg, ytr, yte)
    assert sparse_head_k_for(dict(cfg, pooling="mean"), ytr) is None
    if k is None:
        return
    valid = (yte != -100).astype(np.int32)
    _, want = jax.jit(lax.top_k, static_argnums=1)(jnp.asarray(valid), k)
    np.testing.assert_array_equal(sparse_positions(torch.from_numpy(yte), k).numpy(),
                                  np.asarray(want))


def test_sparse_loss_equals_dense_loss():
    cfg = dict(small_config()["model"], dropout=0.0)
    model, _, _ = build_models(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    data = MQAR(input_seq_length=64, num_kv_pairs=8, vocab_size=256, num_train_examples=8)
    x, y = (torch.from_numpy(a) for a in data.split("train"))
    k = sparse_head_k_for(cfg, y.numpy())
    state = {n: t.clone() for n, t in model.state_dict().items()}
    sparse = cross_entropy_loss(*head_logits(model, x, y, k))
    g_sparse = torch.autograd.grad(sparse, list(model.parameters()))
    model.load_state_dict(state)
    dense = cross_entropy_loss(*head_logits(model, x, y, None))
    g_dense = torch.autograd.grad(dense, list(model.parameters()))
    assert float(sparse.detach()) == pytest.approx(float(dense.detach()), rel=1e-6)
    for a, b in zip(g_sparse, g_dense):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_batch_and_eval_indices_are_byte_equal():
    got = batch_indices(np.random.default_rng(7), 100, 32, 9)
    want = jax_scan_loop.batch_indices(np.random.default_rng(7), 100, 32, 9)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # 3000 test examples in batches of 64: 46 batches, the last 56 dropped
    idx = eval_indices(3000, 64)
    assert idx.shape == (46, 64) and idx.tobytes() == jax_scan_loop.eval_indices(3000, 64).tobytes()


# -- whole steps from identical weights ---------------------------------------

N_STEPS = 5


@pytest.fixture(scope="module")
def step_setup():
    """The small MQAR config at dropout 0, JAX weights with moved BatchNorm
    statistics, a train split, K for the sparse head and 5 batches."""
    cfg = small_config()
    model_cfg = dict(cfg["model"], dropout=0.0)
    _, params, stats = jax_weights(model_cfg, seed=0, stats_seed=1)
    data = MQAR(**dict(cfg["dataset"], num_train_examples=256, num_test_examples=64))
    train, test = data.split("train"), data.split("test")
    k = sparse_head_k_for(model_cfg, train[1], test[1])
    idx = batch_indices(np.random.default_rng(cfg["seed"]), 256, cfg["train"]["batch_size"],
                        N_STEPS)
    return cfg, model_cfg, params, stats, train, test, k, idx


def _jax_sparse_loss(model, k):
    """tlie_tpu's sparse loss, as ``make_train_block`` builds it
    (scan_loop.py:222-250)."""
    def loss(params, batch_stats, x, y):
        feats, updates = model.apply({"params": params, "batch_stats": batch_stats}, x,
                                     mutable=["batch_stats"], method=type(model).features)
        _, pos = lax.top_k((y != -100).astype(jnp.int32), k)
        f_sel = jnp.take_along_axis(feats, pos[..., None], axis=1)
        y_sel = jnp.take_along_axis(y, pos, axis=1)
        logits = f_sel @ params["decoder"]["kernel"] + params["decoder"]["bias"]
        return jax_ce(logits, y_sel), updates
    return loss


def _port_train_model(model_cfg, params, stats):
    model, eval_model, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(0),
                                        device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model, eval_model


def test_one_step_gradients_match_jax(step_setup):
    """Gradients of the sparse loss on one batch, per leaf within 1e-4 of
    that leaf's max|g| (f32; the scans and matmuls sum in other orders)."""
    cfg, model_cfg, params, stats, train, _, k, idx = step_setup
    jmodel, _, _ = jax_build_models(model_cfg, padded=False)
    x, y = train[0][idx[0]], train[1][idx[0]]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(_jax_sparse_loss(jmodel, k), has_aux=True))(
        params, stats, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32))

    model, _ = _port_train_model(model_cfg, params, stats)
    loss = cross_entropy_loss(*head_logits(model, torch.from_numpy(x), torch.from_numpy(y), k))
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(want))
    for (path, g), w in pairs:
        scale = np.abs(w).max()
        assert scale > 0, path
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale, err_msg=str(path))


def test_five_steps_match_make_train_block(step_setup):
    """Params and batch_stats after 5 steps on the same batches, learning
    rates from the loop's schedule.  The five steps move a parameter by up
    to Σ lr = 1e-3.  Adam divides each gradient element by its own
    magnitude (|g| + 1e-8 on the first step), so an element whose gradient
    is near the rounding floor (the gradients agree to 1e-4 of their leaf's
    max) may take another direction in each package.  So: 2e-6 absolute
    where the first step's |g| is at least 1e-2 of its leaf's max (over 90 %
    of the elements), and within the movement bound 2·Σ lr + 2e-6
    everywhere; 1e-5 on the statistics."""
    cfg, model_cfg, params, stats, train, test, k, idx = step_setup
    tc = cfg["train"]
    jmodel, _, _ = jax_build_models(model_cfg, padded=False)
    state, _ = create_train_state(
        jmodel, jax.random.PRNGKey(0), in_dim=model_cfg["input_dim"], batch_size=2,
        seq_len=model_cfg["seq_len"], weight_decay=tc["wd"], norm="batch",
        ssm_lr=tc["ssm_lr"], ssm_vars=model_cfg["ssm_lr_vars"], lr=tc["lr"], padded=False,
        betas=(0.9, 0.999), integer_inputs=True)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    block = jax_scan_loop.make_train_block(
        jmodel, "batch", tuple(sorted(state.opt_state.inner_states)), tc["warmup_steps"],
        tc["total_steps"], tc["cosine_anneal"], tc["lr_min"], sparse_head_k=k)
    data = jax_scan_loop.put_dataset(*train)
    jstate, jloss = block(state, jax.random.PRNGKey(1), data, idx, 0, tc["lr"], tc["ssm_lr"])

    model, eval_model = _port_train_model(model_cfg, params, stats)
    opt = make_optimizer(model, model_cfg["ssm_lr_vars"], tc["lr"], tc["ssm_lr"], tc["wd"],
                         (0.9, 0.999))
    pdata = put_dataset(*train, "cpu")
    losses, lr_sum, g0 = [], 0.0, None
    for s in range(N_STEPS):
        lrs = {g: schedules.lr_for_step(s, base, tc["warmup_steps"], tc["total_steps"],
                                        tc["cosine_anneal"], tc["lr_min"])
               for g, base in (("regular", tc["lr"]), ("ssm", tc["ssm_lr"]))}
        i = torch.from_numpy(idx[s]).long()
        losses.append(float(train_step(model, opt, pdata.inputs[i], pdata.labels[i], lrs, k)))
        lr_sum += lrs["regular"]
        if g0 is None:
            g0, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert np.mean(losses) == pytest.approx(float(jloss), rel=1e-5)

    got_p, got_s = params_to_jax(model.state_dict())
    n_det = n_all = 0
    for (path, g), w, g_first in zip(jax.tree_util.tree_leaves_with_path(got_p),
                                     jax.tree_util.tree_leaves(to_numpy(jstate.params)),
                                     jax.tree_util.tree_leaves(g0)):
        err = np.abs(g - w)
        det = np.abs(g_first) >= 1e-2 * np.abs(g_first).max()
        assert err[det].max(initial=0.0) <= 2e-6, path
        assert err.max() <= 2 * lr_sum + 2e-6, path
        n_det, n_all = n_det + det.sum(), n_all + det.size
    assert n_det > 0.9 * n_all
    for g, w in zip(jax.tree_util.tree_leaves(got_s),
                    jax.tree_util.tree_leaves(to_numpy(jstate.batch_stats))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # the eval model sees the trained weights; its metric is the mean of
    # the per-batch accuracies
    loss, acc = evaluate(eval_model, put_dataset(*test, "cpu"),
                         torch.from_numpy(eval_indices(64, 32)).long(), k)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
