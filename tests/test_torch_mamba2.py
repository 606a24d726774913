"""The port's Mamba-2 family against tlie_tpu's: the layers, the SSD core and
the block through weights carried by ``params_from_jax``, the full model's
logits and gradients and one AdamW + global-norm-clip step on
``configs/mqar-mamba2-small.yaml``, the key names against
``tlie_tpu/analysis/compat.py``, eval_eig's artifacts from one port
checkpoint, and ``launch`` end to end on the CPU.

Inputs are made with numpy from a seed; JAX runs jitted at HIGHEST matmul
precision (tests/conftest.py).  Parity runs at dropout 0 (the dropout streams
cannot match).  Tolerances are stated where they are used.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tlie_tpu.analysis import binning as jax_binning
from tlie_tpu.analysis.artifacts import write_percentage_file as jax_write_percentage_file
from tlie_tpu.analysis.compat import torch_state_dict_to_flax
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.analysis.extractors import eig_mamba2 as jax_eig_mamba2
from tlie_tpu.config import load_experiment
from tlie_tpu.data.mqar import MQAR as JaxMQAR
from tlie_tpu.models import layers as jax_layers
from tlie_tpu.models import mamba2 as jax_mamba2
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu.training.state import create_train_state_adamw
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.artifacts import write_percentage_file
from tlie_tpu_torch.analysis.binning import RADIUS_THRESHOLDS, threshold_analysis
from tlie_tpu_torch.analysis.extractors import eig_mamba2
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import MQAR_MAMBA2_FULL, load_yaml
from tlie_tpu_torch.data import MQAR
from tlie_tpu_torch.models import Mamba, build_models
from tlie_tpu_torch.models.layers import GLU, DepthwiseCausalConv, TokenEmbeddings
from tlie_tpu_torch.models.mamba2 import SSD, MambaBlock
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training import schedules
from tlie_tpu_torch.training.scan_loop import batch_indices, put_dataset, sparse_head_k_for
from tlie_tpu_torch.training.state import (
    clip_by_global_norm_, make_family_optimizer, param_groups,
)
from tlie_tpu_torch.training.steps import head_logits
from torch_parity import to_numpy

torch.set_num_threads(1)

SMALL_YAML = "configs/mqar-mamba2-small.yaml"
FULL_YAML = "configs/tasks/mqar/mqar-mamba2.yaml"


def small_config():
    cfg = load_experiment(SMALL_YAML).raw
    cfg["model"]["seq_len"] = cfg["dataset"]["input_seq_length"]
    return cfg


def _jax_init(module, *inputs, seed=0):
    return to_numpy(jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)["params"])


def _sub(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


# -- layers -------------------------------------------------------------------

def test_glu_embeddings_and_conv_match_flax():
    """GLU, TokenEmbeddings and DepthwiseCausalConv through weights carried by
    params_from_jax (1e-6 absolute: short f32 sums)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 12)).astype(np.int32)

    glu_p = _jax_init(jax_layers.GLU(), x)
    glu = GLU(16, torch.Generator())
    glu.load_state_dict(_sub(params_from_jax({"blocks_0": {"glu_layer": glu_p}}), "blocks.0.glu."))
    want = np.asarray(jax.jit(jax_layers.GLU().apply)({"params": glu_p}, x))
    np.testing.assert_allclose(glu(torch.from_numpy(x)).detach().numpy(), want, rtol=0, atol=1e-6)

    emb_p = _jax_init(jax_layers.TokenEmbeddings(16, 50), ids)
    emb = TokenEmbeddings(16, 50, torch.Generator())
    emb.load_state_dict(_sub(params_from_jax({"encoder": emb_p}), "encoder."))
    want = np.asarray(jax.jit(jax_layers.TokenEmbeddings(16, 50).apply)({"params": emb_p}, ids))
    np.testing.assert_array_equal(emb(torch.from_numpy(ids).long()).detach().numpy(), want)

    conv_m = jax_layers.DepthwiseCausalConv(16, 4)
    conv_p = _jax_init(conv_m, x)
    conv = DepthwiseCausalConv(16, 4, torch.Generator())
    conv.load_state_dict(_sub(params_from_jax({"blocks_0": {"mamba": {"conv1d": conv_p}}}),
                              "blocks.0.mamba.conv1d."))
    assert conv.weight.shape == (16, 1, 4)
    want = np.asarray(jax.jit(conv_m.apply)({"params": conv_p}, x))
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(), want, rtol=0, atol=1e-6)


_SSD_CASES = {
    "mqar_like": dict(d_state=16, headdim=32, ngroups=1),
    "heads_groups_chunks": dict(d_state=8, headdim=8, ngroups=2, chunk_size=8),
    "init_states_dt_limit": dict(d_state=8, headdim=16, learnable_init_states=True,
                                 dt_limit=(0.01, 0.05), chunk_size=16),
}


@pytest.mark.parametrize("case", sorted(_SSD_CASES))
def test_ssd_core_matches_flax(case):
    """The SSD core (in_proj, softplus dt, conv + SiLU, chunked scan with D,
    out_proj) against flax's, 2e-5 of max|y| (f32, other summation orders).
    learnable_init_states is drawn away from its zero init so that it works."""
    kw = _SSD_CASES[case]
    x = np.random.default_rng(1).standard_normal((2, 32, 32)).astype(np.float32)
    jm = jax_mamba2.SSD(d_model=32, **kw)
    p = _jax_init(jm, x)
    if "init_states" in p:
        p["init_states"] = np.random.default_rng(2).standard_normal(
            p["init_states"].shape).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, x))
    port = SSD(32, torch.Generator(), **kw)
    port.load_state_dict(_sub(params_from_jax({"blocks_0": {"mamba": p}}), "blocks.0.mamba."))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_ssd_init_draws_the_reference_distributions():
    """The port's init against its distributions, as flax's draws them:
    softplus(dt_bias) log-uniform in [dt_min, dt_max]; A = exp(A_log) in
    [1, 16]; D ones; in_proj U(±1/√d_model); conv U(±1/√K)."""
    port = SSD(64, torch.Generator().manual_seed(3), d_state=16, headdim=2)  # 32 heads
    dt = torch.nn.functional.softplus(port.dt_bias.detach())
    assert 1e-3 - 1e-7 <= dt.min() and dt.max() <= 0.1 + 1e-7
    assert torch.log(dt).std() > 0.5  # spread over the two decades, not at one end
    A = torch.exp(port.A_log.detach())
    assert 1.0 <= A.min() and A.max() <= 16.0 and A.std() > 2.0
    assert torch.equal(port.D.detach(), torch.ones(32))
    assert port.in_proj.weight.abs().max() <= 1 / 8 and port.in_proj.weight.abs().max() > 0.12
    assert port.conv1d.weight.abs().max() <= 0.5
    jp = _jax_init(jax_mamba2.SSD(d_model=64, d_state=16, headdim=2),
                   np.zeros((1, 8, 64), np.float32))
    jdt = np.log1p(np.exp(jp["dt_bias"]))
    assert 1e-3 - 1e-7 <= jdt.min() and jdt.max() <= 0.1 + 1e-7


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The small config at dropout 0, JAX weights, the port model carrying
    them, and an MQAR split with K for the sparse head."""
    cfg = small_config()
    model_cfg = dict(cfg["model"], dropout=0.0)
    _, jeval, _ = jax_build_models(model_cfg, padded=False)
    params = _jax_init(jeval, np.zeros((1, model_cfg["seq_len"]), np.int32))
    data = MQAR(**dict(cfg["dataset"], num_train_examples=128, num_test_examples=64))
    train, test = data.split("train"), data.split("test")
    k = sparse_head_k_for(model_cfg, train[1], test[1])
    return cfg, model_cfg, jeval, params, train, test, k


def _port(model_cfg, params):
    model, eval_model, family = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    assert family == "mamba" and isinstance(model, Mamba)
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


def test_logits_match_jax(small):
    """The eval forward on 4 test examples, 2e-5 of max|logit|."""
    _, model_cfg, jeval, params, _, test, _ = small
    x = test[0][:4]
    want = np.asarray(jax.jit(jeval.apply)({"params": params}, x.astype(np.int32)))
    _, model = _port(model_cfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def _jax_sparse_loss(model, k):
    def loss(params, x, y):
        feats = model.apply({"params": params}, x, method=type(model).features)
        _, pos = jax.lax.top_k((y != -100).astype(jnp.int32), k)
        f_sel = jnp.take_along_axis(feats, pos[..., None], axis=1)
        y_sel = jnp.take_along_axis(y, pos, axis=1)
        logits = f_sel @ params["decoder"]["kernel"] + params["decoder"]["bias"]
        return jax_scan_loop.cross_entropy_loss(logits, y_sel)
    return loss


def test_every_gradient_matches_jax(small):
    """The sparse-head loss (1e-5 relative) and the gradient of every leaf,
    within 1e-4 of that leaf's max|g| (f32 sums in other orders)."""
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
    """Two AdamW steps behind optax's global-norm clip at the config's rate
    (warmup rates from the loop's schedule) against ``make_train_block``:
    the mean loss (1e-5 relative), and the parameters 2e-6 absolute where
    both steps' |g| are at least 1e-2 of their leaf's max or the gradient is
    exactly 0 (the embedding rows of tokens the batches do not hold: weight
    decay alone moves them), within the movement bound 2·Σ lr + 2e-6
    everywhere (Adam divides each element by its own magnitude, so where a
    gradient is near the rounding floor the packages may step apart; see
    tests/test_torch_training.py).  Over 40 % of the elements with a
    gradient are held to the 2e-6.  At the init weights the raw gradient
    norm is about 0.5 and the clip leaves it; with the decoder scaled by 30
    (both packages get the same weights) it is above 1 at both steps, so the
    clip scales each step by its own factor, which the second Adam step
    sees."""
    cfg, model_cfg, _, params, train, _, k = small
    params = copy.deepcopy(params)
    params["decoder"]["kernel"] = params["decoder"]["kernel"] * decoder_scale
    tc = cfg["train"]
    lr = tc["lr"]
    n_steps = 2
    jmodel, _, _ = jax_build_models(model_cfg, padded=False)
    state, _ = create_train_state_adamw(
        jmodel, jax.random.PRNGKey(0), in_dim=model_cfg["input_dim"], batch_size=2,
        seq_len=model_cfg["seq_len"], weight_decay=tc["wd"], lr=lr, betas=(0.9, 0.999),
        integer_inputs=True, param_group=None)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    groups = tuple(sorted(state.opt_state.inner_states))
    assert groups == ("regular",)
    block = jax_scan_loop.make_train_block(jmodel, "layer", groups, tc["warmup_steps"],
                                           tc["total_steps"], tc["cosine_anneal"], 1e-6,
                                           sparse_head_k=k)
    idx = batch_indices(np.random.default_rng(0), len(train[0]), tc["batch_size"], n_steps)
    jstate, jloss = block(state, jax.random.PRNGKey(1), jax_scan_loop.put_dataset(*train), idx,
                          0, lr, lr)

    model, _ = _port(model_cfg, params)
    f = {"lr": lr, "ssm_lr": lr, "wd": tc["wd"], "betas": (0.9, 0.999)}
    opt, clip = make_family_optimizer(model, "mamba", model_cfg, tc, f)
    assert clip == 1.0 and [g["name"] for g in opt.param_groups] == ["regular"]
    data = put_dataset(*train, "cpu")
    losses, lr_sum, gs = [], 0.0, []
    for s in range(n_steps):
        rate = schedules.lr_for_step(s, lr, tc["warmup_steps"], tc["total_steps"],
                                     tc["cosine_anneal"], 1e-6)
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
    # after the clip the gradients (left in .grad) have norm 1 exactly where
    # the raw norm was above 1
    for g in gs:
        norm = np.sqrt(sum(float(np.sum(np.square(x))) for x in jax.tree_util.tree_leaves(g)))
        if decoder_scale > 1:
            assert norm == pytest.approx(1.0, rel=1e-5)
        else:
            assert norm < 0.9


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0], ids=["below", "near", "above"])
def test_clip_by_global_norm_is_optax(scale):
    """The in-place clip against ``optax.clip_by_global_norm(1.0)`` on the
    same gradients, 1e-7 relative; gradients below the norm are untouched."""
    rng = np.random.default_rng(int(scale * 100))
    grads = [rng.standard_normal(s).astype(np.float32) * scale / 10
             for s in ((5, 3), (7,), (2, 2, 2))]
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(ps, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_(ps, 1.0)
    tx = optax.clip_by_global_norm(1.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    for p, w, g in zip(ps, want, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-7, atol=0)
        if float(norm) < 1.0:
            np.testing.assert_array_equal(p.grad.numpy(), g)


def test_state_dict_keys_are_the_reference_names(small):
    """The port's state_dict converts through tlie_tpu's own
    ``torch_state_dict_to_flax(..., "mamba")`` to the tree params_to_jax
    gives and to flax's own tree; params_to_jax inverts params_from_jax
    exactly; param_groups names every leaf by its flax path."""
    _, model_cfg, _, params, _, _, _ = small
    model, _ = _port(model_cfg, params)
    sd = model.state_dict()
    assert "blocks.0.mamba.conv1d.weight" in sd and sd["blocks.0.mamba.conv1d.weight"].dim() == 3
    assert {"encoder.word_embeddings.weight", "blocks.1.glu.linear.weight", "blocks.1.norm.bias",
            "blocks.0.mamba.A_log", "decoder.weight"} <= set(sd)
    mine, stats = params_to_jax(sd)
    assert stats is None
    theirs = torch_state_dict_to_flax(sd, "mamba")
    for a, b, c in zip(jax.tree_util.tree_leaves_with_path(mine),
                       jax.tree_util.tree_leaves_with_path(theirs),
                       jax.tree_util.tree_leaves_with_path(params)):
        assert a[0] == b[0] == c[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[1])
    back = params_from_jax(mine)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    groups = param_groups(model, ["A_log", "dt_bias"])
    assert sorted(flax_path(n)[-1] for n, _ in groups["ssm"]) == ["A_log"] * 2 + ["dt_bias"] * 2


def test_registry_refuses_what_is_not_ported(small):
    _, model_cfg, _, _, _, _, _ = small
    g = torch.Generator()
    # bf16 Mamba-1 is ported (tests/test_torch_bf16_families.py)
    build_models(dict(model_cfg, version="mamba1", compute_dtype="bfloat16"), generator=g,
                 device="cpu")
    for bad, err in (({"version": "mamba3"}, RuntimeError),
                     ({"layer": "transformer", "compute_dtype": "float16"},
                      NotImplementedError)):
        with pytest.raises(err):
            build_models(dict(model_cfg, **bad), generator=g, device="cpu")
    # the dual MATCH head is ported (tests/test_torch_aan_dual.py)
    dual, _, _ = build_models(dict(model_cfg, dual=True), generator=g, device="cpu")
    assert {n for n in dual.state_dict() if n.startswith("match.")} == {
        f"match.{m}.{k}" for m in ("encoder", "middle", "decoder") for k in ("weight", "bias")}
    # train.param_group is ported (tests/test_torch_param_group.py): a group
    # beside the regular one, no longer a raise
    model, _, _ = build_models(model_cfg, generator=g, device="cpu")
    opt, _ = make_family_optimizer(model, "mamba", model_cfg, {"param_group": "A_log"},
                                   {"lr": 1e-3, "wd": 0.1, "betas": (0.9, 0.999)})
    assert [grp["name"] for grp in opt.param_groups] == ["regular", "group"]
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
    assert MQAR_MAMBA2_FULL == exp.raw
    assert load_yaml(FULL_YAML) == load_experiment(FULL_YAML).raw


# -- eigen-analysis -----------------------------------------------------------

def test_eig_mamba2_binning_and_report_match_jax(tmp_path):
    """The extractor (1e-6 relative), threshold_analysis (equal) and the
    percentage report (equal text) against tlie_tpu's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 10, 8)).astype(np.float32)
    W = rng.standard_normal((8, 8 + 2 * 2 * 3 + 2)).astype(np.float32) * 0.5
    dt_bias = rng.standard_normal(2).astype(np.float32)
    A_log = rng.standard_normal(2).astype(np.float32)
    want = np.asarray(jax.jit(jax_eig_mamba2, static_argnames=("d_inner", "ngroups", "d_state",
                                                                "nheads"))(
        x, W, None, dt_bias, A_log, d_inner=8, ngroups=2, d_state=3, nheads=2))
    got = eig_mamba2(torch.from_numpy(x), torch.from_numpy(W.T.copy()), None,
                     torch.from_numpy(dt_bias), torch.from_numpy(A_log), 8, 2, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    eta = np.concatenate([got[..., None], got[..., None] ** 3], axis=-1)  # (B, L, H, 2 layers)
    perc = threshold_analysis(eta, RADIUS_THRESHOLDS)
    np.testing.assert_array_equal(perc, jax_binning.threshold_analysis(eta, RADIUS_THRESHOLDS))
    args = (perc, perc / 2, perc.mean(1), perc.mean(1) / 2, perc.std(1), perc.std(1) / 2)
    write_percentage_file(str(tmp_path / "port.txt"), RADIUS_THRESHOLDS, *args)
    jax_write_percentage_file(str(tmp_path / "jax.txt"), RADIUS_THRESHOLDS, *args)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_eval_eig_artifacts_match_tlie_tpu(small, tmp_path):
    """From one port checkpoint (the small model after two large steps, so
    that dt_bias and A_log have moved), both packages write the same artifact
    set under the same name: the trained spectra within 1e-5, the trained
    percentages (radius, phase, mean, std) within 1e-5 and the report's
    trained lines equal.  The init spectra come from each package's own
    generator and are held to their shape and to the (0, 1] range of λ."""
    cfg, model_cfg, _, params, train, test, k = small
    args = copy.deepcopy(cfg)
    args["model"] = model_cfg
    model, _ = _port(model_cfg, params)
    opt, clip = make_family_optimizer(model, "mamba", model_cfg, cfg["train"],
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
    assert eig.shape == eig_init.shape == np.asarray(jax_out[0]).shape == (16, 64, 1, 2)
    assert eig.dtype == np.float32
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=0, atol=1e-5)
    assert np.all((eig_init > 0) & (eig_init <= 1))
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    for name in ("percentage_init", "percentage_init_mean"):
        assert (np.load(tmp_path / "port" / pdir / f"{name}.npy").shape
                == np.load(tmp_path / "jax" / jdir / f"{name}.npy").shape)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    saved = yaml.safe_load((tmp_path / "port" / pdir / "used_config.yaml").read_text())
    assert saved["model"]["layer"] == "mamba"
    with pytest.raises(ValueError, match="analysis batch"):
        eval_eig(args, {"save_path": str(tmp_path / "none")}, 0.5, ckpt, device="cpu")


def test_launch_trains_checkpoints_and_analyses_mamba2_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on a cut copy of the small config (20 steps, 2 evals,
    512 training examples): the checkpoint, the 12 artifacts, and spectra
    from the checkpoint equal to eig_mamba2 of the trained weights."""
    cfg = load_yaml(SMALL_YAML)
    cfg["save"] = str(tmp_path / "checkpoint" / "mqar-mamba2-small")
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
    assert len(files) == 12 and run.startswith("MQARdmodel64")
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, 64, 1, 2) and np.all((eig > 0) & (eig <= 1))
