"""The port's pooled ListOps classifiers against tlie_tpu's on the CPU:
``masked_meanpool`` and the three poolings (``last`` refusing padded input),
the S5 and S4 ``ClassificationModel`` on a padded batch (logits in eval mode
and in training mode, with the BatchNorm statistics the step leaves), one
training step's gradients and AdamW update against ``train_step`` on
``create_train_state_s5`` / ``create_train_state``, the spectra of a small
ListOps S5 and S4 checkpoint through eval_eig, and the card run's paths 14
and 15 rehearsed.

Weights are drawn by JAX and carried with ``compat``; batches are made with
numpy from a seed, padded as ListOps pads them (each row's valid prefix,
then ``<pad>``, lengths as float32).  S4's weights carry every Δ at or
above 0.002, where tlie_tpu keeps the Nyquist frequency
(``tests/test_torch_s4.py``).  Tolerances are stated where they are used."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.models.backbone import masked_meanpool as jax_masked_meanpool
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training.state import create_train_state, create_train_state_s5
from tlie_tpu.training.steps import train_step as jax_train_step
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.binning import PHASE_THRESHOLDS, threshold_analysis_ssm
from tlie_tpu_torch.analysis.eval_eig import ssm_layer_params
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.config import LISTOPS_S4_FULL, LISTOPS_S5_FULL, train_fields
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models.backbone import masked_meanpool
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import Jitted, to_numpy

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")
# float32 on both sides, the same products and sums in other orders (the
# tolerances of tests/test_torch_s5.py and test_torch_s4.py)
FWD_RTOL_OF_MAX = 2e-5
GRAD_RTOL_OF_MAX = 2e-5
# one AdamW step from the same state: the parameters within float32 rounding
PARAM_ATOL = 1e-6
# spectra: exp(ΛΔ) and the eigenvalues of S4's Ā from the same weights
EIG_ATOL = 1e-5
S4_EIG_FACTOR = 4.0
DT_KEPT = 0.002
B, L = 3, 40


def tiny(full):
    """A ListOps config cut to 2 layers, d_model 16, state 16 (S5: 2
    blocks), L 40, batch 3."""
    cfg = copy.deepcopy(full)
    cfg["train"]["batch_size"] = B
    cfg["model"].update(num_layers=2, hidden_dim=16, state_dim=16, seq_len=L)
    if cfg["model"]["layer"] == "s5":
        cfg["model"]["num_blocks"] = 2
    return cfg


def padded_batch(seed=0, lengths=(40, 17, 1)):
    """Tokens (B, L) with each row's valid prefix drawn from the 18 ListOps
    ids and <pad> (0) after it, float32 lengths, labels of 10 classes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(2, 18, (B, L)).astype(np.int32)
    x[np.arange(L)[None, :] >= np.asarray(lengths)[:, None]] = 0
    return x, np.asarray(lengths, np.float32), rng.integers(0, 10, B).astype(np.int32)


def raise_steps(params):
    """Every layer's log_step raised to log DT_KEPT where it lies below."""
    for name, layer in params["encoder"].items():
        if name.startswith("layers_"):
            ls = layer["seq"]["log_step"]
            layer["seq"]["log_step"] = np.maximum(ls, np.log(DT_KEPT)).astype(np.float32)
    return params


def jax_pair(mc, pooling="mean", padded=True):
    """tlie_tpu's (train model, eval model) for ``mc`` and weights drawn by
    its init, BatchNorm statistics drawn away from (0, 1)."""
    mc = dict(mc, pooling=pooling)
    jtrain, jeval, _ = jax_build_models(mc, padded)
    x, lengths, _ = padded_batch()
    variables = jax.jit(jeval.init)(jax.random.PRNGKey(3), (x, lengths) if padded else x)
    params = to_numpy(variables["params"])
    if mc["layer"] == "s4":
        params = raise_steps(params)
    stats = to_numpy(variables["batch_stats"])
    rng = np.random.default_rng(1)
    for layer in stats["encoder"].values():
        st = layer["normalize"]
        st["mean"] = rng.normal(0.0, 0.3, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    return jtrain, jeval, params, stats


def port_pair(mc, params, stats, pooling="mean", padded=True):
    model, eval_model, _ = build_models(dict(mc, pooling=pooling), padded,
                                        generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model, eval_model


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def abar64(lp, idx, seq_len):
    """Channel ``idx``'s discretised DPLR Ā in float64, as ``eig_s4`` forms
    it in float32."""
    from tlie_tpu_torch.analysis.extractors import _complex_param
    from tlie_tpu_torch.models.s4 import discrete_dplr

    f64 = torch.float64
    step = torch.exp(lp["log_step"].to(f64)[0, idx])
    lam = torch.complex(lp["Lambda_re"].to(f64)[:, idx].clamp(max=-1e-4),
                        lp["Lambda_im"].to(f64)[:, idx])
    p, b, c = (_complex_param(lp[k])[:, idx].to(torch.complex128) for k in ("P", "B", "C"))
    return discrete_dplr(lam, p, p, b, c, step, seq_len)[0].numpy()


def port_input(x, lengths):
    return torch.from_numpy(x).long(), torch.from_numpy(lengths)


FAMILIES = [pytest.param(LISTOPS_S5_FULL, id="s5"), pytest.param(LISTOPS_S4_FULL, id="s4")]


# -- pooling --------------------------------------------------------------------------------

def test_masked_meanpool_matches_jax():
    """The mean over each row's valid prefix, divided by the float32
    lengths, within 1e-6 of tlie_tpu's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 33, 8)).astype(np.float32)
    lengths = np.asarray([33, 1, 12, 20], np.float32)
    want = np.asarray(jax_masked_meanpool(x, lengths))
    got = masked_meanpool(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1], x[1, 0], rtol=0, atol=0)


@pytest.mark.parametrize("pooling, padded", [("mean", True), ("mean", False), ("last", False),
                                             ("none", False), ("none", True)])
def test_poolings_match_jax(pooling, padded):
    """The S5 classifier's eval-mode logits under each pooling, on padded
    (inputs, lengths) or plain inputs: (B, 10) pooled, (B, L, 10) for none."""
    mc = tiny(LISTOPS_S5_FULL)["model"]
    _, jeval, params, stats = jax_pair(mc, pooling, padded)
    _, model = port_pair(mc, params, stats, pooling, padded)
    x, lengths, _ = padded_batch()
    want = np.asarray(jax.jit(jeval.apply)({"params": params, "batch_stats": stats},
                                           (x, lengths) if padded else x))
    with torch.no_grad():
        got = model(port_input(x, lengths) if padded else torch.from_numpy(x).long()).numpy()
    assert got.shape == want.shape == ((B, 10) if pooling != "none" else (B, L, 10))
    assert rel_to_max(got, want) <= FWD_RTOL_OF_MAX


def test_last_pooling_refuses_padded_input():
    mc = dict(tiny(LISTOPS_S5_FULL)["model"], pooling="last")
    x, lengths, _ = padded_batch()
    _, jeval, _ = jax_build_models(mc, True)
    with pytest.raises(NotImplementedError, match="last"):
        jeval.init(jax.random.PRNGKey(0), (x, lengths))
    _, model, _ = build_models(mc, True, generator=torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="last"):
        model(port_input(x, lengths))


def test_padded_inputs_refused_outside_the_ssm_families():
    """Padded input outside the SSM families is ported: the Mamba and
    transformer families build with ``padded`` and take ``(tokens,
    lengths)``, dropping the lengths (their parity with tlie_tpu is in
    tests/test_torch_transformer_classifier.py and
    tests/test_torch_mamba2_padded.py); so is the dual head, whose model
    takes pairs of them (tests/test_torch_aan_dual.py): the padded batch's
    rows as (B, 2, L) pairs give (B, classes) logits, the lengths dropped."""
    from tlie_tpu_torch.config import MQAR_MAMBA2_FULL, MQAR_SM_ATTENTION_FULL

    x, lengths, _ = padded_batch()
    for mc in (dict(MQAR_SM_ATTENTION_FULL["model"], vocab_size=18, output_dim=10,
                    hidden_dim=16, state_dim=16, max_pos_embed=40, seq_len=40),
               dict(MQAR_MAMBA2_FULL["model"], vocab_size=18, output_dim=10, hidden_dim=16,
                    state_dim=8, seq_len=40, pooling="mean", chunk_size=8)):
        _, model, _ = build_models(mc, True, generator=torch.Generator(), device="cpu")
        with torch.no_grad():
            padded = model(port_input(x, lengths))
            torch.testing.assert_close(padded, model(torch.from_numpy(x).long()), rtol=0, atol=0)
        dcfg = dict(mc, dual=True, classifier=True, mixer_dim=8)
        _, dual, _ = build_models(dcfg, True, generator=torch.Generator(), device="cpu")
        pairs = torch.from_numpy(x[: len(x) // 2 * 2]).long().reshape(-1, 2, x.shape[1])
        with torch.no_grad():
            out = dual((pairs, torch.from_numpy(lengths[: len(pairs)]).float()))
            torch.testing.assert_close(out, dual(pairs), rtol=0, atol=0)
        assert out.shape == (len(pairs), 10)


# -- the classifiers -------------------------------------------------------------------------------

@pytest.mark.parametrize("full", FAMILIES)
def test_classifier_logits_match_jax_in_both_modes(full):
    """Eval mode (running statistics) and training mode (the batch's
    statistics over every position, padding included, as tlie_tpu takes
    them): the logits within 2e-5 of their max, and the running statistics
    the training-mode forward leaves within 1e-6."""
    mc = tiny(full)["model"]
    jtrain, jeval, params, stats = jax_pair(mc)
    model, eval_model = port_pair(mc, params, stats)
    x, lengths, _ = padded_batch(seed=4)
    variables = {"params": params, "batch_stats": stats}
    want_eval = np.asarray(jax.jit(jeval.apply)(variables, (x, lengths)))
    want_train, updates = jax.jit(lambda v, xx: jtrain.apply(v, xx, mutable=["batch_stats"]))(
        variables, (x, lengths))
    with torch.no_grad():
        got_eval = eval_model(port_input(x, lengths)).numpy()
        got_train = model(port_input(x, lengths)).numpy()
    assert rel_to_max(got_eval, want_eval) <= FWD_RTOL_OF_MAX
    assert rel_to_max(got_train, np.asarray(want_train)) <= FWD_RTOL_OF_MAX
    want_stats = params_from_jax(params, to_numpy(updates["batch_stats"]))
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("full", FAMILIES)
def test_one_training_step_matches_jax(full):
    """One step of tlie_tpu's ``train_step`` on the family's state
    (``create_train_state_s5`` or ``create_train_state``: the ssm group on
    Adam at ssm_lr, the rest on AdamW) against the port's ``train_step`` on
    its optimiser: every gradient within 2e-5 of its leaf's max, every
    parameter after the update within 1e-6, the BatchNorm statistics within
    1e-6, the loss within 1e-6 relative.  S4's log_step gradient is held to
    the port's float64 one instead; its update (Adam's first step moves by
    about ssm_lr in the gradient's sign) to tlie_tpu's all the same."""
    cfg = tiny(full)
    mc, tc = cfg["model"], cfg["train"]
    jtrain, _, _, _ = jax_pair(mc)
    factory = create_train_state_s5 if mc["layer"] == "s5" else create_train_state
    state, _ = factory(Jitted(jtrain), jax.random.PRNGKey(0), mc["input_dim"], B, L, tc["wd"],
                       "batch", tc["ssm_lr"], mc["ssm_lr_vars"], tc["lr"], True,
                       (0.9, 0.999), integer_inputs=True)
    if mc["layer"] == "s4":
        state = state.replace(params=raise_steps(to_numpy(state.params)))
    params, stats = to_numpy(state.params), to_numpy(state.batch_stats)
    x, lengths, y = padded_batch(seed=7)
    lrs = {"regular": tc["lr"], "ssm": tc["ssm_lr"]}

    def loss(p):
        logits, _ = jtrain.apply({"params": p, "batch_stats": stats}, (x, lengths),
                                 mutable=["batch_stats"])
        lse = jax.nn.logsumexp(logits, -1)
        return jnp.mean(lse - jnp.take_along_axis(logits, y[:, None], -1)[:, 0])

    want_g = params_from_jax(to_numpy(jax.jit(jax.grad(loss))(params)))
    new_state, want_loss = jax_train_step(state, jax.random.PRNGKey(1), (x, lengths), y,
                                          {k: jnp.float32(v) for k, v in lrs.items()}, jtrain,
                                          "batch")
    want = params_from_jax(to_numpy(new_state.params), to_numpy(new_state.batch_stats))

    model, _ = port_pair(mc, params, stats)
    if mc["layer"] == "s4":
        # S4's log_step gradient against the port's own in float64:
        # tlie_tpu's drops its Nyquist term (tests/test_torch_s4.py)
        # and its update to Adam's first step on that gradient (ssm group, no
        # decay): tlie_tpu's moves differently where its gradient is small
        m64 = copy.deepcopy(model).double()
        cross_entropy_loss(m64(port_input(x, lengths)), torch.from_numpy(y).long()).backward()
        for name, p in m64.named_parameters():
            if name.endswith("log_step"):
                want_g[name] = p.grad
                want[name] = (p.detach() - lrs["ssm"] * p.grad / (p.grad.abs() + 1e-8)).float()
    cfg["train"].update(padded=True, train_size=96)
    opt, clip = make_family_optimizer(model, mc["layer"], mc, tc, train_fields(cfg))
    got_loss = train_step(model, opt, port_input(x, lengths), torch.from_numpy(y).long(), lrs,
                          clip_norm=clip)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)
    for name, p in model.named_parameters():
        assert rel_to_max(p.grad, want_g[name]) <= GRAD_RTOL_OF_MAX, name
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


# -- spectra --------------------------------------------------------------------------------------

@pytest.mark.parametrize("full", FAMILIES)
def test_eval_eig_of_a_listops_checkpoint_matches_jax(full, tmp_path):
    """A small ListOps checkpoint written by the port, eigen-analysed from
    its file: S5's trained spectra within 1e-5 of tlie_tpu's from the same
    weights, S4's (at seq_len: 40 here, the config's 2048 at full size) as
    near the float64 Ā's eigenvalues as tlie_tpu's are; the radius bins
    equal to tlie_tpu's, the phase bins equal (S5) or apart from the float64
    spectrum's by no more than its eigenvalues near a bin edge (S4); the same
    artifact directory and files."""
    cfg = tiny(full)
    mc = cfg["model"]
    _, _, params, stats = jax_pair(mc)
    model, _ = port_pair(mc, params, stats)
    ckpt = save_checkpoint(str(tmp_path / "ckpt" / "listops"), model,
                           {"model": mc, "train": cfg["train"], "data": cfg["dataset"]})
    want = jax_eval_eig(cfg, {"save_path": str(tmp_path / "jax")}, None, cfg["dataset"], None,
                        "unused", 0.5, params=params)
    got = eval_eig(cfg, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu")
    n = mc["state_dim"] // 2 if mc["layer"] == "s5" else mc["state_dim"]
    assert got[0].shape == want[0].shape == (n, 2)
    if mc["layer"] == "s5":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=EIG_ATOL)
    else:
        # Ā's eigenvectors are far from orthogonal (condition number about
        # 1e6 here), so float32 rounding of Ā moves its eigenvalues by up to
        # about 1e-2 in either package: each is held to the eigenvalues of
        # the float64 Ā from the same weights, the port within S4_EIG_FACTOR
        # times tlie_tpu's own distance from them, or EIG_ATOL
        for layer, lp in enumerate(ssm_layer_params(torch.load(ckpt)["model"])):
            exact = np.linalg.eigvals(abar64(lp, 1, mc["seq_len"]))
            dist = [max(np.abs(exact - z).min() for z in ev[:, layer]) for ev in (got[0], want[0])]
            assert dist[0] <= max(S4_EIG_FACTOR * dist[1], EIG_ATOL), (layer, dist)
            # a phase bin may differ only by the eigenvalues whose exact
            # phase lies within that distance of a bin edge (0° included:
            # the near-real ones' imaginary parts are rounding)
            phase = np.angle(exact, deg=True)
            margin = np.degrees(max(dist) / np.abs(exact))
            edges = np.concatenate([[0.0], PHASE_THRESHOLDS])
            near = int((np.abs(phase[:, None] - edges[None, :]).min(1) <= margin).sum())
            for ev in (got[0], want[0]):
                counts = np.abs(threshold_analysis_ssm(np.angle(ev[:, layer:layer + 1], deg=True),
                                                       PHASE_THRESHOLDS)
                                - threshold_analysis_ssm(phase[:, None], PHASE_THRESHOLDS))
                assert np.round(counts * n / 100).max() <= near, (layer, near)
    np.testing.assert_array_equal(got[2], want[2])
    if mc["layer"] == "s5":
        np.testing.assert_array_equal(got[4], want[4])
    (jrun,), (prun,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    assert jrun == prun and prun.startswith("LISTOPSdmodel16")
    assert sorted(os.listdir(tmp_path / "jax" / jrun)) == sorted(
        os.listdir(tmp_path / "port" / prun))


# -- the card run's paths 14 and 15, rehearsed --------------------------------------------------------

@pytest.mark.parametrize("full, tag", [(LISTOPS_S5_FULL, "listops_s5"),
                                       (LISTOPS_S4_FULL, "listops_s4")], ids=["s5", "s4"])
def test_chip_smoke_paths_14_and_15_run_on_the_cpu(monkeypatch, tmp_path, full, tag):
    """``chip_smoke.listops_path`` at a tiny size on the CPU (2 layers, d_model
    and state 16, L 64, batch 8, 64 train and 16 test examples of 8-60
    tokens, 3 epochs of 8 steps, a snapshot at step 16), the card's timers
    and profiler stubbed and counting plain versions in place of the scan
    kernels: data, forward, training, the checkpoint's spectra, the resume
    against the uninterrupted run, the card step against float64, and the
    launch counts (S5: two forward and two backward scans a step; S4:
    none)."""
    from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
    for name, value in dict(LISTOPS_TRAIN=64, LISTOPS_TEST=16, LISTOPS_SNAPSHOT=16,
                            LISTOPS_STEP_EXAMPLES=4).items():
        monkeypatch.setattr(cs, name, value)
    cut = copy.deepcopy(full)
    cut["dataset"].update(l_max=64, min_length=8, max_length=60, data_dir=str(tmp_path))
    cut["train"]["batch_size"] = 8
    cut["model"].update(seq_len=64, hidden_dim=16, state_dim=16, num_layers=2)
    if full["model"]["layer"] == "s5":
        cut["model"]["num_blocks"] = 2
    launches, s5_times = cs.listops_path(torch.device("cpu"), ARTIFACT_FILES, cut, tag)
    steps = 3 * (64 // 8)
    if full["model"]["layer"] == "s5":
        assert s5_times is not None
        assert launches["diag_scan_bwd"] == 2 * (steps + steps - 16)  # the run, then the resume
        assert launches["diag_scan"] >= 2 * steps
    else:
        assert s5_times is None and not any(launches.values())
    assert os.listdir(tmp_path) == []  # the generated split was not cached
