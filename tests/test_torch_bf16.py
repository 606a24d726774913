"""bfloat16 mixed precision in the port (``model.compute_dtype: bfloat16``,
the Mamba family) against ``tlie_tpu``'s: the plain bfloat16 decay
attention (values and the three gradients) against the Pallas kernel of
``tlie_tpu/ops/pallas_ssd.py`` in interpret mode on bfloat16 inputs, and
against a float64 evaluation of the same rounding points; a 2-layer bf16
Mamba-2's log-probs against ``tlie_tpu``'s bf16 model on the same weights and
against the port's own float32 model; the float32 reduction of bf16 logits
against ``tlie_tpu``'s ``cross_entropy_loss``; eval_eig of a bf16 checkpoint
against the float32 extraction; training and ``launch`` on a cut of
``configs/wikitext-mamba2-short-bf16.yaml``; and the refusals that stay
(float16 for every family).

Inputs are made with numpy from a seed and rounded to bfloat16 once, so both
packages see the same values; JAX runs jitted at HIGHEST matmul precision
(tests/conftest.py).  Tolerances are stated where they are used.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.ops import pallas_ssd as jax_pallas_ssd
from tlie_tpu.training.steps import cross_entropy_loss as jax_cross_entropy_loss
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.config import ExperimentConfig, derive_runtime_fields, load_yaml
from tlie_tpu_torch.data import WikiText
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.ops import decay_attention as da
from tlie_tpu_torch.ops import ssd
from tlie_tpu_torch.training import save_checkpoint, train
from tlie_tpu_torch.training.steps import cross_entropy_loss
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF16_YAML = ROOT / "configs" / "wikitext-mamba2-short-bf16.yaml"
SSD_RTOL = 1e-5       # float32 sums in other orders, of the sum of the terms' magnitudes
BF16_STEP = 2.0 ** -7  # the widest spacing of bfloat16 values, relative to the value


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).bfloat16()


def _decay_inputs(BG, Q, N, Hg, P, seed):
    """C, B, xdt and a cotangent w in bfloat16, cs float32 (the within-chunk
    cumsum of dt·A, |cs| in the tens to hundreds)."""
    rng = np.random.default_rng(seed)
    C, B = (_bf16(rng.standard_normal((BG, Q, N))) for _ in range(2))
    dt = rng.uniform(0.0, 0.1, (BG, Hg, Q))
    A = -rng.uniform(1.0, 16.0, (1, Hg, 1))
    cs = torch.from_numpy(np.cumsum(dt * A, axis=-1).astype(np.float32))
    x, w = (_bf16(rng.standard_normal((BG, Hg, Q, P))) for _ in range(2))
    return C, B, cs, x, w


def _bf16_tol(want: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The tolerance of a bfloat16 output: the float32 one, plus one
    bfloat16 step of (|value| + the sum of its terms' magnitudes), for a sum
    (or a score inside it) that the two sides round to neighbouring
    bfloat16 values."""
    return SSD_RTOL * scale + BF16_STEP * (want.float().abs() + scale) + 1e-30


def _np(t):
    return np.asarray(t).astype(np.float32)


@pytest.mark.parametrize("Hg", [1, 2], ids=["Hg1", "Hg2"])
def test_plain_bf16_decay_attention_matches_pallas_kernel(Hg, monkeypatch):
    """y, dC, dB, dcs and dxdt of the plain bfloat16 version (the port's
    CPU path, through ``decay_attention``'s autograd) against
    ``tlie_tpu``'s Pallas kernel in interpret mode on the same bfloat16
    inputs, at the smallest shape its gate takes (Q 128, N 128, P 64), two
    groups.  Both round the scores and dCB to bfloat16 and accumulate in
    float32: y, dC, dB and dxdt (bfloat16) within :func:`_bf16_tol`, dcs
    (float32) within 1e-5 of the sum of its terms' magnitudes."""
    C, B, cs, x, w = _decay_inputs(2, 128, 128, Hg, 64, seed=Hg)
    monkeypatch.setenv("TLIE_SSD_INTRA", "pallas")
    assert jax_pallas_ssd.eligible(128, 128, 64, Hg)
    jin = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (C, B, x, w)]
    jC, jB, jx, jw = jin

    def loss(C, B, cs, x):
        y = jax_pallas_ssd.decay_attention(C, B, cs, x)
        return jnp.sum(y.astype(jnp.float32) * jw.astype(jnp.float32)), y

    (_, jy), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        jC, jB, jnp.asarray(cs.numpy()), jx)
    assert jy.dtype == jnp.bfloat16 and jg[2].dtype == jnp.float32

    t = [a.clone().requires_grad_() for a in (C, B, cs, x)]
    y = da.decay_attention(*t)
    y.backward(w)
    assert y.dtype == torch.bfloat16 and [a.grad.dtype for a in t] == [
        torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16]
    sc = da.term_scales(C, B, cs, x, w)  # (y, dC, dcs_i, dB, dxdt, dcs_j)
    checks = (("y", y, jy, sc[0], True), ("dC", t[0].grad, jg[0], sc[1], True),
              ("dB", t[1].grad, jg[1], sc[3], True),
              ("dcs", t[2].grad, jg[2], sc[2] + sc[5], False),
              ("dxdt", t[3].grad, jg[3], sc[4], True))
    for name, got, want, scale, rounded in checks:
        want = torch.from_numpy(_np(want))
        tol = _bf16_tol(want, scale) if rounded else SSD_RTOL * scale + 1e-30
        assert bool(((got.detach().float() - want).abs() <= tol).all()), name
        # most elements round to the very same bfloat16 value
        if rounded:
            assert (got.detach().float() == want).float().mean() > 0.9, name


def _f64_reference(C, B, cs, x, w):
    """The bfloat16 algorithm in float64: C·B, dS = w·xᵀ and their decay
    products in float64, the scores and dCB rounded to bfloat16 where the
    kernels round them, y, dC, dB and dxdt rounded at the end."""
    r = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    C, B, x, w = (t.double() for t in (C, B, x, w))
    Q = cs.shape[-1]
    seg = cs.double()[..., :, None] - cs.double()[..., None, :]
    decay = torch.exp(seg.masked_fill(~torch.ones(Q, Q, dtype=torch.bool).tril(), float("-inf")))
    cb = C @ B.transpose(1, 2)
    s = r(cb[:, None] * decay)
    dsd = (w @ x.transpose(2, 3)) * decay
    dcb = r(dsd.sum(1))
    return (r(s @ x), r(dcb @ B), (dsd * cb[:, None]).sum(-1), r(dcb.transpose(1, 2) @ C),
            r(s.transpose(2, 3) @ w), -(dsd * cb[:, None]).sum(-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_decay_attention_holds_to_float64(dtype):
    """The plain version's algorithm against float64, at a ragged shape
    (Q 77, N 40, Hg 3, P 33): on float32 operands against the float64 plain
    version, each output within 1e-5 of the sum of its terms' magnitudes;
    on bfloat16 operands against the same rounding points evaluated in
    float64 (:func:`_f64_reference`), the bfloat16 outputs within
    :func:`_bf16_tol` and over 90 % of them equal, dcs within 1e-5."""
    C, B, cs, x, w = _decay_inputs(3, 77, 40, 3, 33, seed=7)
    if dtype == torch.float32:
        C, B, x, w = (t.float() for t in (C, B, x, w))
        want = ((da.decay_attention_plain(C.double(), B.double(), cs.double(), x.double()),)
                + da.decay_attention_bwd_plain(C.double(), B.double(), cs.double(), x.double(),
                                               w.double()))
    else:
        want = _f64_reference(C, B, cs, x, w)
    got = (da.decay_attention_plain(C, B, cs, x),) + da.decay_attention_bwd_plain(C, B, cs, x, w)
    scales = da.term_scales(C, B, cs, x, w)
    for i, (g, ref, sc) in enumerate(zip(got, want, scales)):
        assert g.dtype == (torch.float32 if i in (2, 5) else dtype)
        rounded = dtype == torch.bfloat16 and i not in (2, 5)
        tol = _bf16_tol(ref, sc) if rounded else SSD_RTOL * sc + 1e-30
        assert bool(((g.double() - ref).abs() <= tol).all()), i
        if rounded:
            assert (g.double() == ref).double().mean() > 0.9, i


@pytest.mark.parametrize("shape",
                         [(3, 77, 40, 3, 33), (2, 256, 128, 2, 64), (1, 512, 128, 1, 128)],
                         ids=["ragged", "hg2_p64", "mqar_like"])
def test_the_card_checks_equal_share_floor_tells_unrounded_scores_apart(shape, monkeypatch):
    """``chip_smoke.py`` and the card test hold each bfloat16 output of the
    kernels to the plain version within a band wider than the rounding of
    the score and of dCB moves it, and also ask that at least
    ``BF16_EQUAL_SHARE`` of its elements equal the plain version's.  The
    plain version with those two roundings left out (what a kernel that
    skipped them computes) must fall below that share on every bfloat16
    output."""
    floor = load_chip_smoke().BF16_EQUAL_SHARE
    C, B, cs, x, w = _decay_inputs(*shape, seed=11)

    def outputs():
        return (da.decay_attention_plain(C, B, cs, x),) + da.decay_attention_bwd_plain(
            C, B, cs, x, w)

    want = outputs()
    monkeypatch.setattr(da, "_round_as", lambda t, like: t)
    unrounded = outputs()
    for i, (a, b) in enumerate(zip(unrounded, want)):
        if b.dtype == torch.bfloat16:
            assert (a == b).float().mean().item() < floor, i


def test_operands_of_mixed_dtypes_raise():
    """cs stays float32 beside bfloat16 operands; any other mix raises."""
    C, B, cs, x, _ = _decay_inputs(1, 8, 4, 1, 4, seed=0)
    with pytest.raises(TypeError):
        da.decay_attention(C.float(), B, cs, x)
    with pytest.raises(TypeError):
        da.decay_attention(C, B, cs.bfloat16(), x)
    with pytest.raises(TypeError):
        da.decay_attention(C, B, cs.double(), x)


# -- the bf16 Mamba-2 ------------------------------------------------------------

# two layers, two heads of 64, N 128, L 128: the smallest model whose chunk the
# Pallas kernel's gate takes (Q ≥ 128, N % 128 = 0, P % 64 = 0)
MAMBA_BF16 = dict(
    layer="mamba", version="mamba2", num_layers=2, num_heads=2, input_dim=1, output_dim=256,
    hidden_dim=128, state_dim=128, conv_dim=4, expansion=1, dropout=0.0, glu=True,
    norm="layer", dual=False, prenorm=True, pooling="none", embedding=True,
    token_embedding=True, vocab_size=256, max_pos_embed=128, mixer="none", mixer_dim=128,
    classifier=False, compute_dtype="bfloat16", seq_len=128)


def test_bf16_mamba2_log_probs_match_tlie_tpu_and_float32(monkeypatch):
    """A 2-layer bf16 Mamba-2 on weights carried from ``tlie_tpu``'s: the
    log-probs of 2 × 128 tokens against ``tlie_tpu``'s bf16 model
    (``TLIE_SSD_INTRA=pallas``, so its intra-chunk arm is the Pallas kernel
    on bf16 operands) and against the port's own float32 model.  Both
    models round their activations to bfloat16 at every layer, in other
    orders (XLA fuses elementwise chains that torch rounds op by op): each
    log-prob within 0.06 (two bfloat16 steps of the largest |log-prob|,
    about 8) and their mean difference within 0.004 (float32 sits closer
    to either than this).  The intra-chunk arm receives bfloat16 C, B and
    xdt and float32 cs, and the logits are bfloat16."""
    monkeypatch.setenv("TLIE_SSD_INTRA", "pallas")
    _, jeval, _ = jax_build_models(MAMBA_BF16, padded=False)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 128)).astype(np.int32)
    params = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(0), x)["params"])
    jl = jax.jit(jeval.apply)({"params": params}, x)
    assert jl.dtype == jnp.bfloat16
    want = np.asarray(jax.nn.log_softmax(jl.astype(jnp.float32), -1))

    seen = []
    real = ssd.decay_attention

    def spy(Cm, Bm, cs, xdt):
        seen.append((Cm.dtype, Bm.dtype, cs.dtype, xdt.dtype))
        return real(Cm, Bm, cs, xdt)

    monkeypatch.setattr(ssd, "decay_attention", spy)
    _, model, _ = build_models(MAMBA_BF16, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        logits = model(torch.from_numpy(x).long())
    assert logits.dtype == torch.bfloat16
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16)] * 2
    got = torch.log_softmax(logits.float(), -1).numpy()
    f32_cfg = {k: v for k, v in MAMBA_BF16.items() if k != "compute_dtype"}
    _, m32, _ = build_models(f32_cfg, generator=torch.Generator(), device="cpu")
    m32.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        ref32 = torch.log_softmax(m32(torch.from_numpy(x).long()), -1).numpy()
    for other in (want, ref32):
        assert np.abs(got - other).max() <= 0.06
        assert np.abs(got - other).mean() <= 0.004
    assert np.abs(want - ref32).mean() <= 0.004


def test_bf16_logits_reduce_in_float32_like_tlie_tpu(monkeypatch):
    """The masked CE of bfloat16 logits (2 × 300 × 1000, labels with -100)
    against ``tlie_tpu``'s ``cross_entropy_loss``: the loss within 1e-6
    relative (both widen to float32 before the reduction), the logits'
    gradient (bfloat16, rounded once from float32) within one bfloat16 step
    of its value plus 1e-9; the loss equals the float32 loss of the same
    values.  The rows are widened 128 at a time here, so the 600 rows take
    five blocks, the last one short."""
    from tlie_tpu_torch.training import steps

    monkeypatch.setattr(steps, "WIDE_ROWS", 128)
    rng = np.random.default_rng(1)
    logits = _bf16(4 * rng.standard_normal((2, 300, 1000)))
    labels = rng.integers(0, 1000, (2, 300))
    labels[:, ::3] = -100
    jlog = jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16)
    jloss, jgrad = jax.jit(jax.value_and_grad(jax_cross_entropy_loss))(jlog, jnp.asarray(labels))
    t = logits.clone().requires_grad_()
    loss = cross_entropy_loss(t, torch.from_numpy(labels))
    loss.backward()
    assert loss.dtype == torch.float32 and t.grad.dtype == torch.bfloat16
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    want = torch.from_numpy(_np(jgrad))
    assert bool(((t.grad.float() - want).abs() <= BF16_STEP * want.abs() + 1e-9).all())
    assert float(cross_entropy_loss(logits.float(), torch.from_numpy(labels))) == pytest.approx(
        float(loss.detach()), rel=1e-6)


def test_eval_eig_of_a_bf16_checkpoint_is_the_float32_extraction(tmp_path):
    """A bf16 Mamba-2's checkpoint (float32 weights, ``compute_dtype:
    bfloat16`` in its config) eigen-analysed: the spectra and every binned
    array equal those of the same weights under the float32 config, bit for
    bit (eval_eig builds float32 models, as ``tlie_tpu`` extracts in float32),
    and are float32."""
    cfg = load_yaml(BF16_YAML)
    cfg["model"].update(num_layers=2, hidden_dim=32, state_dim=16, num_heads=2, vocab_size=64,
                        output_dim=64, seq_len=32)
    _, model, _ = build_models(cfg["model"], generator=torch.Generator().manual_seed(3),
                               device="cpu")
    path = save_checkpoint(str(tmp_path / "ck"), model, {"model": cfg["model"]})
    batch = np.random.default_rng(2).integers(0, 64, (4, 32))
    got = eval_eig(cfg, {"save_path": str(tmp_path / "a")}, 1.0, path, device="cpu", batch=batch)
    f32 = dict(cfg, model={k: v for k, v in cfg["model"].items() if k != "compute_dtype"})
    want = eval_eig(f32, {"save_path": str(tmp_path / "b")}, 1.0, path, device="cpu", batch=batch)
    assert got[0].dtype == np.float32 and got[0].shape == (4, 32, 2, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _tiny_bf16(tmp_path, **train):
    cfg = load_yaml(BF16_YAML)
    cfg["model"].update(num_layers=2, hidden_dim=32, state_dim=16, num_heads=2)
    cfg["dataset"].update(block_size=64, synthetic_train_tokens=64 * 12,
                          synthetic_test_tokens=64 * 4)
    cfg["train"].update(batch_size=2, total_steps=4, eval_every=2, **train)
    cfg["save"] = str(tmp_path / "checkpoint" / "wikitext-mamba2-short-bf16")
    return cfg


def test_bf16_training_keeps_float32_weights_and_moves_them(tmp_path):
    """Four steps of a tiny cut of ``configs/wikitext-mamba2-short-bf16.yaml``
    (the full vocabulary of 50,257, dense head): finite losses and
    perplexities, every parameter still float32 and moved from its init."""
    cfg = _tiny_bf16(tmp_path)
    data = WikiText(**cfg["dataset"])
    tr, te = data.split("train"), data.split("test")
    cfg = derive_runtime_fields(cfg, data.l_max, len(tr[0]))
    result = train(cfg, tr, te, device="cpu")
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    init = build_models(cfg["model"], generator=torch.Generator().manual_seed(cfg["seed"]),
                        device="cpu")[0].state_dict()
    for name, p in result.model.state_dict().items():
        assert p.dtype == torch.float32, name
        assert not torch.equal(p, init[name]), name


def test_launch_trains_and_analyses_bf16_mamba2_on_the_cpu(tmp_path, monkeypatch, capsys):
    cfg = _tiny_bf16(tmp_path)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    analysis = load_yaml(ROOT / "configs/analysis/wikitext.yaml")
    analysis["save_path"] = str(tmp_path / "analysis")
    (tmp_path / "analysis.yaml").write_text(yaml.safe_dump(analysis))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(tmp_path / "tiny.yaml"), "--analysis_config",
                        str(tmp_path / "analysis.yaml"), "--device", "cpu"]) == 0
    assert "Finished!" in capsys.readouterr().out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.startswith("wikitext-mamba2-short-bf16-seed-1919-layers-2")
    (run,) = os.listdir(tmp_path / "analysis")
    assert np.load(tmp_path / "analysis" / run / "eig.npy").dtype == np.float32


FLOAT16_CONFIGS = {"lru": "configs/mqar-lru-small.yaml", "s5": "configs/mqar-s5-small.yaml",
                   "s4": "configs/mqar-s4-small.yaml",
                   "transformer": "configs/mqar-lin-attention-small.yaml"}


@pytest.mark.parametrize("layer", ["lru", "s5", "s4", "transformer", "mamba"])
def test_float16_stays_refused_for_every_family(layer):
    """compute_dtype: float16 raises for every family (bfloat16 builds for
    all five: ``tests/test_torch_bf16_families.py``)."""
    cfg = (dict(MAMBA_BF16) if layer == "mamba"
           else dict(load_yaml(ROOT / FLOAT16_CONFIGS[layer])["model"], seq_len=64))
    with pytest.raises(NotImplementedError, match="float16"):
        build_models(dict(cfg, compute_dtype="float16"), generator=torch.Generator(),
                     device="cpu")


def test_the_fused_head_on_bf16_operands_stays_refused(tmp_path):
    """``configs/wikitext-mamba2-short-bf16-fused.yaml``'s head (the fused
    decoder + CE on bfloat16 operands) trains (``tests/test_torch_fused_xent_bf16.py``);
    what stays refused is its operands in mixed dtypes (the features in
    float32 beside the bfloat16 weight, which ``fused_head_loss`` never
    hands over).  Stacking the config under ``--sweep_parallel``, which
    this once refused too, trains it: through the dense head, as
    ``tlie_tpu``'s stacked block takes no fused head, one stacked step
    equal to a serial dense-head step of the same point (bfloat16 products
    batched may round apart: the loss within 2e-2 relative)."""
    from tlie_tpu_torch.ops.fused_xent import fused_softmax_xent
    from tlie_tpu_torch.parallel import run_sweep
    from tlie_tpu_torch.training import steps as steps_mod

    cfg = _tiny_bf16(tmp_path, fused_xent=True)
    data = WikiText(**cfg["dataset"])
    tr, _ = data.split("train")
    cfg = derive_runtime_fields(cfg, data.l_max, len(tr))
    model, _, _ = build_models(cfg["model"], generator=torch.Generator(), device="cpu")
    feats = model.features(torch.as_tensor(tr[:2]).long()).float().reshape(-1, 32)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fused_softmax_xent(feats, model.decoder.weight.bfloat16().t(),
                           model.decoder.bias.bfloat16(), torch.zeros(128).long())
    cfg["train"].update(total_steps=1, eval_every=1)
    cfg["save"] = str(tmp_path / "stacked" / "ckpt")
    mp = pytest.MonkeyPatch()
    mp.setattr(steps_mod, "fused_head_loss", lambda *a: pytest.fail("the fused head trained"))
    try:
        (res,), (wave,) = run_sweep(ExperimentConfig(cfg), [{("seed",): cfg["seed"]}],
                                    data.split("train"), data.split("test"), data.l_max,
                                    device="cpu")
    finally:
        mp.undo()
    assert os.path.exists(res[0])
    dense = dict(cfg, save=None, train=dict(cfg["train"], fused_xent=False))
    serial = train(dense, data.split("train"), data.split("test"), device="cpu")
    assert wave["histories"][0][0]["train_loss"] == pytest.approx(
        serial.history[0]["train_loss"], rel=2e-2)


# -- the card run's paths 8 and 9, rehearsed ------------------------------------------

@pytest.mark.parametrize("config",
                         ["wikitext-mamba2-short.yaml", "wikitext-mamba2-short-bf16.yaml"],
                         ids=["f32", "bf16"])
def test_chip_smoke_paths_8_and_9_run_on_the_cpu(monkeypatch, config):
    """``chip_smoke.wikitext_mamba2_path`` on a tiny cut of its config on the
    CPU (2 layers, d_model 32, two heads, block 64, 12 training blocks), 2
    steps: every check of the path runs as on the card: the launch counts
    of the path's dtype alone (the float32 or the bfloat16 kernels), the
    checkpoint's float32 spectra against the float32 extraction of the
    trained weights, the float32 analysis launches, the step timing."""
    from tlie_tpu_torch import config as config_mod

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True)
    real_load = config_mod.load_yaml

    def tiny_load(path):
        cfg = real_load(path)
        if os.path.basename(str(path)).startswith("wikitext-mamba2"):
            cfg["model"].update(num_layers=2, hidden_dim=32, state_dim=16, num_heads=2)
            cfg["dataset"].update(block_size=64, synthetic_train_tokens=64 * 12,
                                  synthetic_test_tokens=64 * 4)
            cfg["train"]["batch_size"] = 2
        return cfg

    monkeypatch.setattr(config_mod, "load_yaml", tiny_load)
    monkeypatch.setattr(cs, "WT_STEPS", 2)
    splits = cs.wikitext_splits()
    launches = cs.wikitext_mamba2_path(torch.device("cpu"), splits, config, "wt",
                                       ARTIFACT_FILES)
    # training's (2 steps and 2 eval batches of 2 layers) and the float32
    # analysis's forwards of the init and trained models
    sfx = "_bf16" if "bf16" in config else ""
    want = {f"decay_attention_fwd{sfx}": 2 * (2 + 2), f"decay_attention_bwd_i{sfx}": 4,
            f"decay_attention_bwd_j{sfx}": 4}
    want["decay_attention_fwd"] = want.get("decay_attention_fwd", 0) + 2 * 2
    assert {k: v for k, v in launches.items() if v} == want
