"""``model.compute_dtype: bfloat16`` for the LRU, S5, S4, Mamba-1 and
transformer families against ``tlie_tpu``'s bf16 models on the same
weights: the log-probs of the tiny configs of ``tests/test_bf16.py`` (the
post-norm LRU, S5, S4, the linear, softmax and norm attention transformers,
and its Mamba at ``version: mamba1``) and of a post-norm BatchNorm LRU LM, closer to it than the port's float32 model;
the dtype of every parameter-holding module's output against
``tlie_tpu``'s module at the same place; the dtypes each core receives (the SSM cores
float32, linear attention bfloat16, softmax attention float32); and the
chunked linear attention on bfloat16 inputs, which rounds as
``tlie_tpu``'s does, where a float32 upcast of its q, k and v would not.

Weights are ``tlie_tpu``'s, drawn under jit and carried into the port with
``compat``; inputs are made with numpy from a seed.  JAX runs jitted at
HIGHEST matmul precision (tests/conftest.py).  Tolerances are stated where
they are used.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bf16 import _ATT_TINY, _LRU_TINY, _MAMBA_TINY, _NORM_ATT_EXTRA, _S4_TINY, _S5_TINY
from tlie_tpu.ops.linear_attention import chunked_linear_attention as jax_chunked_linear_attention
from tlie_tpu.ops.linear_attention import (
    recurrent_linear_attention as jax_recurrent_linear_attention,
)
from tlie_tpu_torch import compat
from tlie_tpu_torch.models import attention_layers, build_models, layers
from tlie_tpu_torch.ops.linear_attention import recurrent_linear_attention
from torch_parity import jax_apply, jax_weights, port_model

torch.set_num_threads(1)

U = 2.0 ** -8  # bfloat16's unit roundoff: half the spacing of its values, relative

# the post-norm BatchNorm LRU LM: a decoder on every position, the running
# statistics moved away from their init by jax_weights
LRU_BN_LM = {**_LRU_TINY, "norm": "batch", "pooling": "none"}

FAMILIES = {
    "lru": _LRU_TINY, "s5": _S5_TINY, "s4": _S4_TINY, "lin_attention": _ATT_TINY,
    "sm_attention": {**_ATT_TINY, "attention_fn": "sm-attention"},
    "norm_attention": {**_ATT_TINY, **_NORM_ATT_EXTRA}, "lru_batchnorm_lm": LRU_BN_LM,
    # Mamba-1: in_proj, the conv, x_proj and out_proj in bfloat16, dt_proj
    # and the recurrence in float32
    "mamba1": {**_MAMBA_TINY, "version": "mamba1"},
}


def _tokens(seed=0, batch=4, length=32):
    return np.random.default_rng(seed).integers(0, 64, (batch, length)).astype(np.int32)


# the port's bf16 model's mean distance from tlie_tpu's bf16 model is at
# most this share of the float32 port's (measured on this test's inputs:
# 0.67 (S5) to 0.82 (linear attention); the float32 model is 1 by definition)
MEAN_SHARE_OF_FLOAT32 = 0.9


def _log_prob_gaps(got, want):
    """(max, mean) of |got − want| over the log-probs."""
    err = np.abs(got - want)
    return float(err.max()), float(err.mean())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_log_probs_match_tlie_tpu(name):
    """The port's bf16 model on ``tlie_tpu``'s weights (and, for the
    BatchNorm LM, its moved statistics): bfloat16 logits from float32
    parameters, and log-probs within two bfloat16 roundings (2u) of the
    largest |log-prob| of ``tlie_tpu``'s bf16 model's, their mean
    difference within 0.004, as the bf16 Mamba-2 is held
    (``tests/test_torch_bf16.py``).  Both models round their activations
    to bfloat16 at the same points; XLA's GELU and sigmoid on bfloat16 are
    other approximations than PyTorch's (each differs from torch's in about
    a third of the elements), which the bound covers.

    Those two bounds would let a float32 model through (its mean gap to
    ``tlie_tpu``'s bf16 model is 7e-4 to 2.3e-3 here), so the mean gap is
    also held to ``MEAN_SHARE_OF_FLOAT32`` of the port's float32 model's
    on the same weights, and that float32 control fails it."""
    cfg = {**FAMILIES[name], "compute_dtype": "bfloat16"}
    jmodel, params, stats = jax_weights(cfg)
    x = _tokens()
    jl = jax_apply(jmodel, params, stats, x)
    assert jl.dtype == jnp.bfloat16
    want = np.asarray(jax.nn.log_softmax(jnp.asarray(jl).astype(jnp.float32), -1))
    model = port_model(cfg, params, stats)
    control = port_model({k: v for k, v in cfg.items() if k != "compute_dtype"}, params, stats)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        logits = model(torch.from_numpy(x).long())
        logits32 = control(torch.from_numpy(x).long())
    assert logits.dtype == torch.bfloat16 and logits32.dtype == torch.float32
    got = torch.log_softmax(logits.float(), -1).numpy()
    assert got.shape == want.shape
    gap_max, gap_mean = _log_prob_gaps(got, want)
    _, gap32_mean = _log_prob_gaps(torch.log_softmax(logits32, -1).numpy(), want)

    def within(g_max, g_mean):
        return (g_max <= 2 * U * np.abs(want).max(), g_mean <= 0.004,
                g_mean <= MEAN_SHARE_OF_FLOAT32 * gap32_mean)

    print(f"{name}: bf16 gap max {gap_max:.4g} mean {gap_mean:.4g}; float32 control mean "
          f"{gap32_mean:.4g} (share {gap_mean / gap32_mean:.3f})")
    assert all(within(gap_max, gap_mean)), (gap_max, gap_mean, gap32_mean)
    assert not all(within(*_log_prob_gaps(torch.log_softmax(logits32, -1).numpy(), want)))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_modules_round_where_tlie_tpus_do(name):
    """Every module of the port's bf16 model that holds parameters gives its
    output in the dtype of ``tlie_tpu``'s module at the same place (flax's
    ``capture_intermediates``, the module paths from ``compat``), call by
    call: the embeddings (through their ``TokenEmbeddings``, which reads
    the tables), the encoder, out1, out2, the decoder, the attention's
    projections, conv and mixer in bfloat16; the SSM cores and every
    LayerNorm and BatchNorm (each call of a block's shared norm) in
    float32.  So a norm that does not widen its input, or a GLU, mixer or
    decoder left in float32, fails here whatever the log-probs show.  Where
    a projection adds its bias (before or after the product's rounding, see
    ``layers.Linear``) is not a dtype and is not held here."""
    cfg = {**FAMILIES[name], "compute_dtype": "bfloat16"}
    jmodel, params, stats = jax_weights(cfg)
    x = _tokens(batch=2)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    _, state = jax.jit(lambda v, t: jmodel.apply(v, t, capture_intermediates=True,
                                                 mutable=["intermediates"]))(variables, x)
    flax_dtypes = {}

    def collect(tree, path=()):
        for k, v in tree.items():
            if k == "__call__":
                flax_dtypes[path] = [str(o.dtype) for o in v]
            else:
                collect(v, path + (k,))

    collect(state["intermediates"])
    model = port_model(cfg, params, stats)
    modules = dict(model.named_modules())
    seen = {}

    def record(mod_name):
        def hook(module, inputs, out):
            seen.setdefault(mod_name, []).append(str(out.dtype).replace("torch.", ""))
        return hook

    places = {}
    for key in model.state_dict():
        mod_name = key.rsplit(".", 1)[0]
        places.setdefault(mod_name, compat.flax_path(key)[1:-1])
    for mod_name in places:
        modules[mod_name].register_forward_hook(record(mod_name))
    # an embedding table is read by its TokenEmbeddings, not called
    for mod_name, module in modules.items():
        if isinstance(module, layers.TokenEmbeddings):
            module.register_forward_hook(record(mod_name))
            places[mod_name] = tuple(mod_name.split("."))
    with torch.no_grad():
        model(torch.from_numpy(x).long())
    compared = {m: (seen[m], flax_dtypes.get(places[m])) for m in places if m in seen}
    assert all(port == want for port, want in compared.values()), compared
    kinds = {type(modules[m]).__name__ for m in compared}
    assert {"Linear", "LayerNorm" if name != "lru_batchnorm_lm" else "BatchNorm"} <= kinds
    # only the tables are left, their reads held through TokenEmbeddings
    assert all(isinstance(modules[m], torch.nn.Embedding) for m in set(places) - set(compared))


# -- the dtypes the cores receive --------------------------------------------------------

@pytest.mark.parametrize("name", ["lru", "s5", "s4", "lru_batchnorm_lm"])
def test_the_ssm_core_receives_float32(name):
    """Every layer's SSM core gets float32 input under bf16 compute, in the
    post-norm stacks (where the encoder's bfloat16 output reaches the first
    core straight) and the pre-norm ones, and returns float32; the GLU's
    projections compute in bfloat16."""
    cfg = {**FAMILIES[name], "compute_dtype": "bfloat16"}
    model, _, _ = build_models(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    seen = []
    for layer in model.encoder.layers:
        layer.seq.register_forward_hook(
            lambda mod, inp, out: seen.append((inp[0].dtype, out.dtype)))
        layer.out2.register_forward_hook(lambda mod, inp, out: seen.append(("out2", out.dtype)))
    model(torch.from_numpy(_tokens(batch=2)).long())
    n = len(model.encoder.layers)
    assert seen == [(torch.float32, torch.float32), ("out2", torch.bfloat16)] * n


@pytest.mark.parametrize("attention_fn,fn_name,want", [
    ("lin-attention", "chunked_linear_attention", torch.bfloat16),
    ("norm-attention", "chunked_linear_attention", torch.bfloat16),
    ("sm-attention", "causal_softmax_attention", torch.float32),
])
def test_the_attention_receives_its_dtype(monkeypatch, attention_fn, fn_name, want):
    """Under bf16 compute the linear and norm attention get bfloat16 q, k
    and v (their elu+1 and identity features), the softmax attention
    float32 ones: ``tlie_tpu`` upcasts on the softmax branch alone
    (``attention_layers.py:136-141``), which is what sends a bf16
    transformer to the float32 flash kernels."""
    cfg = {**_ATT_TINY, **(_NORM_ATT_EXTRA if attention_fn == "norm-attention" else {}),
           "attention_fn": attention_fn, "compute_dtype": "bfloat16"}
    seen = []
    real = getattr(attention_layers, fn_name)

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(attention_layers, fn_name, spy)
    model, _, _ = build_models(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    logits = model(torch.from_numpy(_tokens(batch=2)).long())
    assert logits.dtype == torch.bfloat16
    assert seen == [(want,) * 3] * cfg["num_layers"]


# -- the linear attention op rounds as tlie_tpu's ---------------------------------------------

@pytest.mark.parametrize("normalizer", [True, False], ids=["linear", "norm"])
def test_the_linear_attention_rounds_as_tlie_tpu_does(normalizer):
    """The chunked linear attention on the bfloat16 q, k and v the linear
    (with its normaliser) and the norm attention (without) hand it (2 × 256
    × 2 heads × 32, two chunks of 128, so the prefix of the chunk states
    works): the bfloat16 output equals ``tlie_tpu``'s in at least 99.9 % of
    the elements (bfloat16 scores, float32 chunk states, the prefix cast
    back to bfloat16 before its contraction), and the float32 normaliser is
    within 1e-6 of its max.  The same inputs upcast to float32, as the port
    did before this slice, give an output that, rounded to bfloat16, equals
    ``tlie_tpu``'s in fewer than 90 % of the elements, so the test tells
    the two apart.  Inside a whole mixer the share cannot: the projections'
    bias rounding (``layers.Linear``) and XLA's own SiLU make about half of
    the elements differ either way, and the parity bound above covers
    them."""
    rng = np.random.default_rng(0)
    shape = (2, 256, 2, 32)
    q, k = (torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32)).bfloat16()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    jout = jax.jit(lambda a, b, c: jax_chunked_linear_attention(
        a, b, c, return_normalizer=normalizer))(jq, jk, jv)
    out = attention_layers.chunked_linear_attention(q, k, v, return_normalizer=normalizer)
    up = attention_layers.chunked_linear_attention(q.float(), k.float(), v.float(),
                                                   return_normalizer=normalizer)
    if normalizer:
        (jout, jn), (out, n), up = jout, out, up[0]
        assert n.dtype == torch.float32
        jn = np.asarray(jn)
        assert np.abs(n.numpy() - jn).max() <= 1e-6 * np.abs(jn).max()
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    assert np.mean(out.float().numpy() == want) >= 0.999
    assert np.mean(up.bfloat16().float().numpy() == want) < 0.9


def test_the_recurrent_oracle_takes_bf16_as_tlie_tpus_does():
    """The recurrent form (the oracle and one decode step's algebra) on
    bfloat16 q, k and v (2 × 48 × 2 heads × 16): its state S in v's dtype,
    S_t = S_{t−1} + k_t v_tᵀ rounded to bfloat16 each step as
    ``tlie_tpu``'s, the output bfloat16 and equal to ``tlie_tpu``'s in at
    least 99.9 % of the elements; the chunked form on the same inputs stays
    within the drift of the recurrent one's per-step rounding (5 % of the
    largest |output|)."""
    rng = np.random.default_rng(1)
    shape = (2, 48, 2, 16)
    q, k = (torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32)).bfloat16()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jax.jit(jax_recurrent_linear_attention)(jq, jk, jv).astype(jnp.float32))
    got = recurrent_linear_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    assert np.mean(got.float().numpy() == want) >= 0.999
    chunked = attention_layers.chunked_linear_attention(q, k, v).float().numpy()
    assert np.abs(chunked - want).max() <= 0.05 * np.abs(want).max()


# -- bf16 Mamba-1 trains, checkpoints and is eigen-analysed ------------------------------

def test_bf16_mamba1_trains_checkpoints_and_is_eigen_analysed_in_float32(tmp_path):
    """A tiny bf16 MQAR Mamba-1 (``configs/mqar-mamba1-small.yaml`` at
    d_model 16, N 4) trained 4 steps through ``train``: finite losses, the
    parameters float32 before and after, every one of them moved; its
    checkpoint holds the trained float32 weights and ``compute_dtype`` in its
    config; eval_eig of it equals eval_eig of the same weights under the
    float32 config bit for bit (the port extracts in float32, as
    ``tlie_tpu`` does); and ``Decoder.from_checkpoint`` serves it in
    float32, as ``tlie_tpu``'s decoder multiplies the stored weights: its
    prefill logits and stepwise logits those of the float32 model on the
    same weights (2e-5), which the bf16 model's own forward is not."""
    from test_torch_sweep_families import _mqar_config
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.training import restore_checkpoint, train

    raw, tr, te, _ = _mqar_config("mamba1", tmp_path)
    raw["model"]["compute_dtype"] = "bfloat16"
    raw["lang_model"] = True
    result = train(raw, tr, te, device="cpu")
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    assert all(p.dtype == torch.float32 for p in result.model.parameters())
    init, _, _ = build_models(raw["model"], generator=torch.Generator().manual_seed(raw["seed"]),
                              device="cpu")
    trained = result.model.state_dict()
    assert not [k for k, v in init.state_dict().items() if torch.equal(v, trained[k])]
    path, perf = result
    ckpt = restore_checkpoint(path)
    assert ckpt["config"]["model"]["compute_dtype"] == "bfloat16"
    for k, v in trained.items():
        assert torch.equal(ckpt["model"][k], v), k
    batch = te[0][:4]
    got = eval_eig(raw, {"save_path": str(tmp_path / "a")}, perf, path, device="cpu", batch=batch)
    f32 = dict(raw, model={k: v for k, v in raw["model"].items() if k != "compute_dtype"})
    want = eval_eig(f32, {"save_path": str(tmp_path / "b")}, perf, path, device="cpu",
                    batch=batch)
    d_inner = raw["model"]["expansion"] * raw["model"]["hidden_dim"]
    assert got[0].shape == (4, 32, d_inner * raw["model"]["state_dim"], raw["model"]["num_layers"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dec = Decoder.from_checkpoint(path, device="cpu")
    _, f32_model, _ = build_models(f32["model"], generator=torch.Generator(), device="cpu")
    f32_model.load_state_dict(ckpt["model"])
    x = torch.from_numpy(te[0][:3]).long()
    with torch.no_grad():
        full, own = f32_model(x), result.eval_model(x)
    tol = 2e-5 * full.abs().max().item()
    _, last = dec.prefill(x[:, :20], 32)
    assert last.dtype == torch.float32
    torch.testing.assert_close(last, full[:, 19], rtol=0, atol=tol)
    torch.testing.assert_close(dec.stepwise_logits(x), full, rtol=0, atol=tol)
    assert own.dtype == torch.bfloat16 and (own.float() - full).abs().max().item() > 10 * tol


# -- the card run's path 35, rehearsed ----------------------------------------------------

def test_chip_smoke_path_35_runs_on_the_cpu_with_counting_plain_kernels(monkeypatch):
    """``chip_smoke.bf16_mamba1_path`` on its config's own widths (the
    split cut to 256 / 64 examples) at 4 steps with an eval every 2, the
    card's timers stubbed and the scan kernels replaced by counting plain
    versions: the bf16 log-probs against float32, 2 + 2 scan launches a
    training step, the float32 spectra and serving from the checkpoint,
    and the bf16 card step against the CPU's, as on the card."""
    from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card
    from tlie_tpu_torch import config as config_mod

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
    cut = copy.deepcopy(config_mod.MQAR_MAMBA1_SMALL)
    cut["dataset"].update(num_train_examples=256, num_test_examples=64)
    monkeypatch.setattr(config_mod, "MQAR_MAMBA1_SMALL", cut)
    for name, value in (("P35_STEPS", 4), ("P35_EVAL_EVERY", 2), ("M1_ANALYSIS_BATCH", 4)):
        monkeypatch.setattr(cs, name, value)
    launches = cs.bf16_mamba1_path(torch.device("cpu"), ARTIFACT_FILES)
    # training alone is held exactly inside the path (2 layers: 4 steps, 2
    # evals of 64 // 32 batches); the forwards, eval_eig and serving add more
    assert launches["diag_scan_bwd"] == 2 * 4 and launches["diag_scan"] > 2 * (4 + 2 * 2)
    assert not any(v for k, v in launches.items() if not k.startswith("diag_scan"))
