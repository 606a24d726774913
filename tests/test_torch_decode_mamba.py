"""The port's decoders for the Mamba family (Mamba-2, its pseudo-LTI variant
SSD_LTI and Mamba-1), for the gated linear-attention LM and with the
bfloat16 decode state, against tlie_tpu's ``Decoder`` on weights carried by
``compat``: prefill logits and every cache entry, the stepwise logits and
greedy tokens; the step path against the port's own full forward, past the
config's ``max_pos_embed`` (the Mamba family has no position table); and
chip_smoke's four serving phases (``mamba_serving``, ``mamba_lti_serving``,
``wt_mamba2_serving``, ``mamba1_serving``) and its kernel timings at the
prefills' operands, rehearsed on the CPU with counting plain kernels.

Inputs are made with numpy from a seed; JAX runs jitted at HIGHEST matmul
precision (tests/conftest.py).  Float32 results are held to tlie_tpu's
within 2e-5 absolute, as tests/test_torch_decode.py holds the LRU's (the
two sum the same float32 products in other orders; they agree to 5e-7 on
these sizes).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.config import MQAR_MAMBA1_SMALL, MQAR_MAMBA2_FULL, load_yaml
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import save_checkpoint
from torch_parity import (
    jax_transformer_params, load_chip_smoke, port_transformer, stub_card, to_numpy,
)

torch.set_num_threads(1)
ATOL = 2e-5
V, L = 64, 40
MB_BASE = {
    "layer": "mamba", "version": "mamba2", "input_dim": 1, "output_dim": V,
    "hidden_dim": 16, "state_dim": 8, "num_heads": 2, "num_layers": 2,
    "conv_dim": 4, "expansion": 1, "dropout": 0.0, "glu": True,
    "norm": "layer", "prenorm": True, "classifier": False, "pooling": "none",
    "dual": False, "embedding": True, "token_embedding": True,
    "vocab_size": V, "mixer": "none", "mixer_dim": 16, "seq_len": L, "max_pos_embed": 16,
}
VARIANTS = {
    "mamba2": {},
    # two groups, learned initial states (drawn away from their zero init),
    # no GLU, post-norm
    "mamba2_groups_init_states_postnorm": dict(ngroups=2, learnable_init_states=True,
                                               glu=False, prenorm=False),
    "ssd_lti_dt_limit": dict(pseudoLTI=True, dt_limit=(0.0, 0.5)),
    "mamba1": dict(version="mamba1", expansion=2, state_dim=4),
}


def _tokens(batch, length, seed):
    return np.random.default_rng(seed).integers(0, V, (batch, length)).astype(np.int32)


def _carried(cfg, seed=3):
    """tlie_tpu's params for ``cfg`` (learned initial states drawn from
    N(0, 0.5²)) and the port's eval model carrying them."""
    _, jeval, _ = jax_build_models(dict(cfg), padded=False)
    params = to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(seed),
                                          np.zeros((1, L), np.int32))["params"])
    if cfg.get("learnable_init_states"):
        rng = np.random.default_rng(seed)
        for i in range(cfg["num_layers"]):
            p = params[f"blocks_{i}"]["mamba"]
            p["init_states"] = rng.normal(0.0, 0.5, p["init_states"].shape).astype(np.float32)
    _, model, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return params, model


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    cfg = dict(MB_BASE, **VARIANTS[request.param])
    params, model = _carried(cfg)
    return cfg, params, model, JaxDecoder(cfg, params), Decoder(cfg, model, device="cpu")


def _assert_caches(cache, jcache, atol=ATOL):
    assert len(cache) == len(jcache)
    for c, jc in zip(cache, jcache):
        assert len(c) == len(jc)
        for a, b in zip(c, jc):
            b = np.asarray(b).astype(np.float32)
            assert a.shape == b.shape
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=atol)


@pytest.mark.parametrize("length", [36, 2], ids=["chunks", "shorter_than_the_conv"])
def test_prefill_logits_and_cache_match_jax(pair, length):
    """Prefill's last logits and every (conv tail, h) against tlie_tpu's
    prefill: 36 tokens run several chunks, 2 leave the conv's tail of 3
    front-padded."""
    cfg, _, _, jdec, dec = pair
    prompt = _tokens(3, length, seed=11)
    jcache, jlogits = jdec.prefill(prompt)
    cache, logits = dec.prefill(prompt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    _assert_caches(cache, jcache)
    if length == 2:
        assert all(torch.equal(c[0][:, :1], torch.zeros_like(c[0][:, :1])) for c in cache)


def test_stepwise_logits_and_greedy_tokens_match_jax(pair):
    cfg, _, _, jdec, dec = pair
    x = _tokens(2, L, seed=12)
    np.testing.assert_allclose(dec.stepwise_logits(x).numpy(),
                               np.asarray(jdec.stepwise_logits(x)), rtol=0, atol=ATOL)
    prompt = x[:, :12]
    np.testing.assert_array_equal(dec.generate(prompt, 8).numpy(),
                                  np.asarray(jdec.generate(prompt, 8)))


def test_step_path_matches_the_full_forward_past_max_pos_embed(pair):
    """The port's step path against its own forward at every position of
    12 prompt and 12 generated tokens, past ``max_pos_embed`` 16 (no
    position table: nothing raises), 2e-5 of max|logit|; prefill's state
    equal to the step path's after the same tokens, 1e-5 of each entry's
    max."""
    cfg, _, model, _, dec = pair
    prompt = _tokens(3, 12, seed=13)
    out = dec.generate(prompt, 12)
    assert out.shape == (3, 24) and np.array_equal(out[:, :12].numpy(), prompt)
    with torch.no_grad():
        full = model(out)
    tol = 2e-5 * full.abs().max().item()
    torch.testing.assert_close(dec.stepwise_logits(out), full, rtol=0, atol=tol)
    cache, last = dec.prefill(out[:, :20])
    torch.testing.assert_close(last, full[:, 19], rtol=0, atol=tol)
    stepped = dec.init_cache(3)
    for t in range(20):
        stepped, _ = dec.step(stepped, out[:, t])
    for c, s in zip(cache, stepped):
        for a, b in zip(c, s):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("variant", ["mamba2_groups_init_states_postnorm", "mamba1"])
def test_bf16_state_matches_tlie_tpus_bf16_state(variant):
    """``state_dtype=torch.bfloat16`` against tlie_tpu's ``state_dtype=
    jnp.bfloat16``: the prefill's bfloat16 h equal to tlie_tpu's within
    one bfloat16 step (2^-8) of its max (both round the same float32 update
    on store; an update within 5e-7 of a rounding midpoint could round
    apart), the stepwise logits within 2e-5, and apart from the float32
    state's (with the learned initial states, by more than 10 × 2e-5)."""
    cfg = dict(MB_BASE, **VARIANTS[variant])
    params, model = _carried(cfg)
    jdec = JaxDecoder(cfg, params, state_dtype=jnp.bfloat16)
    dec = Decoder(cfg, model, device="cpu", state_dtype=torch.bfloat16)
    prompt = _tokens(3, 36, seed=14)
    cache, logits = dec.prefill(prompt)
    jcache, jlogits = jdec.prefill(prompt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    for (tail, h), (jtail, jh) in zip(cache, jcache):
        assert h.dtype == torch.bfloat16 and tail.dtype == torch.float32
        jh = np.asarray(jh.astype(jnp.float32))
        np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), rtol=0, atol=ATOL)
        np.testing.assert_allclose(h.float().numpy(), jh, rtol=0, atol=2.0 ** -8 * np.abs(jh).max())
    x = _tokens(2, L, seed=15)
    got = dec.stepwise_logits(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jdec.stepwise_logits(x)), rtol=0, atol=ATOL)
    drift = np.abs(got - Decoder(cfg, model, device="cpu").stepwise_logits(x).numpy()).max()
    assert drift > (10 * ATOL if cfg.get("learnable_init_states") else 0.0)


def test_bf16_compute_mamba2_is_served_in_float32_as_tlie_tpu_serves_it():
    """A ``compute_dtype: bfloat16`` Mamba-2: tlie_tpu's decoder multiplies
    the float32 params as stored, so the port's decodes in float32 too
    (float32 logits within 2e-5 of tlie_tpu's, prefill and stepwise), while
    the bfloat16 model's own forward differs from them by more than
    that."""
    cfg = dict(MB_BASE, compute_dtype="bfloat16")
    params, model = _carried(cfg)
    dec = Decoder(cfg, model, device="cpu")
    jdec = JaxDecoder(cfg, params)
    x = _tokens(2, 24, seed=16)
    _, logits = dec.prefill(x)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jdec.prefill(x)[1]), rtol=0, atol=ATOL)
    sw = dec.stepwise_logits(x)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jdec.stepwise_logits(x)), rtol=0, atol=ATOL)
    with torch.no_grad():
        own = model(torch.from_numpy(x).long())
    assert own.dtype == torch.bfloat16 and (own.float() - sw).abs().max().item() > 10 * ATOL
    # the same from the state dict
    sd_dec = Decoder(cfg, model.state_dict(), device="cpu")
    torch.testing.assert_close(sd_dec.stepwise_logits(x), sw, rtol=0, atol=0)


# -- the gated linear-attention LM -------------------------------------------------

TF_GATE = {
    "layer": "transformer", "attention_fn": "lin-attention", "input_dim": 1, "output_dim": V,
    "hidden_dim": 16, "state_dim": 16, "num_heads": 2, "num_layers": 2, "att_dropout": 0.0,
    "dropout": 0.0, "norm": "layer", "embedding": True, "vocab_size": V, "max_pos_embed": 48,
    "mixer": "mlp", "mixer_dim": 24, "classifier": False, "pooling": "none", "dual": False,
    "use_flash": False, "use_gate": True, "seq_len": L,
}


@pytest.mark.parametrize("conv", [3, 0], ids=["conv", "no_conv"])
def test_gated_linear_attention_lm_matches_jax(conv):
    """A gated (``use_gate``) linear-attention LM with the MLP mixer, with
    and without the conv: prefill logits and every cache entry, stepwise
    logits (2e-5) and 8 greedy tokens (equal) against tlie_tpu's decoder,
    and the step path against the port's own forward (2e-5 of max|logit|);
    then the bfloat16 S against tlie_tpu's bfloat16 S."""
    cfg = dict(TF_GATE, dim_conv=conv, conv_type="full")
    _, params = jax_transformer_params(cfg, seed=5)
    _, model = port_transformer(cfg, params)
    jdec, dec = JaxDecoder(cfg, params), Decoder(cfg, model, device="cpu")
    prompt = _tokens(3, 24, seed=17)
    jcache, jlogits = jdec.prefill(prompt, 32)
    cache, logits = dec.prefill(prompt, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    _assert_caches(cache, jcache)
    x = _tokens(2, L, seed=18)
    sw = dec.stepwise_logits(x)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jdec.stepwise_logits(x)), rtol=0, atol=ATOL)
    with torch.no_grad():
        full = model(torch.from_numpy(x).long())
    torch.testing.assert_close(sw, full, rtol=0, atol=2e-5 * full.abs().max().item())
    np.testing.assert_array_equal(dec.generate(prompt, 8).numpy(),
                                  np.asarray(jdec.generate(prompt, 8)))
    jdec16 = JaxDecoder(cfg, params, state_dtype=jnp.bfloat16)
    dec16 = Decoder(cfg, model, device="cpu", state_dtype=torch.bfloat16)
    cache16, _ = dec16.prefill(prompt, 32)
    assert cache16[0][-2].dtype == torch.bfloat16 and cache16[0][-1].dtype == torch.float32
    np.testing.assert_allclose(dec16.stepwise_logits(x).numpy(),
                               np.asarray(jdec16.stepwise_logits(x)), rtol=0, atol=ATOL)


# -- chip_smoke's serving phases, rehearsed ---------------------------------------------

def _mqar_mamba2(**over):
    """MQAR_MAMBA2_FULL's model cut to vocab 64, d_model 16, N 8."""
    return dict(MQAR_MAMBA2_FULL["model"], vocab_size=V, output_dim=V, hidden_dim=16,
                state_dim=8, seq_len=64, **over)


def test_chip_smoke_mqar_mamba_serving_runs_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.mqar_mamba_serving`` (path 4's ``mamba_serving``) and
    ``mamba_lti_serving`` on a cut of the MQAR Mamba-2 with counting plain
    decay kernels: the decoder from a ``save_checkpoint`` file, prefills of
    24 tokens (chunk 8) and 28 (chunk 4, 7 chunks) launching the forward
    once a layer, each held to the forward and the step path, greedy and
    sampled generation and ``tools.generate`` in a subprocess on the CPU;
    then the forward kernel held and timed at the prefills' operands."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True)
    monkeypatch.setattr(cs, "TF_PROMPT", 24)
    monkeypatch.setattr(cs, "MAMBA_PROMPT_Q16", 28)
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import decay_attention as dattn

    cfg = _mqar_mamba2()
    _, model, _ = build_models(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    path = save_checkpoint(str(tmp_path / "mqar-mamba2"), model,
                           {"model": cfg, "train": {}, "data": {}})
    inputs = torch.from_numpy(_tokens(4, 32, seed=19)).long()
    dev = torch.device("cpu")
    dec = cs.mqar_mamba_serving(dev, path, model, inputs, 2, V)
    lti_dec, lti_model = cs.mamba_lti_serving(dev, cfg, inputs, 2)
    assert lti_model.blocks[0].mamba.__class__.__name__ == "SSD_LTI"
    # three prefills of each model in its phase (the checked one, the timed
    # one and the warm generate's), two greedy generations, the sampled
    # three; the forwards of the prompts and of the stepwise rows
    assert LAUNCHES["decay_attention_fwd"] > 0
    assert not any(v for k, v in LAUNCHES.items() if k != "decay_attention_fwd")
    ph = cs.Phase("timing")
    for n in (24, 28):
        t = cs.decay_fwd_at_prefill(ph, dattn, dec, inputs[:, :n], torch.zeros(4), f"p{n}")
        assert t[4] > 0 and t[5] in ("bytes", "operations")
    assert ph.fields["p24_bg_q_n_hg_p"] == (4 * 3, 8, 8, 1, 16)
    assert ph.fields["p28_bg_q_n_hg_p"] == (4 * 7, 4, 8, 1, 16)


def test_chip_smoke_wt_mamba2_serving_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.wt_mamba2_serving`` (path 8's) on a cut of
    ``configs/wikitext-mamba2-short.yaml`` (2 layers, d_model 32, two heads,
    blocks of 64, vocab 64): the prefill of 8 blocks launching the forward
    once a layer, the float32 and bfloat16 states' generation and the
    bfloat16 state's drift."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True)
    m = load_yaml("configs/wikitext-mamba2-short.yaml")["model"]
    m.update(num_layers=2, hidden_dim=32, state_dim=16, num_heads=2, vocab_size=V, output_dim=V,
             seq_len=64)
    _, model, _ = build_models(m, generator=torch.Generator().manual_seed(5), device="cpu")
    dec = cs.wt_mamba2_serving(torch.device("cpu"), m, model, _tokens(8, 64, seed=20))
    assert dec.state_dtype == torch.float32


def test_chip_smoke_mamba1_serving_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.mamba1_serving`` (path 18's) on a cut of the MQAR
    Mamba-1 with counting plain scan kernels: the prefill launches the
    scan's forward once a layer on the (B, L, d_inner·N) view; then the
    forward kernel held and timed at the prefill's operands."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True)
    mc = dict(MQAR_MAMBA1_SMALL["model"], vocab_size=V, output_dim=V, hidden_dim=16,
              state_dim=4, seq_len=16)
    _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(6), device="cpu")
    prompts = torch.from_numpy(_tokens(4, 12, seed=21)).long()
    dec = cs.mamba1_serving(torch.device("cpu"), mc, model, prompts)
    ph = cs.Phase("timing")
    t = cs.scan_fwd_at_prefill(ph, dec, prompts, torch.zeros(4), "scan")
    assert ph.fields["scan_shape"] == (4, 12, 32 * 4) and t[3] > 0


def test_chip_smoke_catches_a_prefill_that_skips_its_kernel(monkeypatch):
    """The serving phases' launch check: a prefill through the plain decay
    attention (no kernel counted) fails it."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs)  # the decay attention's CPU route: nothing counted
    cfg = _mqar_mamba2()
    _, model, _ = build_models(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    dec = Decoder(cfg, copy.deepcopy(model), device="cpu")
    with pytest.raises(AssertionError, match="prefill launched"):
        cs.mamba_prefill_vs_step(cs.Phase("x"), dec, model,
                                 torch.from_numpy(_tokens(2, 16, seed=22)).long(),
                                 "decay_attention_fwd", 2)
