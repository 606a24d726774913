"""The port's LRU Decoder against tlie_tpu's on carried weights: prefill
logits and cache (2e-5 absolute, f32 on the CPU), greedy tokens (equal), and
the step path against the full forward.  The Mamba family and sampling are
tests/test_torch_decode_mamba.py's and tests/test_torch_decode_sampling.py's."""

import numpy as np
import pytest
import torch

from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu_torch.inference import Decoder
from torch_parity import jax_weights, port_model, small_config, tokens

torch.set_num_threads(1)
ATOL = 2e-5
PROMPT_LEN, N_NEW = 40, 8


@pytest.fixture(scope="module")
def decoders():
    cfg = small_config()["model"]
    _, params, stats = jax_weights(cfg, seed=7)
    model = port_model(cfg, params, stats)
    return cfg, JaxDecoder(cfg, params, batch_stats=stats), Decoder(cfg, model.state_dict(), device="cpu"), model


def test_prefill_logits_and_cache_match_jax(decoders):
    cfg, jdec, dec, _ = decoders
    prompt = tokens(cfg, batch=3, seed=11, length=PROMPT_LEN)
    jcache, jlogits = jdec.prefill(prompt)
    cache, logits = dec.prefill(prompt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    assert len(cache) == len(jcache) == cfg["num_layers"]
    for (hr, hi), (jr, ji) in zip(cache, jcache):
        assert hr.shape == (3, cfg["state_dim"])
        np.testing.assert_allclose(hr.numpy(), np.asarray(jr), rtol=0, atol=ATOL)
        np.testing.assert_allclose(hi.numpy(), np.asarray(ji), rtol=0, atol=ATOL)


def test_greedy_tokens_match_jax(decoders):
    cfg, jdec, dec, _ = decoders
    prompt = tokens(cfg, batch=3, seed=12, length=PROMPT_LEN)
    want = np.asarray(jdec.generate(prompt, N_NEW))
    got = dec.generate(prompt, N_NEW).numpy()
    assert got.shape == (3, PROMPT_LEN + N_NEW)
    np.testing.assert_array_equal(got, want)


def test_stepwise_logits_match_full_forward(decoders):
    cfg, _, dec, model = decoders
    x = tokens(cfg, batch=2, seed=13)
    with torch.no_grad():
        full = model(torch.from_numpy(x).long())
    step = dec.stepwise_logits(x)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    _, last = dec.prefill(x)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=0, atol=ATOL)


def test_decoder_takes_a_built_model(decoders):
    cfg, _, dec, model = decoders
    prompt = tokens(cfg, batch=2, seed=14, length=PROMPT_LEN)
    np.testing.assert_array_equal(Decoder(cfg, model).generate(prompt, 3).numpy(),
                                  dec.generate(prompt, 3).numpy())


@pytest.mark.parametrize("bad", [-1, 256], ids=["negative", "vocab"])
def test_prompt_ids_outside_the_vocab_raise(decoders, bad):
    cfg, _, dec, _ = decoders
    prompt = tokens(cfg, batch=1, seed=15, length=8)
    prompt[0, 3] = bad
    with pytest.raises(ValueError, match="token ids must lie in"):
        dec.generate(prompt, 2)


def test_sampling_and_other_families_are_not_ported(decoders):
    """Sampling and the Mamba family are served now: sampling without a
    ``torch.Generator`` raises, and so does a Mamba model without a token
    embedding (the decoder serves token LMs)."""
    cfg, _, dec, model = decoders
    with pytest.raises(ValueError, match="Generator"):
        dec.generate(tokens(cfg, batch=1, length=4), 2, temperature=0.7)
    out = dec.generate(tokens(cfg, batch=1, length=4), 2, temperature=0.7,
                       generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 6) and int(out.max()) < cfg["input_dim"]
    with pytest.raises(ValueError, match="token_embedding"):
        Decoder(dict(cfg, layer="mamba", token_embedding=False), model, device="cpu")
