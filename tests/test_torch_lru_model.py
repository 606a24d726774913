"""The port's LRU layer and full MQAR LRU model against tlie_tpu's, on the
same (JAX-initialised, carried) weights and the same batch.

Tolerance: 2e-5 absolute on log-probs and layer outputs — f32 on the CPU,
JAX at HIGHEST matmul precision (tests/conftest.py); the two differ only in
summation order (associative vs sequential scan, matmul blocking).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tlie_tpu.data.base import masked_accuracy as jax_masked_accuracy
from tlie_tpu.models.lru import LRU as JaxLRU
from tlie_tpu.training.steps import prep_batch as jax_prep_batch
from tlie_tpu_torch.compat import params_from_jax
from tlie_tpu_torch.data import masked_accuracy
from tlie_tpu_torch.models import LRU, build_models
from tlie_tpu_torch.training import prep_batch
from torch_parity import jax_apply, jax_weights, port_model, small_config, to_numpy, tokens

torch.set_num_threads(1)
ATOL = 2e-5


def test_lru_layer_matches_jax():
    d_hidden, d_model, batch, length = 16, 8, 2, 40
    jax_lru = JaxLRU(d_hidden, d_model, r_min=0.9, r_max=0.99)
    u = np.random.default_rng(0).standard_normal((batch, length, d_model)).astype(np.float32)
    params = to_numpy(jax.jit(jax_lru.init)(jax.random.PRNGKey(3), jnp.asarray(u))["params"])
    want = np.asarray(jax.jit(jax_lru.apply)({"params": params}, jnp.asarray(u)))

    lru = LRU(d_hidden, d_model, torch.Generator().manual_seed(0), r_min=0.9, r_max=0.99)
    lru.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    with torch.no_grad():
        got = lru(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nontrivial_stats", [False, True], ids=["init_stats", "random_stats"])
def test_small_model_logprobs_match_jax(nontrivial_stats):
    cfg = small_config()["model"]
    eval_model, params, stats = jax_weights(cfg, seed=0, stats_seed=1 if nontrivial_stats else None)
    x = tokens(cfg, batch=2, seed=5)
    want = np.asarray(jax.nn.log_softmax(jax_apply(eval_model, params, stats, x), axis=-1))
    model = port_model(cfg, params, stats)
    with torch.no_grad():
        got = F.log_softmax(model(torch.from_numpy(x).long()), dim=-1).numpy()
    assert got.shape == (2, cfg["seq_len"], cfg["output_dim"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


_VARIANTS = [
    ("full_glu", False, "batch"),
    ("half_glu1", True, "layer"),
    ("half_glu2", False, "batch"),
    ("gelu", True, "layer"),
]


@pytest.mark.parametrize("activation, prenorm, norm", _VARIANTS,
                         ids=[f"{a}-{'pre' if p else 'post'}-{n}" for a, p, n in _VARIANTS])
def test_backbone_variants_match_jax(activation, prenorm, norm):
    cfg = dict(small_config()["model"], input_dim=48, output_dim=48, hidden_dim=12,
               state_dim=10, seq_len=20, activation=activation, prenorm=prenorm, norm=norm)
    eval_model, params, stats = jax_weights(cfg, seed=2)
    x = tokens(cfg, batch=3, seed=6)
    want = jax_apply(eval_model, params, stats, x)
    model = port_model(cfg, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_logprob_output_is_log_softmax_of_logits():
    cfg = dict(small_config()["model"], input_dim=32, output_dim=32, hidden_dim=8, state_dim=8)
    _, model, _ = build_models(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    x = torch.from_numpy(tokens(cfg, batch=2, seed=1, length=16)).long()
    with torch.no_grad():
        logits = model(x)
        model.logits_output = False
        logp = model(x)
    torch.testing.assert_close(logp, F.log_softmax(logits, dim=-1))


def test_params_from_jax_rejects_unmapped_leaves():
    cfg = dict(small_config()["model"], input_dim=32, output_dim=32, hidden_dim=8, state_dim=8,
               seq_len=16)
    _, params, stats = jax_weights(cfg)
    params["encoder"]["layers_0"]["seq"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no place in the port"):
        params_from_jax(params, stats)


def test_prep_batch_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (4, 10))
    y = np.where(rng.random((4, 10)) < 0.5, -100, rng.integers(0, 64, (4, 10)))
    xi, yi = prep_batch((x, y), seq_len=12, in_dim=64, lang_model=True, device="cpu")
    xj, yj = jax_prep_batch((x, y), seq_len=12, in_dim=64, lang_model=True)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(yj))
    xf = x[:, :6].astype(np.float32)  # float ids of another width: one-hot expanded
    np.testing.assert_array_equal(
        prep_batch((xf, y), seq_len=6, in_dim=64, device="cpu")[0].numpy(),
        np.asarray(jax_prep_batch((xf, y), seq_len=6, in_dim=64)[0]))
    logits = rng.standard_normal((4, 10, 64)).astype(np.float32)
    hit = (y >= 0) & (rng.random((4, 10)) < 0.5)
    logits[hit, np.where(hit, y, 0)[hit]] = 9.0  # make about half the labelled positions right
    got = float(masked_accuracy(torch.from_numpy(logits), torch.from_numpy(y)))
    want = float(jax_masked_accuracy(jnp.asarray(logits), jnp.asarray(y)))
    assert got == pytest.approx(want, abs=1e-7)


def test_eval_only_and_other_families_raise():
    """Training mode used to raise; it runs now (dropout, BatchNorm batch
    statistics).  Every family is ported now (S5 builds on the same
    backbone), and a layer that names none raises."""
    cfg = dict(small_config()["model"], input_dim=32, output_dim=32, hidden_dim=8, state_dim=8)
    model, eval_model, _ = build_models(cfg, generator=torch.Generator(), device="cpu")
    x = torch.zeros(2, 4, dtype=torch.long)
    logits = model(x)
    assert model.training and logits.shape == (2, 4, 32) and torch.isfinite(logits).all()
    assert logits.requires_grad
    s5, _, family = build_models(dict(cfg, layer="s5", num_blocks=2),
                                 generator=torch.Generator(), device="cpu")
    assert family == "s5" and s5(x).shape == (2, 4, 32)
    with pytest.raises(RuntimeError, match="not a valid model option"):
        build_models(dict(cfg, layer="s6"), generator=torch.Generator(), device="cpu")


def test_cuda_default_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(small_config()["model"], input_dim=32, output_dim=32, hidden_dim=8, state_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models(cfg, generator=torch.Generator())
