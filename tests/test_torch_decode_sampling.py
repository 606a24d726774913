"""Sampled generation, ``Decoder.from_checkpoint`` and the serving CLI
(``python -m tlie_tpu_torch.tools.generate``) of the port.

``_filter_logits`` is held to tlie_tpu's ``Decoder._filter_logits`` on the
same logits at temperature 1 (the same kept set and the same kept values);
at other temperatures the port takes the nucleus after dividing by the
temperature, and a case built for it shows tlie_tpu's order (the nucleus of
the untempered logits) keeping another set.  Inputs are made with numpy
from a seed.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlie_tpu.inference import Decoder as JaxDecoder
from tlie_tpu_torch.config import MQAR_MAMBA2_FULL
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.tools import generate as generate_cli
from tlie_tpu_torch.training import save_checkpoint
from torch_parity import small_config

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
V = 64
MAMBA = dict(MQAR_MAMBA2_FULL["model"], vocab_size=V, output_dim=V, hidden_dim=16, state_dim=8,
             seq_len=32)


def _kept(logits):
    return np.isfinite(np.asarray(logits))


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, 0.0), (5, 0.5), (0, 0.3), (3, 0.99),
                                         (0, 1e-6), (32, 0.0), (0, 0.0)])
def test_filter_logits_matches_tlie_tpu_at_temperature_1(top_k, top_p):
    """The same kept set and values as tlie_tpu's filter, row by row (ties
    included: rows 2-3 repeat values), and ``sampling_logits`` at
    temperature 1 is that filter."""
    rng = np.random.default_rng(top_k * 100 + int(top_p * 100))
    logits = rng.normal(0.0, 2.0, (5, 32)).astype(np.float32)
    logits[2, :8] = logits[2, 8:16]
    logits[3] = np.round(logits[3])
    want = np.asarray(JaxDecoder._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = Decoder._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(_kept(got), _kept(want))
    np.testing.assert_array_equal(got[_kept(got)], want[_kept(want)])
    tempered = Decoder.sampling_logits(torch.from_numpy(logits), 1.0, top_k, top_p).numpy()
    np.testing.assert_array_equal(tempered, got)
    if top_k == 32:  # past the vocabulary (tlie_tpu's top_k raises there) all are kept
        wide = Decoder._filter_logits(torch.from_numpy(logits), 40, top_p).numpy()
        np.testing.assert_array_equal(wide, got)


def test_the_nucleus_is_taken_after_the_temperature():
    """At temperature 2 and top_p 0.8 the logits (3, 1.5, 1, 0.5, 0) keep
    two tokens untempered (masses 0.67, 0.15) and four tempered (0.43,
    0.20, 0.16, 0.12): the port keeps the tempered four, the set of
    tlie_tpu's filter on the tempered logits, where tlie_tpu's own order
    (filter, then divide; ADVICE.md) keeps two."""
    logits = np.array([[3.0, 1.5, 1.0, 0.5, 0.0]], np.float32)
    got = _kept(Decoder.sampling_logits(torch.from_numpy(logits), 2.0, 0, 0.8))
    tempered = _kept(JaxDecoder._filter_logits(jnp.asarray(logits / 2.0), 0, 0.8))
    tlie_order = _kept(JaxDecoder._filter_logits(jnp.asarray(logits), 0, 0.8))
    np.testing.assert_array_equal(got, tempered)
    assert got.sum() == 4 and tlie_order.sum() == 2


def test_draws_match_the_filtered_softmax():
    """20,000 draws from fixed 8-token logits at temperature 0.7, top_k 6
    and top_p 0.95: each token's frequency within 5 standard errors,
    √(p(1−p)/n), of its probability under the softmax of the tempered and
    filtered logits, and no draw of a filtered token."""
    n = 20_000
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.3, 0.0, -0.5, -1.0, 1.5]])
    p = torch.softmax(Decoder.sampling_logits(logits, 0.7, 6, 0.95), dim=-1)[0].double()
    draws = Decoder.next_token(logits.expand(n, -1), 0.7, 6, 0.95,
                               torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=8).double() / n
    se = torch.sqrt(p * (1 - p) / n)
    assert (p == 0).sum() >= 2 and torch.all(freq[p == 0] == 0)
    assert torch.all((freq - p).abs() <= 5 * se + 1e-12), (freq, p)


@pytest.fixture(scope="module")
def mamba():
    _, model, _ = build_models(MAMBA, generator=torch.Generator().manual_seed(2), device="cpu")
    return Decoder(MAMBA, model, device="cpu"), model


def test_top_k_1_and_tiny_top_p_equal_greedy_and_a_seeded_generator_repeats(mamba):
    dec, _ = mamba
    prompt = np.random.default_rng(3).integers(0, V, (3, 10))
    greedy = dec.generate(prompt, 8)
    for kw in ({"top_k": 1}, {"top_p": 1e-6}):
        out = dec.generate(prompt, 8, temperature=2.0, generator=torch.Generator().manual_seed(1),
                           **kw)
        torch.testing.assert_close(out, greedy, rtol=0, atol=0)
    draws = [dec.generate(prompt, 8, temperature=1.5, top_k=20, top_p=0.9,
                          generator=torch.Generator().manual_seed(s)) for s in (4, 4, 5)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], greedy)
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < V
    with pytest.raises(ValueError, match="Generator"):
        dec.generate(prompt, 2, temperature=0.7)


def test_from_checkpoint_reads_a_save_checkpoint_file(mamba, tmp_path):
    """A Mamba-2 and an LRU with BatchNorm statistics drawn away from their
    init, written by ``save_checkpoint`` and read back by
    ``Decoder.from_checkpoint``: the same stepwise logits as a decoder of
    the live model; ``state_dtype`` passes through."""
    dec, model = mamba
    path = save_checkpoint(str(tmp_path / "mamba"), model, {"model": MAMBA, "train": {}, "data": {}})
    x = np.random.default_rng(6).integers(0, V, (2, 12))
    loaded = Decoder.from_checkpoint(path, device="cpu")
    torch.testing.assert_close(loaded.stepwise_logits(x), dec.stepwise_logits(x), rtol=0, atol=0)
    assert Decoder.from_checkpoint(path, device="cpu",
                                   state_dtype=torch.bfloat16).init_cache(1)[0][1].dtype \
        == torch.bfloat16
    lru = dict(small_config()["model"], input_dim=V, output_dim=V, hidden_dim=8, state_dim=8)
    _, lmodel, _ = build_models(lru, generator=torch.Generator().manual_seed(7), device="cpu")
    gen = torch.Generator().manual_seed(8)
    for name, buf in lmodel.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.3 * torch.randn(buf.shape, generator=gen))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    lpath = save_checkpoint(str(tmp_path / "lru"), lmodel, {"model": lru, "train": {}, "data": {}})
    x = np.random.default_rng(9).integers(0, V, (2, 12))
    torch.testing.assert_close(Decoder.from_checkpoint(lpath, device="cpu").stepwise_logits(x),
                               Decoder(lru, lmodel, device="cpu").stepwise_logits(x),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def checkpoint(mamba, tmp_path_factory):
    _, model = mamba
    stem = tmp_path_factory.mktemp("ckpt") / "mamba"
    return save_checkpoint(str(stem), model, {"model": MAMBA, "train": {}, "data": {}})


def test_generate_cli_prints_one_row_per_line(mamba, checkpoint, capsys):
    """``main``: the random prompt is numpy's ``default_rng(seed)`` draw
    over the vocabulary (tools/generate.py's), the rows the decoder's greedy
    tokens; ``--prompt`` gives one row; sampling repeats with its seed and
    runs with a bfloat16 state."""
    dec, _ = mamba
    assert generate_cli.main([checkpoint, "--n_new", "4", "--batch", "3", "--prompt_len", "5",
                              "--seed", "2", "--device", "cpu"]) == 0
    rows = np.array([[int(t) for t in line.split()] for line in capsys.readouterr().out.splitlines()])
    prompt = np.random.default_rng(2).integers(0, V, (3, 5))
    np.testing.assert_array_equal(rows, dec.generate(prompt, 4).numpy())
    generate_cli.main([checkpoint, "--n_new", "3", "--prompt", "5,9,13", "--device", "cpu"])
    assert capsys.readouterr().out.split()[:3] == ["5", "9", "13"]
    sampled = []
    for _ in range(2):
        generate_cli.main([checkpoint, "--n_new", "6", "--batch", "2", "--seed", "3",
                           "--temperature", "0.8", "--top_k", "10", "--top_p", "0.9",
                           "--state_dtype", "bfloat16", "--device", "cpu"])
        sampled.append(capsys.readouterr().out)
    assert sampled[0] == sampled[1] and len(sampled[0].splitlines()) == 2


def test_generate_module_runs_and_refuses_ids_outside_the_vocab(checkpoint):
    """``python -m tlie_tpu_torch.tools.generate`` on the CPU: 2 rows of 8
    + 4 ids in the vocabulary; an id of the vocabulary's size raises."""
    cmd = [sys.executable, "-m", "tlie_tpu_torch.tools.generate", checkpoint, "--n_new", "4",
           "--batch", "2", "--prompt_len", "8", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [[int(t) for t in line.split()] for line in proc.stdout.splitlines()]
    assert len(rows) == 2 and all(len(r) == 12 and 0 <= min(r) and max(r) < V for r in rows)
    bad = subprocess.run(cmd[:-4] + ["--prompt", f"1,{V}", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "token ids must lie in" in bad.stderr
