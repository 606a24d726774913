"""The port's pretrained-LM spectroscopy (``tlie_tpu_torch.analysis.lm_spectra``
and ``python -m tlie_tpu_torch.tools.lm_eigvals``) against tlie_tpu's
``analysis/lm_spectra.py``: the q/k hooks on the Llama and GPT-2 layouts and
the GQA repeat, η from torch q and k, ``lm_attention_spectra`` with its
resumable cache, ``bin_lm_spectra``, the CLI's function driven on a stand-in
LM and one of the port's datasets, and a rehearsal of ``chip_smoke``'s
lm_spectra phase.

The stand-ins are torch modules with random weights (no pretrained model is
in the repository and nothing is downloaded): both packages hook the same
module on the same numpy batches.  Tolerances: η within 1e-5 relative (the
spectra tolerance); the hooks' q and k and the binning exactly.
"""

import numpy as np
import pytest
import torch

from tlie_tpu.analysis import lm_spectra as jax_lm
from tlie_tpu_torch.analysis.lm_spectra import (
    QKHooks, bin_lm_spectra, eta_from_torch_qk, lm_attention_spectra,
)
from tlie_tpu_torch.data import WikiText
from tlie_tpu_torch.tools import lm_eigvals
from torch_parity import load_chip_smoke, stub_card

torch.set_num_threads(1)
VOCAB, D, HEADS = 50, 16, 2


class LlamaAttn(torch.nn.Module):
    """``self_attn`` with ``{q,k,v,o}_proj``; ``kv_heads`` < heads is GQA."""

    def __init__(self, d, heads, kv_heads):
        super().__init__()
        self.heads, self.kv_heads = heads, kv_heads
        kv = d * kv_heads // heads
        self.q_proj, self.k_proj = torch.nn.Linear(d, d), torch.nn.Linear(d, kv)
        self.v_proj, self.o_proj = torch.nn.Linear(d, kv), torch.nn.Linear(d, d)

    def forward(self, x):
        B, L, d = x.shape
        q = self.q_proj(x).reshape(B, L, self.heads, -1).transpose(1, 2)
        k, v = (p(x).reshape(B, L, self.kv_heads, -1).transpose(1, 2)
                for p in (self.k_proj, self.v_proj))
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(o.transpose(1, 2).reshape(B, L, d))


class LlamaLM(torch.nn.Module):
    """Llama-shaped: ``model.layers[i].self_attn.{q,k}_proj``."""

    def __init__(self, n_layers=2, kv_heads=HEADS, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.embed = torch.nn.Embedding(VOCAB, D)
        self.model = torch.nn.Module()
        self.model.layers = torch.nn.ModuleList()
        for _ in range(n_layers):
            layer = torch.nn.Module()
            layer.self_attn = LlamaAttn(D, HEADS, kv_heads)
            self.model.layers.append(layer)

    def forward(self, ids):
        x = self.embed(ids)
        for layer in self.model.layers:
            x = x + layer.self_attn(torch.nn.functional.layer_norm(x, (D,)))
        return x


class GPT2LM(torch.nn.Module):
    """GPT-2-shaped: ``transformer.h[i].attn.c_attn`` (fused qkv)."""

    def __init__(self, n_layers=2, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.wte = torch.nn.Embedding(VOCAB, D)
        self.transformer = torch.nn.Module()
        self.transformer.h = torch.nn.ModuleList()
        for _ in range(n_layers):
            block = torch.nn.Module()
            block.attn = torch.nn.Module()
            block.attn.c_attn = torch.nn.Linear(D, 3 * D)
            self.transformer.h.append(block)

    def forward(self, ids):
        x = self.wte(ids)
        for block in self.transformer.h:
            q, k, v = block.attn.c_attn(x).split(D, -1)
            x = x + v + 0 * (q + k)
        return x


def _batches(n=3, B=2, L=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (B, L)) for _ in range(n)]


# -- the hooks ----------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["llama", "gpt2", "llama_gqa"])
def test_hooks_give_tlie_tpus_q_and_k(layout):
    """Per layer (q, k) split into heads, k repeated over the q heads where
    the model has fewer kv heads, equal to tlie_tpu's ``pop_qk`` on the same
    module and batch; the port keeps them as torch tensors on the model's
    device."""
    lm = {"llama": LlamaLM, "gpt2": GPT2LM, "llama_gqa": lambda: LlamaLM(kv_heads=1)}[layout]()
    ids = torch.from_numpy(_batches(1)[0])
    port, ref = QKHooks(lm), jax_lm.QKHooks(lm)
    with torch.no_grad():
        lm(ids)
    got, want = port.pop_qk(HEADS), ref.pop_qk(HEADS)
    port.remove()
    ref.remove()
    assert len(got) == len(want) == 2 and not port.cache
    for (q, k), (jq, jk) in zip(got, want):
        assert isinstance(q, torch.Tensor) and q.shape == k.shape == (2, 12, HEADS, D // HEADS)
        np.testing.assert_array_equal(q.numpy(), jq)
        np.testing.assert_array_equal(k.numpy(), jk)
    if layout == "llama_gqa":
        np.testing.assert_array_equal(got[0][1][:, :, 0].numpy(), got[0][1][:, :, 1].numpy())


def test_unknown_layouts_raise():
    with pytest.raises(ValueError, match="Unrecognised LM layer layout"):
        QKHooks(torch.nn.Linear(2, 2))
    lm = LlamaLM()
    lm.model.layers[0].self_attn = torch.nn.Identity()
    with pytest.raises(ValueError, match="unsupported attention projections"):
        QKHooks(lm)


@pytest.mark.parametrize("seed", [0, 1])
def test_eta_from_torch_qk_matches_tlie_tpu_and_float64(seed):
    """η (B, L−1, H) from torch q, k against tlie_tpu's on the same arrays
    (1e-5 relative) and against the float64 formula with the masked row-max
    quirk (1e-4 relative, as tests/test_lm_spectra.py holds tlie_tpu's)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 10, 2, 4)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 4)).astype(np.float32)
    got = eta_from_torch_qk(torch.from_numpy(q), torch.from_numpy(k))
    assert got.shape == (2, 9, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_lm.eta_from_torch_qk(q, k), rtol=1e-5, atol=0)
    np.testing.assert_allclose(eta_from_torch_qk(q, k), got, rtol=0, atol=0)  # numpy in
    mask = np.tril(np.ones((10, 10)))[None, :, :, None]
    s = np.einsum("bthd,bshd->btsh", q.astype(np.float64), k.astype(np.float64)) * mask
    m = s.max(2)
    nu = np.exp(s - m[:, :, None, :] * mask).sum(2)
    np.testing.assert_allclose(got, nu[:, :-1] / nu[:, 1:] * np.exp(m[:, :-1] - m[:, 1:]),
                               rtol=1e-4, atol=1e-5)


# -- the spectra and the cache -----------------------------------------------------------

@pytest.mark.parametrize("layout", ["llama", "gpt2"])
def test_lm_attention_spectra_match_tlie_tpu_and_resume(layout, tmp_path):
    """η of every batch (B, L−1, H, layers) against tlie_tpu's run on the
    same module and batches, 1e-5 relative; the cache resumes as tlie_tpu's
    does (a second call with one batch more runs the model once, on the new
    batch); ``all_eigs.npy`` holds the concatenation."""
    lm = LlamaLM() if layout == "llama" else GPT2LM()
    batches = _batches()
    calls = []
    lm.register_forward_hook(lambda *a: calls.append(1))
    first = lm_attention_spectra(lm, batches, HEADS, str(tmp_path / "port"))
    assert first.shape == (6, 11, HEADS, 2) and len(calls) == 3
    want = jax_lm.lm_attention_spectra(lm, batches, HEADS, cache_dir=str(tmp_path / "jax"))
    np.testing.assert_allclose(first, want, rtol=1e-5, atol=0)
    more = batches + _batches(1, seed=5)
    again = lm_attention_spectra(lm, more, HEADS, str(tmp_path / "port"))
    assert len(calls) == 3 + 3 + 1  # tlie_tpu's three, then only the new batch
    assert again.shape == (8, 11, HEADS, 2)
    np.testing.assert_array_equal(again[:6], first)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "all_eigs.npy"), again)
    capped = lm_attention_spectra(lm, more, HEADS, str(tmp_path / "capped"), max_batches=2)
    assert capped.shape == (4, 11, HEADS, 2)
    assert sorted(p.name for p in (tmp_path / "capped").iterdir()) == [
        "all_eigs.npy", "eigs_0.npy", "eigs_1.npy"]


def test_bin_lm_spectra_is_tlie_tpus():
    """The radius percentages per (layer, head) and their mean and std over
    the examples, equal to tlie_tpu's."""
    eigs = np.random.default_rng(3).uniform(0.0, 1.2, (6, 11, 2, 3)).astype(np.float32)
    got, want = bin_lm_spectra(eigs), jax_lm.bin_lm_spectra(eigs)
    assert sorted(got) == sorted(want) == ["percentage", "percentage_mean", "percentage_std"]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    assert got["percentage"].shape == (7, 6, 2, 3)


def test_the_spectra_follow_the_model_device(tmp_path, monkeypatch):
    """Each batch goes to the device of the model's parameters, and η is
    computed on the tensors' device: the batches reach the model as int64
    tensors on its device."""
    lm = LlamaLM()
    seen = []
    lm.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    lm_attention_spectra(lm, _batches(2), HEADS, str(tmp_path))
    assert [(t.device.type, t.dtype) for t in seen] == [("cpu", torch.int64)] * 2


# -- the CLI -----------------------------------------------------------------------

def test_cli_function_on_a_stand_in_and_a_port_dataset(tmp_path, capsys):
    """``lm_eigvals.run`` on a stand-in of the GPT-2 vocabulary and the
    synthetic WikiText stream (block 32): batches of 2 test blocks (the last
    partial one left out), capped at 3; the cache, ``all_eigs.npy`` and the
    three binned arrays written, the summary's shape and first-layer bins
    those of the arrays, the same as tlie_tpu's flow on the same blocks."""
    lm = GPT2LM()
    lm.wte = torch.nn.Embedding(50257, D)
    data = WikiText(block_size=32, synthetic=True, synthetic_train_tokens=64,
                    synthetic_test_tokens=32 * 7 + 3)
    summary = lm_eigvals.run(lm, data, HEADS, str(tmp_path), batch_size=2, max_batches=3)
    assert summary["shape"] == [6, 31, HEADS, 2]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["all_eigs.npy", "eigs_0.npy", "eigs_1.npy", "eigs_2.npy",
                     "percentage.npy", "percentage_mean.npy", "percentage_std.npy"]
    mean = np.load(tmp_path / "percentage_mean.npy")
    assert summary["mean_radius_bins_first_layer"] == mean[:, 0, 0].tolist()
    blocks = data.split("test")[0]
    want = jax_lm.lm_attention_spectra(lm, [blocks[i: i + 2] for i in (0, 2, 4)], HEADS,
                                       cache_dir=str(tmp_path / "jax"))
    np.testing.assert_allclose(np.load(tmp_path / "all_eigs.npy"), want, rtol=1e-5, atol=0)
    assert "all_eigs: (6, 31, 2, 2)" in capsys.readouterr().out


def test_cli_needs_a_cache_dir_and_a_local_model(tmp_path):
    """The CLI writes nowhere by default (``--cache_dir`` is required) and
    loads the model through ``transformers`` only inside ``main``."""
    with pytest.raises(SystemExit):
        lm_eigvals.main(["--model", str(tmp_path)])
    src = open(lm_eigvals.__file__).read()
    assert src.count("import transformers") == 0 and src.count("from transformers") == 1


# -- the card run's lm_spectra phase, rehearsed ------------------------------------------

def test_chip_smoke_lm_spectra_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.lm_spectra_phase`` at 2 layers, d 32, 2 heads, block 64,
    on the CPU with the card stubbed: the resumed cache, η of the same q and
    k within 1e-5, the whole run within its score-derived bound, no port
    kernel launched."""
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs)
    for name, value in (("LMS_LAYERS", 2), ("LMS_D", 32), ("LMS_HEADS", 2), ("LMS_BLOCK", 64)):
        monkeypatch.setattr(cs, name, value)
    cs.lm_spectra_phase(torch.device("cpu"))
