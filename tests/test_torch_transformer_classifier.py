"""The port's transformer classifier against tlie_tpu's on the CPU: the
``ClassifierHead`` under each pooling, the classifier transformer (softmax,
linear and norm attention, with and without the ``use_gate`` SiLU gate,
``mixer`` ``mlp`` and ``none``) on padded and unpadded batches, its logits
and every gradient through the pooled loss, the lengths changing nothing,
``compat`` both ways for ``classifier.*`` and ``Wz``, eval_eig's artifacts
of a tokenized-CIFAR classifier, ``launch`` end to end (CIFAR, and a
padded ListOps classifier), the CIFAR
norm-attention YAMLs' float pixels raising at the token embedding as in
tlie_tpu, and a rehearsal of ``chip_smoke``'s paths 22 and 23.

Models run at 2 layers, d_model 16, 2 heads; inputs are made with numpy
from a seed; JAX runs jitted at HIGHEST matmul precision
(tests/conftest.py), at dropout 0.  Tolerances: logits within 2e-5 of
their max, each gradient within 1e-4 of its leaf's max, the loss 1e-5
relative, spectra 1e-5 relative, percentages 1e-5."""

import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tlie_tpu.analysis.compat import torch_state_dict_to_flax
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu.models import layers as jax_layers
from tlie_tpu.models.registry import build_models as jax_build_models
from tlie_tpu.training import scan_loop as jax_scan_loop
from tlie_tpu_torch import launch
from tlie_tpu_torch.analysis import eval_eig
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
from tlie_tpu_torch.compat import flax_path, params_from_jax, params_to_jax
from tlie_tpu_torch.config import CIFAR_NORM_ATTENTION_GATING_FULL, CIFAR_SM_ATTENTION_FULL
from tlie_tpu_torch.data import CIFAR10
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.models.layers import ClassifierHead
from tlie_tpu_torch.training import cross_entropy_loss, save_checkpoint, train_step
from tlie_tpu_torch.training.state import make_family_optimizer
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D, HEADS, MLP, B, L = 16, 2, 8, 3, 24
LENGTHS = np.array([24, 10, 3], np.float32)
OUT_RTOL_OF_MAX, GRAD_RTOL_OF_MAX, EIG_RTOL = 2e-5, 1e-4, 1e-5


def tiny(full=CIFAR_SM_ATTENTION_FULL, seq_len=L, **over):
    """The config's model at 2 layers, d_model 16, d_qk 8, 2 heads, a
    classifier MLP of 8 and a position table of ``seq_len`` (where it has
    one)."""
    mc = dict(full["model"], num_layers=2, hidden_dim=D, state_dim=8, num_heads=HEADS,
              mixer_dim=MLP, seq_len=seq_len)
    if mc["max_pos_embed"]:
        mc["max_pos_embed"] = seq_len
    return dict(mc, **over)


def padded_tokens(seed=0):
    """Tokens (B, L) of 256 grey levels with <pad> (0) past each row's
    length, and the float32 lengths."""
    x = np.random.default_rng(seed).integers(1, 256, (B, L)).astype(np.int32)
    x[np.arange(L)[None, :] >= LENGTHS[:, None]] = 0
    return x, LENGTHS.copy()


def rel_to_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_model(model_cfg, x, seed=0):
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=True)
    return jeval, to_numpy(jax.jit(jeval.init)(jax.random.PRNGKey(seed), x)["params"])


def _port(model_cfg, params):
    model, eval_model, family = build_models(model_cfg, True, generator=torch.Generator(),
                                             device="cpu")
    assert family == "transformer"
    model.load_state_dict(params_from_jax(params))
    return model, eval_model


# -- the head ------------------------------------------------------------------------------

@pytest.mark.parametrize("mlp_dim", [MLP, 0], ids=["mlp8", "no_mlp"])
@pytest.mark.parametrize("pooling", ["mean", "max", "sum", "cls", "none"])
def test_classifier_head_matches_jax(pooling, mlp_dim):
    """The pool (unmasked; ``none`` keeps every position) and, with an MLP,
    encoder → ReLU → decoder with flax's weights carried over: within 2e-5
    of the max; the head's keys are ``encoder`` and ``decoder``."""
    x = np.random.default_rng(1).standard_normal((B, 7, D)).astype(np.float32)
    jm = jax_layers.ClassifierHead(mlp_dim, 10, pooling)
    params = to_numpy(jax.jit(jm.init)(jax.random.PRNGKey(0), x)).get("params", {})
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    head = ClassifierHead(D, mlp_dim, 10, pooling, torch.Generator())
    if mlp_dim:
        head.load_state_dict({f"{n}.{k}": torch.from_numpy(
            np.ascontiguousarray(v.T if k == "weight" else v))
            for n in ("encoder", "decoder") for k, v in (
                ("weight", params[n]["kernel"]), ("bias", params[n]["bias"]))})
    else:
        assert not params and not list(head.parameters())
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL_OF_MAX * np.abs(want).max())


# -- the classifier transformer --------------------------------------------------------------

_ATTENTION = {
    "softmax": dict(attention_fn="sm-attention"),
    "linear": dict(attention_fn="lin-attention"),
    "norm": {k: CIFAR_NORM_ATTENTION_GATING_FULL["model"][k] for k in (
        "attention_fn", "norm_fn", "approx_fn", "scale_B", "offset", "offset_init",
        "dim_conv")},
}


@pytest.mark.parametrize("mixer", ["mlp", "none"])
@pytest.mark.parametrize("gate", [False, True], ids=["plain", "gate"])
@pytest.mark.parametrize("attention", sorted(_ATTENTION))
def test_classifier_logits_and_every_gradient_match_jax(attention, gate, mixer):
    """The classifier on 3 padded rows (lengths 24, 10, 3): the eval logits
    of ``(tokens, lengths)`` equal those of the tokens alone bit for bit
    (the lengths are dropped, on both sides), within 2e-5 of tlie_tpu's
    max; the mean CE through the port's ``cross_entropy_loss`` within 1e-5
    relative of tlie_tpu's, every leaf's gradient (``Wz``, the head's
    ``classifier.*`` among them) within 1e-4 of its max."""
    model_cfg = tiny(**_ATTENTION[attention], use_gate=gate, mixer=mixer)
    x, lengths = padded_tokens()
    y = np.array([3, 0, 7])
    jeval, params = _jax_model(model_cfg, (x, lengths))
    assert ("Wz" in params["layers_0"]) == gate and set(params["classifier"]) == {
        "encoder", "decoder"} and "decoder" not in params

    def jloss(params):
        logits = jeval.apply({"params": params}, (x, lengths))
        return jax_scan_loop.cross_entropy_loss(logits, y), logits

    (jl, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want = np.asarray(want)
    japply = jax.jit(jeval.apply)
    np.testing.assert_array_equal(np.asarray(japply({"params": params}, x)),
                                  np.asarray(japply({"params": params}, (x, lengths))))
    model, eval_model = _port(model_cfg, params)
    tokens = torch.from_numpy(x).long()
    with torch.no_grad():
        plain = eval_model(tokens)
    logits = model((tokens, torch.from_numpy(lengths)))
    assert logits.shape == want.shape == (B, 10)
    torch.testing.assert_close(logits.detach(), plain, rtol=0, atol=0)
    assert rel_to_max(logits.detach().numpy(), want) <= OUT_RTOL_OF_MAX
    loss = cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    got, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(to_numpy(jgrads))
    assert len(jax.tree_util.tree_leaves(got)) == len(leaves)
    for (path, g), (jpath, ref) in zip(jax.tree_util.tree_leaves_with_path(got), leaves):
        assert path == jpath
        np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(ref).max(),
                                   err_msg=str(path))


def test_the_gate_is_initialised_as_tlie_tpus():
    """``Wz``: xavier-uniform of gain 0.1 (bound 0.1·√(6 / 2d)), bias 1;
    the gated block returns (x + y)·SiLU(Wz x) with the MLP mixer and
    y·SiLU(Wz x) with ``mixer: none``, z taken from the block's input."""
    model, _, _ = build_models(tiny(use_gate=True, num_layers=1, hidden_dim=256, state_dim=64),
                               generator=torch.Generator().manual_seed(0), device="cpu")
    wz = model.layers[0].Wz
    bound = 0.1 * np.sqrt(6.0 / 512)
    w = wz.weight.detach().numpy()
    assert w.shape == (256, 256) and np.abs(w).max() <= bound
    assert np.abs(w).max() > 0.98 * bound and abs(w.std() - bound / np.sqrt(3)) < 0.02 * bound
    torch.testing.assert_close(wz.bias, torch.ones(256))
    for mixer in ("mlp", "none"):
        block = build_models(tiny(use_gate=True, mixer=mixer), generator=torch.Generator(),
                             device="cpu")[1].layers[0]
        h = torch.randn(2, 5, D)
        with torch.no_grad():
            r = h + block.attention(block.norm(h))
            y = block.norm(r)
            if mixer == "mlp":
                y = r + block.mixer(y)
            torch.testing.assert_close(block(h), y * torch.nn.functional.silu(block.Wz(h)))


def test_compat_carries_the_classifier_and_the_gate_both_ways():
    """``classifier.{encoder,decoder}.{weight,bias}`` ↔
    ``params/classifier/{encoder,decoder}/{kernel,bias}`` and
    ``layers.{i}.Wz.{weight,bias}`` ↔ ``params/layers_i/Wz/{kernel,bias}``:
    params_from_jax then params_to_jax gives flax's tree back bit for bit,
    and tlie_tpu's own ``torch_state_dict_to_flax`` maps the port's
    state_dict onto the same tree."""
    # the softmax classifier with the gate: tlie_tpu's torch_state_dict_to_flax
    # names norm attention's offset ``attention.inner_attn.offset``, the
    # reference's module path, where the port keeps ``attention.offset``
    model_cfg = tiny(use_gate=True)
    x, lengths = padded_tokens()
    _, params = _jax_model(model_cfg, (x, lengths))
    model, _ = _port(model_cfg, params)
    sd = model.state_dict()
    assert {"classifier.encoder.weight", "classifier.encoder.bias", "classifier.decoder.weight",
            "classifier.decoder.bias", "layers.1.Wz.weight", "layers.1.Wz.bias"} <= set(sd)
    assert "decoder.weight" not in sd and sd["classifier.encoder.weight"].shape == (MLP, D)
    assert flax_path("classifier.decoder.weight") == ("params", "classifier", "decoder", "kernel")
    assert flax_path("layers.1.Wz.bias") == ("params", "layers_1", "Wz", "bias")
    mine, stats = params_to_jax(sd)
    theirs = torch_state_dict_to_flax(sd, "transformer")
    assert stats is None
    for a, b, c in zip(jax.tree_util.tree_leaves_with_path(mine),
                       jax.tree_util.tree_leaves_with_path(theirs),
                       jax.tree_util.tree_leaves_with_path(params)):
        assert a[0] == b[0] == c[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[1])
    back = params_from_jax(mine)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_what_stays_refused():
    """The dual head builds (tests/test_torch_aan_dual.py) and decoding it
    raises, as decoding a classifier transformer does; a gated LM decodes
    (tests/test_torch_decode_mamba.py holds it to tlie_tpu), its step path
    equal to its forward (2e-5 of max|logit|)."""
    mc = tiny()
    dual = build_models(dict(mc, dual=True), generator=torch.Generator(), device="cpu")[1]
    with pytest.raises(ValueError, match="dual"):
        Decoder(dict(mc, dual=True, classifier=False), dual, device="cpu")
    lm = dict(mc, classifier=False, use_gate=True)
    model = build_models(lm, generator=torch.Generator(), device="cpu")[1]
    x = torch.randint(0, lm["vocab_size"], (2, 12), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = model(x)
    torch.testing.assert_close(Decoder(lm, model, device="cpu").stepwise_logits(x), full,
                               rtol=0, atol=2e-5 * full.abs().max().item())
    with pytest.raises(ValueError, match="classifier"):
        Decoder(mc, build_models(mc, generator=torch.Generator(), device="cpu")[1],
                device="cpu")


def test_cifar_norm_attention_yamls_feed_float_pixels_to_the_embedding_and_raise():
    """``cifar-norm-attention-*.yaml`` set ``embedding: true`` without the
    dataset's ``tokenize: true``: the loader gives float pixels (n, 1024,
    1), and the token embedding raises flax ``Embed``'s ``ValueError`` on
    both sides.  The same model on tokenized pixels runs."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / "cifar" /
                          "cifar-norm-attention-gating.yaml").read_text())
    assert "tokenize" not in cfg["dataset"] and cfg["model"]["embedding"]
    small = {"synthetic": True, "synthetic_train": 4, "synthetic_test": 2}
    x, _ = CIFAR10(**dict(cfg["dataset"], **small)).split("test")
    assert x.shape == (2, 1024, 1) and x.dtype == np.float32
    model_cfg = tiny(CIFAR_NORM_ATTENTION_GATING_FULL, seq_len=1024)
    _, jeval, _ = jax_build_models(dict(model_cfg), padded=False)
    with pytest.raises(ValueError, match="Input type must be an integer"):
        jeval.init(jax.random.PRNGKey(0), x)
    _, model, _ = build_models(model_cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="Input type must be an integer"):
        model(torch.from_numpy(x))
    tokens, _ = CIFAR10(**dict(cfg["dataset"], tokenize=True, **small)).split("test")
    with torch.no_grad():
        assert model(torch.from_numpy(tokens)).shape == (2, 10)


# -- eval_eig ---------------------------------------------------------------------------------

def test_eig_att_norm_takes_a_subnormal_n_as_zero_as_tlie_tpu():
    """Where exp(−softplus(n)) lands among float32's subnormals (n ≈ 90, four
    steps of one row: exp(−90) ≈ 8e-40), XLA flushes it to zero and
    ``tlie_tpu`` puts 2e-23 in its place; the port does the same, so η
    stays finite and equal (1e-5 relative) where it was inf before (the
    gated CIFAR classifier's trained η on the card, path 23)."""
    from tlie_tpu.analysis.extractors import eig_att_norm as jax_eig_att_norm
    from tlie_tpu_torch.analysis.extractors import eig_att_norm

    rng = np.random.default_rng(7)
    d_model, d_qk, H, T = 8, 6, 2, 16
    x = rng.standard_normal((2, T, d_model)).astype(np.float32)
    W = (rng.standard_normal((d_model, d_model + 2 * d_qk + H)) * 0.1).astype(np.float32)
    b = np.zeros(d_model + 2 * d_qk + H, np.float32)
    x[..., 0] = 0.0
    x[1, 5:9, 0] = 90.0 / 7.0
    W[0, d_model + 2 * d_qk:] = 7.0
    fn = jax.jit(jax_eig_att_norm, static_argnums=(3, 4, 5), static_argnames=("norm_fn",))
    want = np.asarray(fn(x, W, b, d_qk, d_model, H, norm_fn="softplus"))
    got = eig_att_norm(torch.from_numpy(x), torch.from_numpy(W.T.copy()), torch.from_numpy(b),
                       d_qk, d_model, "softplus").numpy()
    n = np.exp(-np.logaddexp(0.0, (x @ W)[1, 5:9, d_model + 2 * d_qk:].astype(np.float64)))
    assert np.all((n > 1e-45) & (n < np.finfo(np.float32).tiny))  # subnormal in float32
    assert np.isfinite(got).all() and got.shape == want.shape == (2, T - 1, H)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got[1, 5:8], 1.0)



# ten times the CIFAR configs' 2e-4: two AdamW steps move every weight by
# about 4e-3.  At 0.02 and above the gated norm attention's second block
# output reaches 500, its n-projections differ by 76 between neighbours, so
# η = exp(z_t − z_{t+1}) reaches 1e33 and the float32 rounding of z (1e-7 of
# 500 on either side) alone moves η by 1e-4: that tests the exponent's
# conditioning, not the port
LR_EIG = 0.002


@pytest.mark.parametrize("full", [CIFAR_SM_ATTENTION_FULL, CIFAR_NORM_ATTENTION_GATING_FULL],
                         ids=["softmax", "norm_gate"])
def test_eval_eig_artifacts_of_a_tokenized_cifar_classifier_match_tlie_tpu(full, tmp_path):
    """From one port checkpoint (the tiny classifier after two steps of
    LR_EIG on 8 tokenized synthetic images), both packages write the same 12
    artifacts under the same name from 4 test images of 1,024 tokens: η
    (4, 1023, 2, 2) within 1e-5 relative, the percentages within 1e-5, the
    report's trained lines equal, η from the live model equal; the head
    never enters the spectra."""
    model_cfg = tiny(full, seq_len=1024)
    args = copy.deepcopy(full)
    args["model"] = model_cfg
    args["dataset"] = dict(full["dataset"], tokenize=True)
    data = CIFAR10(**dict(args["dataset"], synthetic=True, synthetic_train=8,
                          synthetic_test=4))
    (tx, ty), (vx, _) = data.split("train"), data.split("test")
    model, _, _ = build_models(model_cfg, generator=torch.Generator().manual_seed(1),
                               device="cpu")
    opt, clip = make_family_optimizer(model, "transformer", model_cfg, args["train"],
                                      {"lr": LR_EIG, "wd": 0.0, "betas": (0.9, 0.999)})
    for _ in range(2):
        train_step(model, opt, torch.from_numpy(tx), torch.from_numpy(ty), {"regular": LR_EIG},
                   None, clip_norm=clip)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model, {"model": model_cfg})
    port_out = eval_eig(args, {"save_path": str(tmp_path / "port")}, 0.5, ckpt, device="cpu",
                        batch=vx)
    trained, _ = params_to_jax(model.state_dict())
    jax_out = jax_eval_eig(args, {"save_path": str(tmp_path / "jax")}, None, args["dataset"],
                           [(vx.astype(np.int32), np.zeros(4, np.int64), {"lengths": 1024})],
                           ckpt, 0.5, params=trained)
    (pdir,), (jdir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert pdir == jdir and pdir.startswith(f"CIFAR-10dmodel{D}")
    assert sorted(os.listdir(tmp_path / "port" / pdir)) == sorted(
        os.listdir(tmp_path / "jax" / jdir)) == ARTIFACT_FILES
    eig, eig_init = port_out[0], port_out[1]
    assert eig.shape == eig_init.shape == (4, 1023, HEADS, 2) and eig.dtype == np.float32
    assert np.all(eig_init > 0)
    np.testing.assert_allclose(eig, np.asarray(jax_out[0]), rtol=EIG_RTOL, atol=0)
    for name in ("percentage", "percentage_phase", "percentage_mean", "percentage_std"):
        got = np.load(tmp_path / "port" / pdir / f"{name}.npy")
        want = np.load(tmp_path / "jax" / jdir / f"{name}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    trained_lines = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                               if "radius:" in ln]
    assert (trained_lines(tmp_path / "port" / pdir / "percentage_file.txt")
            == trained_lines(tmp_path / "jax" / jdir / "percentage_file.txt"))
    with torch.no_grad():
        live = extract_attention_family(model.eval(), torch.from_numpy(vx), model_cfg)
    np.testing.assert_array_equal(live, eig)


# -- launch -----------------------------------------------------------------------------------

def test_launch_trains_and_analyses_a_cifar_transformer_on_the_cpu(tmp_path, monkeypatch,
                                                                   capsys):
    """``launch.main`` on ``cifar-sm-attention.yaml`` cut to 2 layers, d_model
    16, 2 heads, the classifier MLP of 8, 1 epoch of 4 steps (batch 8 of 32
    tokenized synthetic images), analysis batch 8: the checkpoint and the 12
    artifacts are written, η (8, 1023, 2, 2) positive."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / "cifar" /
                          "cifar-sm-attention.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / "cifar-sm-attention")
    cfg["dataset"].update(synthetic_train=32, synthetic_test=16, data_dir=str(tmp_path / "none"))
    cfg["train"].update(num_epochs=1, batch_size=8, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=D, state_dim=8, num_heads=HEADS, mixer_dim=MLP)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 8, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "torchvision binaries not found" in out and "step 4:" in out and "Finished!" in out
    (ckpt,) = os.listdir(tmp_path / "checkpoint")
    assert ckpt.endswith(".pth")
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith(f"CIFAR-10dmodel{D}")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (8, 1023, HEADS, 2) and np.all(eig > 0) and np.isfinite(eig).all()


def test_launch_trains_a_padded_listops_transformer_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``launch.main`` on ``listops-sm-attention.yaml`` cut to 2 layers,
    d_model 16, 2 heads, the classifier MLP of 8, l_max 64 and a position
    table of 64, 1 epoch of 4 steps at batch 2 on the fixture's TSVs
    (dropout 0.1 as configured): the padded split trains through the pooled
    loss, the checkpoint and the 12 artifacts are written, η (4, 63, 2, 2)
    positive on the analysis batch's tokens."""
    cfg = yaml.safe_load((ROOT / "configs" / "tasks" / "listops" /
                          "listops-sm-attention.yaml").read_text())
    cfg["save"] = str(tmp_path / "checkpoint" / "listops-sm-attention")
    cfg["dataset"].update(l_max=64, data_dir=str(ROOT / "tests" / "fixtures" / "listops"))
    cfg["train"].update(num_epochs=1, batch_size=2, warmup=0)
    cfg["model"].update(num_layers=2, hidden_dim=D, state_dim=8, num_heads=HEADS, mixer_dim=MLP,
                        max_pos_embed=64)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    an_path = tmp_path / "analysis.yaml"
    an_path.write_text(yaml.safe_dump({"batch_size": 4, "save_path": str(tmp_path / "analysis")}))
    monkeypatch.chdir(tmp_path)
    assert launch.main(["--config", str(cfg_path), "--analysis_config", str(an_path),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 4:" in out and "Finished!" in out
    (run,) = os.listdir(tmp_path / "analysis")
    assert run.startswith(f"LISTOPSdmodel{D}")
    assert sorted(os.listdir(tmp_path / "analysis" / run)) == ARTIFACT_FILES
    eig = np.load(tmp_path / "analysis" / run / "eig.npy")
    assert eig.shape == (4, 63, HEADS, 2) and np.all(eig > 0) and np.isfinite(eig).all()


# -- the card run's paths 22 and 23, rehearsed ------------------------------------------------

@pytest.mark.parametrize("tag,full", [("cifar_sm_attention", CIFAR_SM_ATTENTION_FULL),
                                      ("cifar_norm_attention_gating",
                                       CIFAR_NORM_ATTENTION_GATING_FULL)])
def test_chip_smoke_paths_22_and_23_run_on_the_cpu(monkeypatch, tag, full):
    """``chip_smoke.cifar_path`` on the classifier at 2 layers, d_model 16, 2
    heads on 16 + 8 tokenized synthetic images at batch 4 (4 steps an
    epoch), the card's timers and profiler stubbed and the flash attention's
    and the decay attention's kernels replaced by counting plain versions:
    the forward, training, the spectra, the card step against float64 and
    the timing all run, and no kernel launches."""
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa

    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, decay_kernels=True)

    def counting(name, fn):
        def run(*args):
            LAUNCHES[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(fa, "_on_cuda", lambda t: True)
    for name, plain in (("fwd", fa.flash_attention_plain),
                        ("bwd_dkv", fa.flash_attention_bwd_dkv_plain),
                        ("bwd_dq", fa.flash_attention_bwd_dq_plain)):
        monkeypatch.setattr(fa, f"flash_attention_{name}_cuda",
                            counting(f"flash_attention_{name}", plain))
    for name, value in (("CIFAR_EPOCHS", {tag: 2}), ("CIFAR_ANALYSIS_BATCH", 4),
                        ("CIFAR_STEP_EXAMPLES", 2)):
        monkeypatch.setattr(cs, name, value)
    cut = copy.deepcopy(full)
    cut["dataset"].update(synthetic_train=16, synthetic_test=8, tokenize=True)
    cut["train"].update(batch_size=4, train_size=16)
    cut["model"].update(num_layers=2, hidden_dim=D, state_dim=8, num_heads=HEADS, mixer_dim=MLP)
    launches = cs.cifar_path(torch.device("cpu"), ARTIFACT_FILES, cut, tag, torch.zeros(4))
    assert not any(launches.values()) and set(launches) == set(LAUNCHES)
