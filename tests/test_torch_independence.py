"""The port stands alone: no import of JAX, flax, orbax, tlie_tpu or wandb
anywhere in tlie_tpu_torch/ or chip_smoke.py, and none of matplotlib when a
module is imported; it runs with JAX and matplotlib made unimportable, and
chip_smoke.py fails without a card instead of printing a result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "tlie_tpu", "wandb")
# blocked too where the port runs with JAX unimportable: the card machine has
# no matplotlib, and importing the port must not need it
BLOCKED = FORBIDDEN + ("matplotlib",)
PORT_FILES = sorted((ROOT / "tlie_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tlie_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKED_RUN = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import tlie_tpu_torch
from tlie_tpu_torch.config import MQAR_LRU_FULL
from tlie_tpu_torch.data import MQAR, masked_accuracy
from tlie_tpu_torch.inference import Decoder
from tlie_tpu_torch.models import build_models
from tlie_tpu_torch.training import prep_batch
from tlie_tpu_torch.analysis import eval_eig
cfg = dict(MQAR_LRU_FULL["model"], input_dim=64, output_dim=64, hidden_dim=8,
           state_dim=8, seq_len=16)
_, model, _ = build_models(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
x, y = MQAR(input_seq_length=16, num_kv_pairs=2, vocab_size=64, num_test_examples=4).split("test")
x, y = prep_batch((x, y), 16, 64, lang_model=True, device="cpu")
with torch.no_grad():
    acc = float(masked_accuracy(model(x), y))
out = Decoder(cfg, model).generate(x[:, :8], 2)
assert out.shape == (4, 10), out.shape
from tlie_tpu_torch.config import MQAR_MAMBA2_FULL
mcfg = dict(MQAR_MAMBA2_FULL["model"], vocab_size=64, output_dim=64, hidden_dim=16,
            state_dim=8, seq_len=16)
_, mamba, _ = build_models(mcfg, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert mamba(x).shape == (4, 16, 64)
from tlie_tpu_torch.config import MQAR_SM_ATTENTION_FULL
tcfg = dict(MQAR_SM_ATTENTION_FULL["model"], vocab_size=64, output_dim=64, hidden_dim=16,
            state_dim=16, num_heads=2, max_pos_embed=16, seq_len=16)
tf, tf_eval, _ = build_models(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
tf(x).sum().backward()
assert tf.layers[0].attention.Wqkv.weight.grad is not None
out = Decoder(tcfg, tf_eval).generate(x[:, :8], 4)
assert out.shape == (4, 12), out.shape
from tlie_tpu_torch.config import MQAR_LIN_ATTENTION_FULL, MQAR_NORM_ATTENTION_CONV_FULL
from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
for full in (MQAR_LIN_ATTENTION_FULL, MQAR_NORM_ATTENTION_CONV_FULL):
    acfg = dict(full["model"], vocab_size=64, output_dim=64, hidden_dim=16, state_dim=16,
                num_heads=2, seq_len=16, max_pos_embed=16 if full["model"]["max_pos_embed"] else 0)
    am, am_eval, _ = build_models(acfg, generator=torch.Generator().manual_seed(0), device="cpu")
    am(x).sum().backward()
    assert extract_attention_family(am_eval, x, acfg).shape == (4, 15, 2, 2)
    assert Decoder(acfg, am_eval).generate(x[:, :8], 4).shape == (4, 12)
from tlie_tpu_torch.parallel.sweep import stacked_grads
models = [build_models(acfg, generator=torch.Generator().manual_seed(s), device="cpu")[0]
          for s in (1, 2)]
params, buffers = torch.func.stack_module_state(models)
grads, losses = stacked_grads(models[0], None)(
    {{k: v.detach() for k, v in params.items()}}, buffers, x[None].expand(2, -1, -1),
    y[None].expand(2, -1, -1))
assert losses.shape == (2,) and grads["decoder.weight"].shape[0] == 2
from tlie_tpu_torch.config import MQAR_S4_FULL, MQAR_S5_FULL
from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
for full in (MQAR_S5_FULL, MQAR_S4_FULL):
    scfg = dict(full["model"], input_dim=64, output_dim=64, hidden_dim=8, state_dim=16,
                num_blocks=2, seq_len=16)
    sm, sm_eval, _ = build_models(scfg, generator=torch.Generator().manual_seed(0), device="cpu")
    sm(x).sum().backward()
    eig = extract_ssm_family(ssm_layer_params(sm.state_dict()), scfg)
    assert eig.shape == (8 if full is MQAR_S5_FULL else 16, 2), eig.shape
    assert Decoder(scfg, sm_eval).generate(x[:, :8], 4).shape == (4, 12)
from tlie_tpu_torch.config import LISTOPS_S5_FULL
from tlie_tpu_torch.data import ListOps
lx, ly, ll = ListOps(data_dir="tests/fixtures/listops", l_max=32).split("train")
lcfg = dict(LISTOPS_S5_FULL["model"], hidden_dim=8, state_dim=16, num_blocks=2, num_layers=1,
            seq_len=32)
_, lm, _ = build_models(lcfg, True, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert lm((torch.as_tensor(lx), torch.as_tensor(ll).float())).shape == (len(ly), 10)
from tlie_tpu_torch.config import MQAR_MAMBA1_SMALL, WIKITEXT_NORM_ATTENTION_SHORT
m1cfg = dict(MQAR_MAMBA1_SMALL["model"], vocab_size=64, output_dim=64, hidden_dim=16,
             state_dim=4, seq_len=16)
m1, m1_eval, _ = build_models(m1cfg, generator=torch.Generator().manual_seed(0), device="cpu")
m1(x).sum().backward()
assert m1.blocks[0].mamba.dt_proj.weight.grad is not None
assert extract_attention_family(m1_eval, x, m1cfg).shape == (4, 16, 32 * 4, 2)
wcfg = dict(WIKITEXT_NORM_ATTENTION_SHORT["model"], vocab_size=64, output_dim=64, hidden_dim=16,
            state_dim=16, num_heads=2, mixer_dim=24, num_layers=2, seq_len=16)
wm, wm_eval, _ = build_models(wcfg, generator=torch.Generator().manual_seed(0), device="cpu")
wm(x).sum().backward()
assert wm.layers[0].mixer.encoder.weight.grad is not None
assert Decoder(wcfg, wm_eval).generate(x[:, :8], 4).shape == (4, 12)
import tempfile
from tlie_tpu_torch.analysis.lm_spectra import bin_lm_spectra, lm_attention_spectra
from tlie_tpu_torch.tools import lm_eigvals, plot_spectra, run_truncated  # noqa: F401
from tlie_tpu_torch.utils import RunLogger, profile_trace  # noqa: F401
for bf in (dict(cfg, compute_dtype="bfloat16"), dict(tcfg, compute_dtype="bfloat16")):
    _, bfm, _ = build_models(bf, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        assert bfm(x).dtype == torch.bfloat16
stand_in = torch.nn.Module()
stand_in.model = torch.nn.Module()
stand_in.model.layers = torch.nn.ModuleList([torch.nn.Module()])
stand_in.model.layers[0].self_attn = torch.nn.Module()
stand_in.model.layers[0].self_attn.q_proj = torch.nn.Linear(1, 4)
stand_in.model.layers[0].self_attn.k_proj = torch.nn.Linear(1, 4)
stand_in.forward = lambda ids: stand_in.model.layers[0].self_attn.q_proj(ids[..., None].float()) \
    + stand_in.model.layers[0].self_attn.k_proj(ids[..., None].float())
with tempfile.TemporaryDirectory() as d:
    eigs = lm_attention_spectra(stand_in, [x.numpy()], 2, d)
assert eigs.shape == (4, 15, 2, 1) and bin_lm_spectra(eigs)["percentage"].shape == (7, 4, 2, 1)
from tlie_tpu_torch.config import CIFAR_MAMBA2_LTI_FULL, CIFAR_S4_FULL
from tlie_tpu_torch.data import CIFAR10, MNIST
from tlie_tpu_torch.training.scan_loop import put_dataset
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):  # the loader's summary line
    cx, cy = CIFAR10(grayscale=True, permute="hilbert", augment=True, cutout=True,
                     synthetic=True, synthetic_train=4, synthetic_test=2).split("train")
cdata = put_dataset(cx[:, :64], cy, "cpu")
assert cdata.inputs.dtype == torch.float32 and cdata.inputs.shape == (4, 64, 1)
assert MNIST(permute=False, synthetic=True, synthetic_train=2,
             synthetic_test=2).split("test")[0].shape == (2, 784, 1)
ccfg = dict(CIFAR_MAMBA2_LTI_FULL["model"], hidden_dim=16, num_heads=2, state_dim=8,
            num_layers=2, seq_len=64, chunk_size=16)
cm, cm_eval, _ = build_models(ccfg, generator=torch.Generator().manual_seed(0), device="cpu")
cm(cdata.inputs).sum().backward()
assert cm.encoder.weight.grad is not None and cm.blocks[0].mamba.A.grad is not None
assert extract_attention_family(cm_eval, cdata.inputs, ccfg).shape == (4, 64, 2, 2)
s4cfg = dict(CIFAR_S4_FULL["model"], hidden_dim=8, state_dim=8, num_layers=1, seq_len=64)
_, s4m, _ = build_models(s4cfg, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert s4m(cdata.inputs).shape == (4, 10)
from tlie_tpu_torch.config import CIFAR_NORM_ATTENTION_GATING_FULL, IMDB_MAMBA2_FULL
from tlie_tpu_torch.data import IMDB
with contextlib.redirect_stdout(io.StringIO()):  # the loader's summary line
    ix, iy, il = IMDB(synthetic=True, synthetic_train=4, synthetic_test=2, l_max=64).split("train")
padded = (torch.as_tensor(ix), torch.as_tensor(il).float())
gcfg = dict(CIFAR_NORM_ATTENTION_GATING_FULL["model"], hidden_dim=16, state_dim=8, num_heads=2,
            mixer_dim=8, num_layers=2, seq_len=64)
gm, gm_eval, _ = build_models(gcfg, True, generator=torch.Generator().manual_seed(0), device="cpu")
gm(padded).sum().backward()
assert gm.layers[0].Wz.weight.grad is not None and gm.classifier.decoder.weight.grad is not None
assert extract_attention_family(gm_eval, padded[0], gcfg).shape == (4, 63, 2, 2)
pcfg = dict(IMDB_MAMBA2_FULL["model"], hidden_dim=16, num_heads=2, state_dim=8, num_layers=2,
            seq_len=64, chunk_size=16)
_, pm, _ = build_models(pcfg, True, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert pm(padded).shape == (4, 2)
from tlie_tpu_torch.config import AAN_TRANSFORMER_FULL, PATHFINDER_S4_FULL, SC_S5_MFCC_FULL
from tlie_tpu_torch.data import AAN, PathFinder, SpeechCommands
with contextlib.redirect_stdout(io.StringIO()):  # the loaders' summary lines
    ax, ay = AAN(synthetic=True, synthetic_train=4, synthetic_test=2, l_max=32).split("train")
    fx, fy = PathFinder(synthetic=True, synthetic_train=2, synthetic_test=2).split("train")
    sx, sy = SpeechCommands(mfcc=True, synthetic=True, synthetic_train=2,
                            synthetic_test=2).split("test")
assert ax.shape == (4, 2, 32) and fx.shape == (2, 1024, 1) and sx.shape == (2, 161, 20)
pairs = torch.as_tensor(ax)
for dcfg in (dict(AAN_TRANSFORMER_FULL["model"], hidden_dim=16, state_dim=16, num_heads=2,
                  mixer_dim=8, num_layers=1, max_pos_embed=32, seq_len=32),
             dict(pcfg, dual=True)):
    dm, dm_eval, _ = build_models(dcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    dm(pairs).sum().backward()
    assert dm.match.encoder.weight.grad is not None
    assert extract_attention_family(dm_eval, pairs, dcfg).shape[0] == 8
for full, fin in ((PATHFINDER_S4_FULL, fx[:, :64]), (SC_S5_MFCC_FULL, sx)):
    fcfg = dict(full["model"], hidden_dim=8, state_dim=8, num_layers=1, num_blocks=1,
                seq_len=fin.shape[1])
    _, fm, _ = build_models(fcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        assert fm(torch.as_tensor(fin)).shape == (2, full["model"]["output_dim"])
out = Decoder(mcfg, mamba).generate(x[:, :8], 4)
assert out.shape == (4, 12), out.shape
sampled = Decoder(m1cfg, m1_eval).generate(x[:, :8], 4, temperature=0.8, top_k=8, top_p=0.9,
                                           generator=torch.Generator().manual_seed(0))
assert sampled.shape == (4, 12) and int(sampled.max()) < 64
bcfg = dict(mcfg, compute_dtype="bfloat16")
_, bm, _ = build_models(bcfg, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert bm(x).dtype == torch.bfloat16
_, b1m, _ = build_models(dict(m1cfg, compute_dtype="bfloat16"),
                         generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert b1m(x).dtype == torch.bfloat16
hcfg = dict(tcfg, embedding=False, input_dim=1, mixer="hybrid", classifier=True,
            pooling="mean", output_dim=10)
hm, hm_eval, _ = build_models(hcfg, generator=torch.Generator().manual_seed(0), device="cpu")
hm(cdata.inputs[:, :16]).sum().backward()
assert hm.encoder.weight.grad is not None and hm.layers[0].mixer.alpha.grad.shape == (1,)
from tlie_tpu_torch.parallel import mesh, sequence_parallel
assert mesh.process_shard() is None and mesh.Shard(1, 2).rows(x).shape[0] == 2
# the sequence-parallel route (sp.py, ring.py) in a gloo group of one
mesh.init_process_group("cpu", rank=0, world_size=1,
                        init_method="tcp://127.0.0.1:%d" % mesh.free_port())
try:
    with torch.no_grad():
        plain = [m1_eval(x), tf_eval(x)]
        with sequence_parallel(mesh.Shard(0, 1, axis=1)):
            routed = [m1_eval(x), tf_eval(x)]
    assert all(torch.allclose(a, b, atol=1e-5) for a, b in zip(routed, plain))
    # the tensor-parallel route (tp.py) at m = 1: one vocab-parallel forward
    from tlie_tpu_torch.parallel.tp import VocabParallelLinear
    data, vocab = mesh.mesh_2d(1)
    tp_eval = build_models(tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
                           vocab_shard=vocab)[1]
    with torch.no_grad():
        assert torch.allclose(tp_eval(x), tf_eval(x), atol=1e-5)
    assert isinstance(tp_eval.decoder, VocabParallelLinear) and tp_eval.logit_shard is vocab
finally:
    mesh.destroy_process_group()
assert not any(m in sys.modules and sys.modules[m] is not None for m in {forbidden!r})
print("ok", acc)
"""


def test_the_scan_covers_every_package_of_the_port():
    """parallel/ (the sweeps), tools/ (the lm_eigvals, generate,
    run_truncated and plot_spectra CLIs) and utils/ (the run logger and the
    profiling hooks) are among the files scanned for imports."""
    scanned = {p.relative_to(ROOT).parts[1] for p in PORT_FILES if p.parent != ROOT}
    assert {"parallel", "ops", "models", "training", "analysis", "tools", "utils"} <= scanned
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"tlie_tpu_torch/tools/run_truncated.py", "tlie_tpu_torch/tools/plot_spectra.py",
            "tlie_tpu_torch/utils/logging.py", "tlie_tpu_torch/utils/profiling.py"} <= names


def _module_level_roots(path: Path):
    """The roots a module imports when it is imported: its top-level
    statements' imports, not those inside functions."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_module_imports_matplotlib_when_imported(path):
    """The card machine has no matplotlib: ``plot_spectra`` imports it in
    ``main`` alone, so that every module of the port imports there."""
    assert "matplotlib" not in set(_module_level_roots(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_copied_permutations_and_augmentations_give_the_originals_outputs(seed):
    """``data/permutations.py`` and ``data/augmentations.py`` are copies of
    tlie_tpu's: every permutation at image sizes, and every augmentation on
    the same images from generators of the same seed, bit for bit, with the
    generators left in the same state."""
    import numpy as np

    from tlie_tpu.data import augmentations as jax_aug
    from tlie_tpu.data import permutations as jax_perm
    from tlie_tpu_torch.data import augmentations as aug
    from tlie_tpu_torch.data import permutations as perm

    for fn, args in (("bitreversal_permutation", (1024,)), ("transpose_permutation", (32, 28)),
                     ("snake_permutation", (28, 32)), ("hilbert_permutation", (32,))):
        np.testing.assert_array_equal(getattr(perm, fn)(*args), getattr(jax_perm, fn)(*args))
    images = np.random.default_rng(seed).random((5, 32, 32, 3), dtype=np.float32)
    calls = (("random_crop", {}), ("random_hflip", {}), ("cutout", {"n_holes": 2, "length": 8}),
             ("random_erasing", {"p": 0.9}))
    ours, theirs = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    for name, kw in calls:
        got = getattr(aug, name)(images, ours, **kw)
        want = getattr(jax_aug, name)(images, theirs, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ours.bit_generator.state == theirs.bit_generator.state
    mean, std = [0.4914, 0.4822, 0.4465], [0.247, 0.243, 0.261]
    np.testing.assert_array_equal(aug.np_normalize(images, mean, std),
                                  jax_aug.np_normalize(images, mean, std))


def test_the_copied_imdb_module_gives_the_originals_outputs(monkeypatch):
    """``data/imdb.py`` is a copy of tlie_tpu's without its Hugging Face
    path: the tokenizer, the vocabulary order, the synthetic corpus and the
    aclImdb reader give the original's outputs on the same inputs, and the
    module imports no download package."""
    import numpy as np

    from tlie_tpu.data import imdb as jax_imdb
    from tlie_tpu_torch.data import imdb

    text = "It's a <br />GREAT film (really): \"10/10\"; see it!  Twice..."
    assert imdb.basic_english_tokenize(text) == jax_imdb.basic_english_tokenize(text)
    lists = [list("mississippi"), ["a", "b", "b"], []]
    assert imdb.build_vocab(lists, 2, ["<pad>"]) == jax_imdb.build_vocab(lists, 2, ["<pad>"])
    for seed in (0, 42):
        (t, y), (jt, jy) = imdb._synthetic_reviews(5, seed), jax_imdb._synthetic_reviews(5, seed)
        assert t == jt and np.array_equal(y, jy) and y.dtype == jy.dtype
    got, want = (m._load_acl_imdb(str(ROOT / "tests" / "fixtures" / "aclImdb"))
                 for m in (imdb, jax_imdb))
    assert got[0] == want[0] and got[2] == want[2]
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])
    assert imdb._load_acl_imdb(None) is None and imdb._load_acl_imdb("") is None
    assert not hasattr(imdb, "_load_hf_imdb")
    assert not {"datasets", "huggingface_hub"} & set(_imported_roots(
        ROOT / "tlie_tpu_torch" / "data" / "imdb.py"))


def test_port_runs_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(forbidden=BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok"), line
