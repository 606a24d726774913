"""The port stands alone: no import of JAX, flax, orbax or tlie_tpu anywhere
in tlie_tpu_torch/ or chip_smoke.py, it runs with JAX made unimportable, and
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
from tlie_tpu_torch.parallel import check_stackable
from tlie_tpu_torch.parallel.sweep import stacked_grads
check_stackable(acfg)
models = [build_models(acfg, generator=torch.Generator().manual_seed(s), device="cpu")[0]
          for s in (1, 2)]
params, buffers = torch.func.stack_module_state(models)
grads, losses = stacked_grads(models[0], None)(
    {{k: v.detach() for k, v in params.items()}}, buffers, x[None].expand(2, -1, -1),
    y[None].expand(2, -1, -1))
assert losses.shape == (2,) and grads["decoder.weight"].shape[0] == 2
bcfg = dict(mcfg, compute_dtype="bfloat16")
_, bm, _ = build_models(bcfg, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    assert bm(x).dtype == torch.bfloat16
assert not any(m in sys.modules and sys.modules[m] is not None for m in {forbidden!r})
print("ok", acc)
"""


def test_the_scan_covers_every_package_of_the_port():
    """parallel/ (the sweeps) is among the files scanned for imports."""
    scanned = {p.relative_to(ROOT).parts[1] for p in PORT_FILES if p.parent != ROOT}
    assert {"parallel", "ops", "models", "training", "analysis"} <= scanned


def test_port_runs_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(forbidden=FORBIDDEN)],
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
