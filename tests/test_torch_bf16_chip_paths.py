"""``chip_smoke.py``'s paths 32-34 (bf16 compute for the LRU, transformer
and S5 families) rehearsed on the CPU at tiny widths, with the card's
timers stubbed and the scan's, the fused head's and the flash attention's
wrappers replaced by counting plain versions: every check of the paths
(the exact launch counts, the bf16 log-probs against float32, the float32
spectra and serving, the card step against the CPU step, the trace, the
stacked wave against its serial run) runs as on the card."""

import copy
import os

import pytest
import torch

from tlie_tpu_torch import config as config_mod
from tlie_tpu_torch.data import MQAR
from torch_parity import ARTIFACT_FILES, load_chip_smoke, stub_card

torch.set_num_threads(1)

MQAR_TINY = dict(input_seq_length=64, num_kv_pairs=8, vocab_size=256, num_train_examples=128,
                 num_test_examples=64)


def _card(monkeypatch):
    cs = load_chip_smoke()
    stub_card(monkeypatch, cs, scan_kernels=True, head_kernels=True, attention_kernels=True)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return cs


def _mqar_tiny(full):
    tiny = copy.deepcopy(full)
    tiny["dataset"].update(MQAR_TINY)
    tiny["train"]["batch_size"] = 16
    tiny["model"].update(seq_len=64, output_dim=256, hidden_dim=32, state_dim=32)
    for key, value in (("vocab_size", 256), ("input_dim", 256), ("max_pos_embed", 64),
                       ("num_heads", 2), ("mixer_dim", 32)):
        if key in tiny["model"] and tiny["model"][key]:
            tiny["model"][key] = value
    return tiny


def _mqar_data():
    data = MQAR(**MQAR_TINY)
    return data.split("train"), data.split("test")


def test_chip_smoke_path_32_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.wikitext_lru_bf16_path`` on a cut of its config (2
    layers, d_model and N 32, block 64, batch 2, 2 steps) through
    ``run_truncated``: the scan's kernels and the fused head's three
    bfloat16 kernels, no float32 head kernel, the float32 spectra, the
    card step against the CPU step, the trace file with its two regions,
    and serving in float32 through the scan's forward."""
    cs = _card(monkeypatch)
    real_load = config_mod.load_yaml

    def tiny_load(path):
        cfg = real_load(path)
        name = os.path.basename(str(path))
        if name.startswith("wikitext-mamba2"):
            cfg["dataset"].update(block_size=64, synthetic_train_tokens=64 * 12,
                                  synthetic_test_tokens=64 * 8)
        if name.startswith("wikitext-lru-short"):
            cfg["model"].update(num_layers=2, hidden_dim=32, state_dim=32)
            cfg["train"]["batch_size"] = 2
        return cfg

    monkeypatch.setattr(config_mod, "load_yaml", tiny_load)
    for name, value in (("LM_STEPS", 2), ("LM_STEP_BLOCKS", 2), ("WT_BF16_PROMPT", 48)):
        monkeypatch.setattr(cs, name, value)
    splits = cs.wikitext_splits()
    launches, step = cs.wikitext_lru_bf16_path(torch.device("cpu"), splits, ARTIFACT_FILES,
                                               {"ms_per_step": "1.000"})
    # training (2 steps, 4 eval batches, 2 layers) and serving: three
    # prefills (one, then one a generate) and three full forwards to hold them
    # to, once a layer each; the O(1) step path launches none, and the card
    # step against the CPU and the timed steps are not the path's
    assert {k: v for k, v in launches.items() if v} == {
        "diag_scan": 2 * (2 + 4) + 2 * 3 + 2 * 3, "diag_scan_bwd": 2 * 2,
        "fused_xent_fwd_bf16": 2, "fused_xent_dh_bf16": 2, "fused_xent_dw_bf16": 2}
    assert "ms_per_step" in step


def test_chip_smoke_path_33_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.sm_attention_bf16_path`` on a tiny cut of
    ``MQAR_SM_ATTENTION_FULL`` (L 64, d_model 32, two heads, 4 steps): the
    bf16 log-probs against float32, the flash kernels' exact launches and
    no materialised softmax, the float32 spectra, serving and the card step
    against the CPU step."""
    cs = _card(monkeypatch)
    monkeypatch.setattr(config_mod, "MQAR_SM_ATTENTION_FULL",
                        _mqar_tiny(config_mod.MQAR_SM_ATTENTION_FULL))
    for name, value in (("TF_STEPS", 4), ("TF_EVAL_EVERY", 2), ("TF_PROMPT", 48),
                        ("TRAIN_EXAMPLES", MQAR_TINY["num_train_examples"])):
        monkeypatch.setattr(cs, name, value)
    (train_x, train_y), (test_x, test_y) = _mqar_data()
    launches = cs.sm_attention_bf16_path(torch.device("cpu"), test_x, test_y, (train_x, train_y),
                                         ARTIFACT_FILES)
    # 2 layers: the forwards (2 + 2), training (4 steps, 2 × 4 eval batches),
    # eval_eig's two, the prefill's and the serving checks' forwards
    assert launches["flash_attention_bwd_dkv"] == launches["flash_attention_bwd_dq"] == 2 * 4
    assert launches["flash_attention_fwd"] > 2 * (2 + 4 + 8 + 2 + 1)
    assert not any(v for k, v in launches.items() if not k.startswith("flash_attention"))


def test_chip_smoke_path_34_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.bf16_wave_path``: four bf16 seeds of a tiny cut of
    ``MQAR_LIN_ATTENTION_FULL`` stacked (4 steps, an eval every 2), the
    resume, one point against its serial run at the bf16 tolerances, the
    stacked step against a serial one, no port kernel; then one bf16 step
    of a tiny MQAR S5 against its CPU step through the scan's kernels."""
    cs = _card(monkeypatch)
    monkeypatch.setattr(config_mod, "MQAR_LIN_ATTENTION_FULL",
                        _mqar_tiny(config_mod.MQAR_LIN_ATTENTION_FULL))
    monkeypatch.setattr(config_mod, "MQAR_S5_FULL", _mqar_tiny(config_mod.MQAR_S5_FULL))
    for name, value in (("P34_STEPS", 4), ("P34_EVAL_EVERY", 2), ("SWEEP_CHECK_STEPS", 2),
                        ("TRAIN_EXAMPLES", MQAR_TINY["num_train_examples"])):
        monkeypatch.setattr(cs, name, value)
    (train_x, train_y), (test_x, test_y) = _mqar_data()
    launches = cs.bf16_wave_path(torch.device("cpu"), test_x, test_y, (train_x, train_y),
                                 ARTIFACT_FILES)
    assert {k: v for k, v in launches.items() if v} == {"diag_scan": 2, "diag_scan_bwd": 2}


@pytest.mark.parametrize("bad", ["loss", "param", "capped"])
def test_the_bf16_card_step_check_fails_on_a_wrong_step(monkeypatch, bad):
    """``step_card_vs_cpu_bf16`` raises where the card's step differs from
    the CPU's: a loss off by 1 % (the bound is 0.1 %), one weight moved
    by more than the movement bound, or a leaf a kernel writes (here the
    SSM cores') whose CPU bf16 gradient is so far from the float32 one
    that its allowance reaches the cap (the float32 reference's B scaled
    by 10)."""
    import tlie_tpu_torch.training as training_pkg
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.training.state import make_optimizer

    cs = load_chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = dict(_mqar_tiny(config_mod.MQAR_S5_FULL)["model"], compute_dtype="bfloat16",
               dropout=0.0)
    (train_x, train_y), _ = _mqar_data()
    x = torch.as_tensor(train_x[:4]).long()
    y = torch.as_tensor(train_y[:4]).long()
    calls = []
    real = training_pkg.train_step

    def fresh(device, float32=False):
        mc = dict(cfg, compute_dtype="float32") if float32 else cfg
        m, _, _ = build_models(mc, generator=torch.Generator().manual_seed(0), device="cpu")
        if float32 and bad == "capped":
            with torch.no_grad():
                for layer in m.encoder.layers:
                    layer.seq.B.mul_(10.0)
        if calls == [] and bad == "param":
            calls.append(1)
            with torch.no_grad():
                m.decoder.weight[0, 0] += 1.0
        return m, make_optimizer(m, cfg["ssm_lr_vars"], 1e-3, 1e-3, 0.0, (0.9, 0.999)), None

    if bad == "loss":
        def skewed(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append(1)
            return out * 1.01 if len(calls) == 1 else out
        monkeypatch.setattr(training_pkg, "train_step", skewed)
    ph = cs.Phase("check")
    with pytest.raises(AssertionError, match="bf16 card vs CPU step"):
        cs.step_card_vs_cpu_bf16(ph, "tiny S5", fresh, torch.device("cpu"), x, y,
                                 {"regular": 1e-3, "ssm": 1e-3}, (".seq.",))
    if bad == "capped":
        assert ".seq." in ph.fields["grad_capped_leaves"]
