#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``tlie_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tlie_tpu_torch/ops/csrc`` with
``nvcc`` (into ``tlie_tpu_torch/_build/``, one ``nvcc`` per source, all at
once), holds each kernel against its plain PyTorch version on the card
(the diagonal scan forward and backward, the three kernels of the fused
decoder + cross-entropy head, the three of the SSD's decay attention on
float32 and on bfloat16 operands and the three of the flash attention), the
scan's two kernels also on a decay that varies by example and is constant in
time, and drives seven full-width models along ten paths, each with the
launch counts set to 0 just before it and read just after:

1. the MQAR LRU (``MQAR_LRU_FULL``: L=512, d_model=128, N=128, 2 layers,
   vocab 8192, batch 64, weights from the config's seed): evaluation,
   eigen-analysis and serving of the random-weight model;
2. the same model trained through ``tlie_tpu_torch.training.train`` (200
   steps, an eval every 100, on a train split cut to 8,192 examples), the
   checkpoint, and eval_eig and serving of the trained weights;
3. the WikiText-103 LRU language model (``WIKITEXT_LRU_SHORT``: 6 layers,
   d_model and N 512, block 1024, batch 8, the GPT-2 vocabulary of 50,257,
   BatchNorm, the synthetic token stream) trained with ``fused_xent: true``
   for 20 steps and one eval (perplexity), then eigen-analysed from its
   checkpoint and served;
4. the MQAR Mamba-2 (``MQAR_MAMBA2_FULL``: 2 layers, d_model 128, N 128, one
   head of 128, vocab 8192, L 512, batch 64): its forward on the test batch,
   200 training steps (AdamW behind the global-norm clip, the sparse head) on
   the same cut train split, the checkpoint reloaded and eigen-analysed from
   activations;
5. the MQAR softmax transformer (``MQAR_SM_ATTENTION_FULL``: 2 layers,
   d_model 128, one head of 128, vocab 8192, position table 512, L 512,
   batch 64, dropout 0.1): its forward on the test batch, 200 training steps
   (AdamW behind the clip, the sparse head) on the same cut train split, the
   checkpoint reloaded and eigen-analysed from activations, and serving (64
   prompts cut to 384 tokens, prefill plus 16 greedy tokens over the KV
   cache, the step path against the full forward);
6. the MQAR linear attention transformer (``MQAR_LIN_ATTENTION_FULL``: the
   transformer's widths and position table, elu+1 features, the chunked
   linear attention with its normaliser): its forward on the test batch,
   200 training steps, the checkpoint eigen-analysed (η of the normaliser
   from activations) and serving (64 prompts of 496 tokens, prefill plus 16
   greedy tokens over the O(1) state), then the step's time and its six
   largest device kernels;
7. the MQAR norm attention transformer (``MQAR_NORM_ATTENTION_CONV_FULL``:
   the learned softplus decay with its offset, conv 4, no position table)
   along the same phases with 50 training steps;
8. the WikiText-103 Mamba-2 LM (``configs/wikitext-mamba2-short.yaml``: 6
   layers, d_model and N 512, 8 heads of 64, block 1024, batch 8, vocab
   50,257, the dense head, float32): 20 training steps and one perplexity
   eval through the decay attention's float32 kernels, the checkpoint
   eigen-analysed, the step's time, idle share and the decay attention's
   share of device time;
9. the same model in bfloat16 (``configs/wikitext-mamba2-short-bf16.yaml``,
   ``compute_dtype: bfloat16``) along the same phases, through the decay
   attention's bfloat16 kernels and no float32 one, its checkpoint
   eigen-analysed in float32;
10. the stacked seed sweep (``tlie_tpu_torch.parallel.run_sweep``, ``launch
   --sweep_parallel``) of ``MQAR_LIN_ATTENTION_FULL`` over bench.py's four
   seeds: 200 stacked steps with an eval every 100, each point
   checkpointed, journaled and eigen-analysed, its point-steps/s; a rerun
   that skips every point; one point at dropout 0 against its serial run;
   the stacked step's time against a serial step's.
Paths 6, 7 and 10 reach no Pallas kernel in ``tlie_tpu``: no port kernel
launches on them, and the script checks that.  The decay attention's three
kernels are also held on bfloat16 operands against the plain bfloat16
version (the WikiText Mamba-2, MQAR and a ragged shape) and timed against
the bfloat16 tensor-core bound.

It also checks one MQAR training step of the LRU, of the Mamba-2 and of the
transformers on the card against the same step on the CPU, one fused-head
WikiText step against the dense-head step on the card, and times each kernel
against its bound, its plain version and, where one exists, the PyTorch
library call computing the same function.  Each
phase prints one line with its wall seconds; any failed check raises and
the exit code is non-zero.  The last three lines are the kernel table as
JSON, the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it fails and
prints no result.  It writes nothing inside the checkout except the kernel
build; the checkpoints and the eigen-analysis artifacts go to temporary
directories that are removed at the end.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores.  Bounds are stated against them; the power limit is printed
# beside every time.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# dense TF32 on the tensor cores (the same data sheet): the fused head's, the
# flash attention's and the decay attention's three kernels each run their
# products there, as three TF32 products each (the split x = big + small
# that keeps float32 accuracy)
TF32_FLOPS_PER_S = 495e12
# dense bfloat16 on the tensor cores (the same data sheet): the decay
# attention's bfloat16 kernels take one bfloat16 product a product
BF16_FLOPS_PER_S = 989e12

# kernel vs plain on the card: f32 sequential and chunked accumulation over
# up to ~1000 steps with |a| < 1; rounding grows like sqrt(steps) * eps, so
# 1e-5 of max|h| leaves a wide margin (the CPU tests hold the plain version
# to tlie_tpu at the same tolerance)
SCAN_RTOL_OF_MAX = 1e-5
# port on the card vs the port on the CPU (plain scan), and the serving step
# path vs the full forward: f32 matmuls summed in other orders; the same
# bound tests/test_decode.py holds the JAX step path to
LOGIT_ATOL = 2e-4
LOGIT_RTOL = 2e-4
# backward kernel vs plain: d within 1e-5 of max|d| (as h above); da within
# 1e-5 of sum(max|d| |h_{t-1}| + |d_t| max|h|) over the axes it is summed
# along, the first-order bound from the errors of d and h (tests/test_torch_scan_bwd.py)
# gradients of the card route (kernels) vs the plain route on the card: per
# leaf within 1e-4 of its max|g| (f32 sums in other orders; the CPU tests
# hold the port to JAX so)
GRAD_RTOL_OF_MAX = 1e-4
# one step's gradients, card vs CPU: both f32 are held to the same step in
# float64 on the CPU.  Some leaves are sums over all 64*512 rows that cancel
# (the BatchNorm backward has zero mean over the rows), so their f32 error is
# large beside their own max|g|; the card's error may then be at most
# GRAD_F64_FACTOR times the CPU's, or 1e-5 of the leaf's max|g|.
GRAD_F64_FACTOR = 8.0
# one optimiser step, card vs CPU: Adam moves each element by about lr*g/|g|,
# so where |g| is at least 1e-2 of its leaf's max (far above the 1e-4 noise)
# the two steps agree to f32 rounding of the weights (1e-6); elsewhere
# within the movement bound 2*lr + 1e-6.  BatchNorm statistics: 1e-5 of
# max(1, |x|).
PARAM_ATOL = 1e-6
STATS_RTOL = 1e-5
TRAIN_STEPS, EVAL_EVERY, TRAIN_EXAMPLES = 200, 100, 8192
# the WikiText LM path: 20 steps and one eval (the config runs 1,500 with an
# eval every 500); its train and test streams are the config's own
LM_STEPS = 20
# the fused head's kernels against their plain version: the LM's (B·L, D, V)
# and two small shapes, a vocabulary below one 128-wide tile and a ragged one
XENT_SHAPES = {"m8192_d512_v50257": (8192, 512, 50257), "m128_d512_v300": (128, 512, 300),
               "m1024_d512_v1000": (1024, 512, 1000)}
LM_BLOCK = 1024  # a -100 label ends each block of the LM's shifted labels
# fused head vs plain: loss and lse within 1e-5 relative.  A gradient element
# sums V (dh) or M (dW, db) terms t·x with t = softmax - onehot; it is held to
# XENT_RTOL of the sum of its terms' magnitudes for the rounding of that sum,
# plus the rounding of t itself: t's relative error is the absolute error of
# its logit, a float32 sum of D products, at most about sqrt(D)·u·Z with
# Z = max|h_m|·max|W_v| + max|b| (Cauchy-Schwarz) and u = 2^-24.
XENT_RTOL = 1e-5
F32_UNIT = 2.0 ** -24
# fused-head step vs dense-head step on the card: both are held to the
# dense step in float64 on the CPU, leaf by leaf; the fused step's error may
# be at most GRAD_F64_FACTOR times the dense float32 step's own, or 1e-5 of
# the leaf's max (the leaves next to a BatchNorm are row sums that cancel, so
# their float32 error is large beside their max, as in the MQAR step check)
# the decay attention's three kernels against their plain version: the MQAR
# Mamba-2 shape, the WikiText Mamba-2 shape and a ragged small one (BG, Q, N,
# Hg, P)
SSD_SHAPES = {"mqar_bg64_q512_n128_hg1_p128": (64, 512, 128, 1, 128),
              "wikitext_bg8_q1024_n512_hg8_p64": (8, 1024, 512, 8, 64),
              "ragged_bg3_q77_n40_hg3_p33": (3, 77, 40, 3, 33)}
# decay attention vs plain: each output element (y, dC, dcs_i, dB, dxdt,
# dcs_j) within SSD_RTOL of the sum of its terms' magnitudes
# (decay_attention.term_scales): float32 sums of up to N + Q terms (C·B over
# N, then the scores over j), rounded in another order; the decay exp(cs_i -
# cs_j) is formed from the same difference on both sides
SSD_RTOL = 1e-5
# the bfloat16 kernels against the plain bfloat16 version: y, dC, dB and dxdt
# are rounded to bfloat16, and so are the scores and dCB inside; the two sum
# in float32 in other orders, so a sum (or a score) near a rounding midpoint
# may round one bfloat16 step apart (at most 2^-7 of the value): each of
# those outputs within SSD_RTOL of its term sums plus BF16_STEP of (|value| +
# its term sums); dcs_i and dcs_j, float32 sums of float32 terms, within
# SSD_RTOL alone.  That band is wider than leaving out the rounding of the
# score or of dCB would move an output, so at least BF16_EQUAL_SHARE of each
# bfloat16 output must also equal the plain version's bit for bit: the card gave
# 0.9998-1.0000, and the plain version without those two roundings gives
# 0.60-0.64 against itself with them (on the CPU, at three shapes).  The
# WikiText Mamba-2 shape (path 9's), the MQAR shape and the ragged one.
BF16_STEP = 2.0 ** -7
BF16_EQUAL_SHARE = 0.99
SSD_BF16_SHAPES = {"wikitext_bg8_q1024_n512_hg8_p64": (8, 1024, 512, 8, 64),
                   "mqar_bg64_q512_n128_hg1_p128": (64, 512, 128, 1, 128),
                   "ragged_bg3_q77_n40_hg3_p33": (3, 77, 40, 3, 33)}
# one Mamba-2 step's gradients, card vs CPU, both held to float64 on the
# CPU: the card's error may be GRAD_F64_FACTOR times the CPU's, or 1e-4 of
# the leaf's max, the tolerance the CPU tests hold the port's gradients to
# JAX's with.  dt_bias and A_log are one number per head summed over all
# 64*512 positions through dcs = dcs_i + dcs_j, two sums that cancel, so one
# float32 draw of the CPU's error says little about the card's.
MAMBA_GRAD_RTOL_OF_MAX = 1e-4
# the MQAR Mamba-2 path: 200 steps and an eval every 100 (the config runs
# 40,000 with an eval every 200), on the same train split cut as the LRU's
MAMBA_STEPS, MAMBA_EVAL_EVERY = 200, 100
# the flash attention's three kernels against their plain version: the MQAR
# transformer's (B, L, H, D), a multi-head shape and a ragged one
ATTN_SHAPES = {"mqar_b64_l512_h1_d128": (64, 512, 1, 128),
               "heads_b4_l1024_h4_d64": (4, 1024, 4, 64),
               "ragged_b3_l77_h3_d40": (3, 77, 3, 40)}
# flash attention vs plain: each output element (o, dq, dk, dv) within
# ATTN_RTOL plus attention.logit_rtol of the sum of its terms' magnitudes
# (attention.term_scales): float32 sums of up to D + L terms rounded in
# another order, and the rounding of the logits, which enter P's exponent;
# lse within the same fraction of max(1, |lse|)
ATTN_RTOL = 1e-5
# the MQAR transformer path: 200 steps and an eval every 100 (the config runs
# 40,000 with an eval every 200), on the same train split cut as the LRU's;
# serving takes the test batch's prompts cut to 384 tokens (a multiple of the
# TPU kernel's 128-row block) and 16 greedy tokens, inside max_pos_embed 512
TF_STEPS, TF_EVAL_EVERY, TF_PROMPT = 200, 100, 384
# the MQAR linear and norm attention paths: 200 and 50 steps with 2 evals each
# (the configs run 40,000 with an eval every 200), on the same train split
# cut as the LRU's; serving takes the test batch's prompts cut to 496 tokens
# and 16 greedy tokens, which fills the linear attention's position table of
# 512 (the norm attention has none)
LIN_STEPS, LIN_EVAL_EVERY = 200, 100
NORM_STEPS, NORM_EVAL_EVERY = 50, 25
# the WikiText Mamba-2 paths (8: float32, 9: bfloat16): 20 steps and one
# perplexity eval each (the configs run 3,000 and 1,500 with an eval every 500)
WT_STEPS = 20
# the stacked sweep (path 10): bench.py's four seeds of the linear attention
# grid at the config's rate, 200 stacked steps with an eval every 100 (the
# north-star sweep runs 8,000), on the train split cut as the LRU's; its
# card check trains the same grid at dropout 0 for 20 steps and holds the
# first point to its serial run
SWEEP_SEEDS = (1919, 2222, 2929, 1717)
SWEEP_STEPS, SWEEP_EVAL_EVERY, SWEEP_CHECK_STEPS = 200, 100, 20
# a stacked point against its serial run, as tests/test_torch_sweep.py holds
# it: the train loss, test loss and test accuracy of every eval within 1e-5
# relative or 1e-7 absolute (pytest.approx's rule), and every parameter
# within 1e-5 absolute (the stacked step batches the same float32 products,
# so its sums may run in another order)
SWEEP_RTOL, SWEEP_ATOL, SWEEP_PARAM_ATOL = 1e-5, 1e-7, 1e-5
ATT_PROMPT = 496
# one transformer step's gradients, card vs CPU, both held to float64 on the
# CPU: the card's error may be GRAD_F64_FACTOR times the CPU's, or 1e-4 of
# the leaf's max, the tolerance the CPU tests hold the port's gradients to
# JAX's with
TF_GRAD_RTOL_OF_MAX = 1e-4
# device kernels of a training step by kind, from their names (first match)
OP_KINDS = (
    ("scan kernels", ("diag_scan", "sum_rows")),
    ("decay attention kernels", ("decay_attention",)),
    ("flash attention kernels", ("flash_attention",)),
    ("fused head kernels", ("xent",)),
    ("matmul", ("gemm", "Kernel2", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("sort, gather, scatter", ("sort", "Sort", "radix", "index", "gather", "scatter",
                               "embedding")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


class Phase:
    """Prints one line per phase with its wall seconds."""

    def __init__(self, name: str):
        self.name = name
        self.fields = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            secs = time.perf_counter() - self.t0
            extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
            print(f"[phase] {self.name}: {secs:.2f} s {extra}".rstrip(), flush=True)
        return False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# the tensor-core kernels, by the name tensor_core_hmma gives each, and the
# library that holds each
TC_KERNELS = {"fwd_p64": "fused_xent", "dh_p64": "fused_xent", "dh_p32": "fused_xent",
              "dw_p64": "fused_xent", "dw_p32": "fused_xent",
              "flash_fwd": "flash_attention", "flash_bwd_dkv": "flash_attention",
              "flash_bwd_dq": "flash_attention",
              "decay_fwd": "decay_attention", "decay_bwd_i": "decay_attention",
              "decay_bwd_j": "decay_attention", "decay_fwd_bf16": "decay_attention",
              "decay_bwd_i_bf16": "decay_attention", "decay_bwd_j_bf16": "decay_attention"}
# the HMMA each tensor-core kernel must hold: TF32 for the float32 kernels,
# bfloat16 for the decay attention's bfloat16 instantiations
TC_HMMA = {name: "HMMA.16816.F32.BF16" if name.endswith("_bf16") else "HMMA.1688.F32.TF32"
           for name in TC_KERNELS}


def ptxas_spills(log: str) -> list:
    """The bytes each function of a ``nvcc -Xptxas -v`` report spills, stores
    and loads together, in the report's order."""
    return [int(m.group(1)) + int(m.group(2)) for m in
            re.finditer(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]


def tensor_core_hmma(lib_paths, nvcc: str) -> dict:
    """The HMMA opcodes, with their counts, of each tensor-core kernel in the
    built libraries, from ``cuobjdump -sass`` (beside ``nvcc``): each
    instantiation of the fused head's forward and backward kernels, the
    flash attention's three, and the decay attention's forward, bwd_i and
    bwd_j on float32 and on bfloat16 operands,
    {"dh_p64": {"HMMA.1688.F32.TF32": 192}, ...}."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    instr = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?(HMMA\S*)")
    names = ((re.compile(r"xent_bwd_kernelILb([01])ELi(\d+)E"),
              lambda m: f"{'dw' if m.group(1) == '1' else 'dh'}_p{m.group(2)}"),
             (re.compile(r"xent_fwd_kernelILi(\d+)E"), lambda m: f"fwd_p{m.group(1)}"),
             (re.compile(r"flash_attention_fwd_kernel"), lambda m: "flash_fwd"),
             (re.compile(r"flash_attention_bwd_dkv_kernel"), lambda m: "flash_bwd_dkv"),
             (re.compile(r"flash_attention_bwd_dq_kernel"), lambda m: "flash_bwd_dq"),
             (re.compile(r"decay_attention_(fwd|bwd_i|bwd_j)_kernelI(f|13__nv_bfloat16)E"),
              lambda m: f"decay_{m.group(1)}" + ("" if m.group(2) == "f" else "_bf16")))
    counts = {}
    for lib_path in lib_paths:
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        ops = None
        for line in sass.splitlines():
            if "Function :" in line:
                ops = None
                for pattern, key in names:
                    m = pattern.search(line)
                    if m:
                        ops = counts.setdefault(key(m), {})
                        break
            elif ops is not None:
                m = instr.search(line)
                if m:
                    ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return counts


def cuda_ms(fn, repeat: int, flush: torch.Tensor = None):
    """Per-call device times (ms) of ``fn`` from CUDA events, one call per
    pair of events.  Before each call ``flush`` is overwritten, where given,
    which leaves the L2 cache cold, and then the stream sleeps on the device
    (about 0.6 ms, which touches no memory), so the host enqueues the call
    before the start event fires and the time is the device's, not the
    wrapper's host overhead (the flush alone, 256 MB of writes in about 0.08
    ms, is shorter than some wrappers' Python).  One untimed call comes
    first, so the series starts on a card that has just run ``fn``, not on
    one coming from host-side work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeat):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def top_device_ops(fn, k: int = 6):
    """The ``k`` device kernels with the most device time in one call of
    ``fn``, from ``torch.profiler`` (empty when it sees no device time).
    User-annotated ranges such as the optimiser's step are left out: their
    kernels are counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((ev.self_device_time_total, ev.key) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
         and not getattr(ev, "is_user_annotation", False)),  # ranges, not kernels
        reverse=True,
    )
    return [(name, round(us / 1e3, 4)) for us, name in rows[:k]]


def short(ops):
    """(name, ms) rows with the kernel names cut to 48 characters, for printing."""
    return [(name[:48], ms) for name, ms in ops]


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a stride-0 broadcast counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _planes(x):
    return x if isinstance(x, tuple) else (x,)


def scan_err(h, ref):
    """(max abs error, max|ref|) over the planes of two scan results."""
    err = max((x - y).abs().max().item() for x, y in zip(_planes(h), _planes(ref)))
    scale = max(y.abs().max().item() for y in _planes(ref))
    return err, scale


def bwd_err(a, h, da, d, da_ref, d_ref, reverse):
    """(d error, d tolerance, da error, worst da error over its tolerance) of
    the backward kernel against the plain version."""
    from tlie_tpu_torch.ops.scan import _shift, _sum_to

    d_e, d_scale = scan_err(d, d_ref)
    h_prev = sum(_shift(x, 1 if reverse else -1).abs() for x in _planes(h))
    d_abs = sum(x.abs() for x in _planes(d_ref))
    h_max = max(x.abs().max() for x in _planes(h))
    tol = SCAN_RTOL_OF_MAX * _sum_to(d_abs.max() * h_prev + d_abs * h_max,
                                     _planes(a)[0].shape)
    da_e = max((x - y).abs().max().item() for x, y in zip(_planes(da), _planes(da_ref)))
    ratio = max(((x - y).abs() / tol).max().item() for x, y in zip(_planes(da), _planes(da_ref)))
    return d_e, SCAN_RTOL_OF_MAX * d_scale, da_e, ratio


def grad_err(got, want):
    """Worst per-leaf max|got - want| / max|want| over two gradient dicts;
    raises where a gradient is missing."""
    worst = 0.0
    for name, w in want.items():
        g = got.get(name)
        if g is None or w is None:
            raise AssertionError(f"no gradient for {name}")
        worst = max(worst, (g.cpu() - w.cpu()).abs().max().item() / max(w.abs().max().item(), 1e-30))
    return worst


def median(xs):
    return sorted(xs)[len(xs) // 2]


def time_scan_kernel(kernel, plain, n_bytes: int, flops: int, flush):
    """One scan kernel's L2-cold and warm medians of 21 launches, the plain
    loop's best of 2 and the bound from the bytes and float32 operations
    given: (ms, warm_ms, plain_ms, bound_ms, bound_by)."""
    cold = median(cuda_ms(kernel, 21, flush))
    warm = median(cuda_ms(kernel, 21))
    plain_ms = min(cuda_ms(plain, 2))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (cold, warm, plain_ms, max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def scan_timing_fields(t, n_bytes: int) -> str:
    """One entry of ``time_scan_kernel`` as a phase field."""
    ms, warm, plain_ms, bound, by = t
    return (f"cold_median={ms:.5f},warm_median={warm:.5f},plain_ms={plain_ms:.3f},"
            f"bound_ms={bound:.5f}({by}),over_bound={ms / bound:.3f},bytes={n_bytes}")


def xent_inputs(dev, gen, M, D, V):
    """h (M, D), the decoder weight as nn.Linear keeps it (V, D) with w its
    (D, V) transpose, b (V,), labels (M,) with -100 on the last row of each
    block (or of the whole batch where it is shorter than a block)."""
    h = torch.randn(M, D, device=dev, generator=gen)
    weight = torch.randn(V, D, device=dev, generator=gen) / math.sqrt(D)
    b = 0.1 * torch.randn(V, device=dev, generator=gen)
    labels = torch.randint(0, V, (M,), device=dev, generator=gen)
    labels[min(M, LM_BLOCK) - 1::LM_BLOCK] = -100
    return h, weight, b, labels


def xent_grad_rtol(h, w, b) -> float:
    """The stated tolerance of a fused-head gradient element, as a multiple
    of the sum of its terms' magnitudes (see XENT_RTOL)."""
    z = (h.norm(dim=1).max() * w.norm(dim=0).max() + b.abs().max()).item()
    return XENT_RTOL + math.sqrt(h.shape[1]) * F32_UNIT * z


def check_fused_xent(fx, h, w, b, labels, f64: bool):
    """Each of the three kernels against the plain version on the same
    inputs: (fields, max abs errors by kernel).  With ``f64`` both are also
    held to the same function in float64, for the record."""
    loss, lse = fx.fused_xent_fwd_cuda(h, w, b, labels)
    ref_loss, ref_lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    n_valid = int((labels != -100).sum())
    gscale = torch.full((1,), 1.0 / n_valid, device=h.device)
    dh = fx.fused_xent_dh_cuda(h, w, b, labels, ref_lse, gscale)
    dw, db = fx.fused_xent_dw_cuda(h, w, b, labels, ref_lse, gscale)
    torch.cuda.synchronize()
    ref = fx.fused_xent_bwd_plain(h, w, b, labels, ref_lse, gscale)
    scales = fx.grad_term_scales(h, w, b, labels, ref_lse, gscale)
    rtol = xent_grad_rtol(h, w, b)
    loss_rel = abs(loss.sum().item() - ref_loss.sum().item()) / abs(ref_loss.sum().item())
    lse_rel = ((lse - ref_lse).abs() / ref_lse.abs()).max().item()
    rows_ratio = ((loss - ref_loss).abs()
                  / (XENT_RTOL * fx.loss_term_scales(ref_loss, ref_lse))).max().item()
    fields = {"loss_rel": f"{loss_rel:.2e}", "lse_rel": f"{lse_rel:.2e}",
              "loss_rows_err_over_tol": f"{rows_ratio:.3f}",
              "grad_rtol_of_term_sums": f"{rtol:.2e}"}
    errs = {"fused_xent_fwd": max((loss - ref_loss).abs().max().item(),
                                  (lse - ref_lse).abs().max().item()),
            "fused_xent_dh": 0.0, "fused_xent_dw": 0.0}
    ok = loss_rel <= XENT_RTOL and lse_rel <= XENT_RTOL and rows_ratio <= 1.0
    kernel_of = {"dh": "fused_xent_dh", "dw": "fused_xent_dw", "db": "fused_xent_dw"}
    for name, got, want, scale in zip(("dh", "dw", "db"), (dh, dw, db), ref, scales):
        ratio = ((got - want).abs() / (rtol * scale + 1e-30)).max().item()
        fields[f"{name}_err_over_tol"] = f"{ratio:.3f}"
        errs[kernel_of[name]] = max(errs[kernel_of[name]], (got - want).abs().max().item())
        ok = ok and ratio <= 1.0
    if f64:
        h64, w64, b64 = h.double(), w.double(), b.double()
        loss64, lse64 = fx.fused_xent_fwd_plain(h64, w64, b64, labels)
        ref64 = fx.fused_xent_bwd_plain(h64, w64, b64, labels, lse64, gscale.double())
        s64 = fx.grad_term_scales(h64, w64, b64, labels, lse64, gscale.double())
        for name, got, plain, want, scale in zip(("dh", "dw", "db"), (dh, dw, db), ref, ref64, s64):
            k_e = ((got.double() - want).abs() / (scale + 1e-300)).max().item()
            p_e = ((plain.double() - want).abs() / (scale + 1e-300)).max().item()
            fields[f"{name}_vs_f64_over_term_sums"] = f"kernel={k_e:.2e},plain={p_e:.2e}"
        fields["lse_vs_f64_rel"] = (
            f"kernel={((lse.double() - lse64).abs() / lse64.abs()).max().item():.2e},"
            f"plain={((ref_lse.double() - lse64).abs() / lse64.abs()).max().item():.2e}")
        rows64 = fx.loss_term_scales(loss64, lse64)
        fields["loss_rows_vs_f64_over_term_sums"] = (
            f"kernel={((loss.double() - loss64).abs() / rows64).max().item():.2e},"
            f"plain={((ref_loss.double() - loss64).abs() / rows64).max().item():.2e}")
        del loss64, ref64, s64
    if not ok:
        raise AssertionError(f"fused_xent kernels vs plain: {fields}")
    return fields, errs, (ref_lse, gscale)


def time_fused_xent(fx, h, w, b, labels, lse, gscale, flush):
    """L2-cold medians of 21 launches of each kernel, its warm median, the
    cold medians of its plain version and of the library call computing the
    same function (addmm and F.cross_entropy, autograd for the gradients),
    and each kernel's bound: {kernel: (ms, warm_ms, plain_ms, library_ms,
    bound_ms, bound_by, bytes, flops, bound_f32_ms)}.  Each kernel runs its
    products on the tensor cores, each as three TF32 products at
    TF32_FLOPS_PER_S; its bound_ms is the lesser of that and float32 outside
    them (bound_f32_ms, at FP32_FLOPS_PER_S)."""
    import torch.nn.functional as F

    M, D = h.shape
    V = w.shape[1]
    n_valid = int((labels != -100).sum())
    ms = {
        "fused_xent_fwd": lambda: fx.fused_xent_fwd_cuda(h, w, b, labels),
        "fused_xent_dh": lambda: fx.fused_xent_dh_cuda(h, w, b, labels, lse, gscale),
        "fused_xent_dw": lambda: fx.fused_xent_dw_cuda(h, w, b, labels, lse, gscale),
    }
    plain = {
        "fused_xent_fwd": lambda: fx.fused_xent_fwd_plain(h, w, b, labels),
        "fused_xent_dh": lambda: fx._dlogits_plain(h, w, b, labels, lse, gscale) @ w.t(),
        "fused_xent_dw": lambda: (lambda t: ((t.t() @ h).t(), t.sum(0)))(
            fx._dlogits_plain(h, w, b, labels, lse, gscale)),
    }
    hl = h.clone().requires_grad_()
    weight = w.t().detach().clone().requires_grad_()
    bl = b.clone().requires_grad_()
    lib_loss = F.cross_entropy(torch.addmm(bl, hl, weight.t()), labels, ignore_index=-100)
    library = {
        "fused_xent_fwd": lambda: F.cross_entropy(torch.addmm(b, h, w), labels, ignore_index=-100),
        "fused_xent_dh": lambda: torch.autograd.grad(lib_loss, hl, retain_graph=True),
        "fused_xent_dw": lambda: torch.autograd.grad(lib_loss, (weight, bl), retain_graph=True),
    }
    # bytes: each input read once, each output written once; operations: the
    # products (2·M·D·V for the forward's logits over every row, which all
    # get an lse; the backward recomputes the logits and does one more
    # product, over the valid rows its output needs)
    f4, i8 = 4, 8
    in_bytes = (M * D + D * V + V) * f4 + M * i8
    io = {"fused_xent_fwd": (in_bytes + 2 * M * f4, 2 * M * D * V),
          "fused_xent_dh": (in_bytes + (M + 1) * f4 + M * D * f4, 4 * n_valid * D * V),
          "fused_xent_dw": (in_bytes + (M + 1) * f4 + (D * V + V) * f4, 4 * n_valid * D * V)}
    out = {}
    for name in ms:
        with torch.no_grad():
            k_ms = median(cuda_ms(ms[name], 21, flush))
            w_ms = median(cuda_ms(ms[name], 21))
            p_ms = median(cuda_ms(plain[name], 21, flush))
        l_ms = median(cuda_ms(library[name], 21, flush))
        n_bytes, flops = io[name]
        bytes_ms, f32_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        flops_ms = min(f32_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        out[name] = (k_ms, w_ms, p_ms, l_ms, max(bytes_ms, flops_ms),
                     "bytes" if bytes_ms >= flops_ms else "operations", n_bytes, flops, f32_ms)
    del lib_loss
    return out


def decay_inputs(dev, gen, BG, Q, N, Hg, P, dtype=torch.float32):
    """C as a row-strided view (the SSD slices C and B out of the conv
    output), B, cs as the within-chunk cumsum of dt·A with dt in [0, 0.1)
    and A in (-16, -1] (|cs| reaches hundreds at Q = 512), xdt and a
    cotangent dy; all but cs (float32) in ``dtype``."""
    C = torch.randn(BG, Q, N + 8, device=dev, generator=gen).to(dtype)[:, :, 4:4 + N]
    B = torch.randn(BG, Q, N, device=dev, generator=gen).to(dtype)
    dt = 0.1 * torch.rand(BG, Hg, Q, device=dev, generator=gen)
    A = -1 - 15 * torch.rand(1, Hg, 1, device=dev, generator=gen)
    cs = torch.cumsum(dt * A, -1).contiguous()
    x = torch.randn(BG, Hg, Q, P, device=dev, generator=gen).to(dtype)
    dy = torch.randn(BG, Hg, Q, P, device=dev, generator=gen).to(dtype)
    return C, B, cs, x, dy


DECAY_OUTPUTS = (("y", "decay_attention_fwd"), ("dC", "decay_attention_bwd_i"),
                 ("dcs_i", "decay_attention_bwd_i"), ("dB", "decay_attention_bwd_j"),
                 ("dxdt", "decay_attention_bwd_j"), ("dcs_j", "decay_attention_bwd_j"))


def check_decay_attention(dattn, C, B, cs, x, dy, f64: bool):
    """The three kernels against the plain version on the same inputs:
    (fields, max abs error by kernel's launch name).  With ``f64`` both are
    also held to the plain version in float64, for the record.  On bfloat16
    operands the bfloat16 outputs take BF16_STEP more, and at least
    BF16_EQUAL_SHARE of them must equal the plain version's (see there)."""
    got = ((dattn.decay_attention_fwd_cuda(C, B, cs, x),)
           + dattn.decay_attention_bwd_i_cuda(C, B, cs, x, dy)
           + dattn.decay_attention_bwd_j_cuda(C, B, cs, x, dy))
    torch.cuda.synchronize()
    want = ((dattn.decay_attention_plain(C, B, cs, x),)
            + dattn.decay_attention_bwd_plain(C, B, cs, x, dy))
    scales = dattn.term_scales(C, B, cs, x, dy)
    fields, errs, ok = {}, {}, True
    for (name, kernel), a, b, sc in zip(DECAY_OUTPUTS, got, want, scales):
        kernel = dattn.launch_name(kernel[len("decay_attention_"):], x.dtype)
        tol = SSD_RTOL * sc + 1e-30
        if b.dtype == torch.bfloat16:
            tol = tol + BF16_STEP * (b.float().abs() + sc)
            share = (a == b).float().mean().item()
            fields[f"{name}_equal_share"] = f"{share:.4f}"
            ok = ok and share >= BF16_EQUAL_SHARE
        a, b = a.float(), b.float()
        ratio = ((a - b).abs() / tol).max().item()
        fields[f"{name}_err_over_tol"] = f"{ratio:.3e}"
        errs[kernel] = max(errs.get(kernel, 0.0), (a - b).abs().max().item())
        ok = ok and ratio <= 1.0 and bool(torch.isfinite(a).all())
    if f64:
        ref = (C.double(), B.double(), cs.double(), x.double(), dy.double())
        ref = ((dattn.decay_attention_plain(*ref[:4]).cpu(),)
               + tuple(t.cpu() for t in dattn.decay_attention_bwd_plain(*ref)))
        for (name, _), a, b, r, sc in zip(DECAY_OUTPUTS, got, want, ref, scales):
            sc = sc.cpu().double() + 1e-300
            k_e = ((a.cpu().double() - r).abs() / sc).max().item()
            p_e = ((b.cpu().double() - r).abs() / sc).max().item()
            fields[f"{name}_vs_f64_over_term_sums"] = f"kernel={k_e:.2e},plain={p_e:.2e}"
    if not ok:
        raise AssertionError(f"decay attention kernels vs plain: {fields}")
    return fields, errs


def decay_einsum(C, B, cs, x):
    """The materialised form as tlie_tpu's XLA path writes it
    (ops/ssd.py:215-223), in einsums: cuBLAS products, autograd backward;
    the decay in the operands' dtype, as tlie_tpu casts it to ``mm_dtype``."""
    Q = cs.shape[-1]
    seg = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    scores = torch.einsum("bin,bjn->bij", C, B)[:, None] * torch.exp(
        seg.masked_fill(~causal, float("-inf"))).to(C.dtype)
    return torch.einsum("bhij,bhjp->bhip", scores, x)


# the decay attention's kernels, all on the tensor cores (three TF32 products
# a product)
DECAY_TC = ("decay_attention_fwd", "decay_attention_bwd_i", "decay_attention_bwd_j")


def time_decay_attention(dattn, C, B, cs, x, dy, flush):
    """L2-cold medians of 21 launches of each kernel, warm medians, the plain
    version's and the einsum form's cold medians, and each kernel's bound:
    {kernel's launch name: (ms, warm_ms, plain_ms, einsum_ms, bound_ms,
    bound_by, bytes, flops, bound_f32_ms)}.  The kernels of DECAY_TC run
    their products on the tensor cores, on float32 operands as three TF32
    products each (the bound is the lesser of that and float32 outside
    them), on bfloat16 operands as one bfloat16 product (the bound is that,
    and the bytes count 2 for each bfloat16 element)."""
    BG, Hg, Q, P = x.shape
    N = C.shape[2]
    bf16 = x.dtype == torch.bfloat16
    ms = {
        "decay_attention_fwd": lambda: dattn.decay_attention_fwd_cuda(C, B, cs, x),
        "decay_attention_bwd_i": lambda: dattn.decay_attention_bwd_i_cuda(C, B, cs, x, dy),
        "decay_attention_bwd_j": lambda: dattn.decay_attention_bwd_j_cuda(C, B, cs, x, dy),
    }
    plain = {
        "decay_attention_fwd": lambda: dattn.decay_attention_plain(C, B, cs, x),
        "decay_attention_bwd_i": lambda: dattn.decay_attention_bwd_i_plain(C, B, cs, x, dy),
        "decay_attention_bwd_j": lambda: dattn.decay_attention_bwd_j_plain(C, B, cs, x, dy),
    }
    leaves = [t.detach().clone().requires_grad_() for t in (C, B, cs, x)]
    y_lib = decay_einsum(*leaves)
    einsum = {
        "decay_attention_fwd": lambda: decay_einsum(C, B, cs, x),
        "decay_attention_bwd_i": lambda: torch.autograd.grad(
            y_lib, (leaves[0], leaves[2]), dy, retain_graph=True),
        "decay_attention_bwd_j": lambda: torch.autograd.grad(
            y_lib, (leaves[1], leaves[3], leaves[2]), dy, retain_graph=True),
    }
    # bytes: each input read once, each output written once; operations: the
    # products over the causal pairs (j <= i), per group for C·B and its
    # gradients (2N each), per head for the P-wide ones (2P each)
    f4, e = 4, x.element_size()  # cs and dcs are float32; the rest in x's dtype
    pairs = BG * Q * (Q + 1) // 2
    ins = (2 * BG * Q * N + BG * Hg * Q * P) * e + BG * Hg * Q * f4  # C, B, x, cs
    io = {"decay_attention_fwd": (ins + BG * Hg * Q * P * e, pairs * (2 * N + 2 * Hg * P)),
          "decay_attention_bwd_i": (ins + BG * Hg * Q * P * e + BG * Q * N * e + BG * Hg * Q * f4,
                                    pairs * (4 * N + 2 * Hg * P)),
          "decay_attention_bwd_j": (ins + BG * Hg * Q * P * e
                                    + (BG * Q * N + BG * Hg * Q * P) * e + BG * Hg * Q * f4,
                                    pairs * (4 * N + 4 * Hg * P))}
    out = {}
    for name in ms:
        with torch.no_grad():
            k_ms = median(cuda_ms(ms[name], 21, flush))
            w_ms = median(cuda_ms(ms[name], 21))
            p_ms = median(cuda_ms(plain[name], 21, flush))
        e_ms = median(cuda_ms(einsum[name], 21, flush))
        n_bytes, flops = io[name]
        bytes_ms, f32_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        flops_ms = f32_ms
        if bf16:
            flops_ms = flops / BF16_FLOPS_PER_S * 1e3
        elif name in DECAY_TC:
            flops_ms = min(f32_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        key = dattn.launch_name(name[len("decay_attention_"):], x.dtype)
        out[key] = (k_ms, w_ms, p_ms, e_ms, max(bytes_ms, flops_ms),
                    "bytes" if bytes_ms >= flops_ms else "operations", n_bytes, flops, f32_ms)
    del y_lib, leaves
    return out


def timing_fields(t, library: str, over: str) -> str:
    """One kernel's entry of ``time_decay_attention`` or
    ``time_flash_attention`` as a phase field, the library call's time and
    the kernel's ratio to it under the names given."""
    k_ms, w_ms, p_ms, l_ms, bound, by, n_bytes, flops, f32 = t
    return (f"ms_cold_median={k_ms:.5f},ms_warm_median={w_ms:.5f},plain_ms={p_ms:.5f},"
            f"{library}={l_ms:.5f},{over}={k_ms / l_ms:.3f},"
            f"bound_ms={bound:.5f}({by}),over_bound={k_ms / bound:.3f},"
            f"bound_f32_ms={f32:.5f},gflop={flops / 1e9:.3f},"
            f"mbytes={n_bytes / 1e6:.1f},tflops={flops / k_ms / 1e9:.2f}")


def attention_inputs(dev, gen, B, L, H, D):
    """q, k, v as head-strided views of one projection (MHA splits them out
    of Wqkv, and the kernels read them in place) and a cotangent do."""
    qkv = torch.randn(B, L, 3 * H * D + 8, device=dev, generator=gen)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, L, H, D) for i in range(3))
    return q, k, v, torch.randn(B, L, H, D, device=dev, generator=gen)


ATTN_OUTPUTS = (("o", "flash_attention_fwd"), ("dq", "flash_attention_bwd_dq"),
                ("dk", "flash_attention_bwd_dkv"), ("dv", "flash_attention_bwd_dkv"))


def check_flash_attention(fa, q, k, v, do, f64: bool):
    """The three kernels against the plain version on the same inputs (the
    backward kernels on the plain forward's lse and di): (fields, max abs
    error by kernel, (lse, di)).  With ``f64`` both are also held to the
    plain version in float64, for the record."""
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    di = fa.attention_di(o_ref, do)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse_ref, di, scale)
    dq = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse_ref, di, scale)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse_ref, di, scale)
    want = (o_ref, fa.flash_attention_bwd_dq_plain(q, k, v, do, lse_ref, di, scale), dk_ref,
            dv_ref)
    got = (o, dq, dk, dv)
    scales = fa.term_scales(q, k, v, do, lse_ref, scale)
    rtol = ATTN_RTOL + fa.logit_rtol(q, k, scale)
    lse_ratio = ((lse - lse_ref).abs() / (rtol * lse_ref.abs().clamp_min(1.0))).max().item()
    fields = {"rtol_of_term_sums": f"{rtol:.2e}", "lse_err_over_tol": f"{lse_ratio:.3e}"}
    errs = {"flash_attention_fwd": (lse - lse_ref).abs().max().item()}
    ok = lse_ratio <= 1.0
    for (name, kernel), a, b, sc in zip(ATTN_OUTPUTS, got, want, scales):
        ratio = ((a - b).abs() / (rtol * sc + 1e-30)).max().item()
        fields[f"{name}_err_over_tol"] = f"{ratio:.3e}"
        errs[kernel] = max(errs.get(kernel, 0.0), (a - b).abs().max().item())
        ok = ok and ratio <= 1.0 and bool(torch.isfinite(a).all()) and a.abs().max().item() > 0
    if f64:
        q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
        o64, lse64 = fa.flash_attention_plain(q64, k64, v64, scale)
        di64 = fa.attention_di(o64, do64)
        dk64, dv64 = fa.flash_attention_bwd_dkv_plain(q64, k64, v64, do64, lse64, di64, scale)
        ref = (o64, fa.flash_attention_bwd_dq_plain(q64, k64, v64, do64, lse64, di64, scale),
               dk64, dv64)
        for (name, _), a, b, r, sc in zip(ATTN_OUTPUTS, got, want, ref, scales):
            sc = sc.double() + 1e-300
            k_e = ((a.double() - r).abs() / sc).max().item()
            p_e = ((b.double() - r).abs() / sc).max().item()
            fields[f"{name}_vs_f64_over_term_sums"] = f"kernel={k_e:.2e},plain={p_e:.2e}"
    if not ok:
        raise AssertionError(f"flash attention kernels vs plain: {fields}")
    return fields, errs, (lse_ref, di)


# the flash attention's kernels on the tensor cores (three TF32 products a
# product)
ATTN_TC = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def time_flash_attention(fa, q, k, v, do, lse, di, flush):
    """L2-cold medians of 21 launches of each kernel, warm medians, the
    plain version's and the library call's cold medians (F.scaled_dot_product_attention
    with is_causal=True in float32, its autograd for the gradients), and each
    kernel's bound: ({kernel: (ms, warm_ms, plain_ms, library_ms, bound_ms,
    bound_by, bytes, flops, bound_f32_ms)}, (SDPA's backend for these
    inputs, the device kernels its forward ran, by name, from
    ``torch.profiler``)).  The kernels of ATTN_TC run their products on
    the tensor cores as three TF32 products each: their bound is the lesser
    of that and float32 outside them."""
    import torch.nn.functional as F

    B, L, H, D = q.shape
    scale = D ** -0.5
    ms = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd_cuda(q, k, v, scale),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, di,
                                                                           scale),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, di,
                                                                         scale),
    }
    plain = {
        "flash_attention_fwd": lambda: fa.flash_attention_plain(q, k, v, scale),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di,
                                                                            scale),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, di,
                                                                          scale),
    }
    # SDPA takes (B, H, L, D): the same tensors, transposed views
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library = {
        "flash_attention_fwd": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True),
        "flash_attention_bwd_dkv": lambda: torch.autograd.grad(o_lib, (kt, vt), dot,
                                                               retain_graph=True),
        "flash_attention_bwd_dq": lambda: torch.autograd.grad(o_lib, qt, dot, retain_graph=True),
    }
    # bytes: each input read once, each output written once; operations: the
    # products over the causal pairs (j <= i): q.k and p v forward (4D a
    # pair), q.k, do.v, p^T do and ds^T q for dK/dV (8D), q.k, do.v and ds k
    # for dQ (6D)
    f4, n = 4, B * L * H * D
    pairs = B * H * L * (L + 1) // 2
    rows = B * H * L
    io = {"flash_attention_fwd": ((3 * n + n + rows) * f4, 4 * D * pairs),
          "flash_attention_bwd_dkv": ((4 * n + 2 * rows + 2 * n) * f4, 8 * D * pairs),
          "flash_attention_bwd_dq": ((4 * n + 2 * rows + n) * f4, 6 * D * pairs)}
    out = {}
    for name in ms:
        with torch.no_grad():
            k_ms = median(cuda_ms(ms[name], 21, flush))
            w_ms = median(cuda_ms(ms[name], 21))
            p_ms = median(cuda_ms(plain[name], 21, flush))
        l_ms = median(cuda_ms(library[name], 21, flush))
        n_bytes, flops = io[name]
        bytes_ms, f32_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        flops_ms = f32_ms
        if name in ATTN_TC:
            flops_ms = min(f32_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        out[name] = (k_ms, w_ms, p_ms, l_ms, max(bytes_ms, flops_ms),
                     "bytes" if bytes_ms >= flops_ms else "operations", n_bytes, flops, f32_ms)
    # SDPA's backend, as its dispatcher picks it, and its kernels by name from
    # torch.profiler (which late in a long run has seen no device time)
    from torch.nn.attention import SDPBackend

    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, None, 0.0, True)).name
    with torch.no_grad():
        sdpa_kernels = top_device_ops(library["flash_attention_fwd"]) or "not seen"
    del o_lib, qt, kt, vt
    return out, (backend, sdpa_kernels)


def step_profile(one_step, tokens_per_step: int, kernel_pattern, kernel_field: str,
                 n_warm: int = 3, n_timed: int = 20, n_top: int = 12):
    """Fields of a training step's timing phase: ms per step from CUDA events
    around ``n_timed`` back-to-back steps after ``n_warm`` warm ones, train
    tokens/s, and from ``torch.profiler`` over one step the device busy time,
    the idle share, the time and share of the kernels whose names hold
    ``kernel_pattern`` (where one is given), device time by kind, and the
    ``n_top`` kernels with the most device time, by name."""
    for _ in range(n_warm):
        one_step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_timed):
        one_step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_timed
    ops = top_device_ops(one_step, k=1000)
    busy = sum(t for _, t in ops)
    fields = {"ms_per_step": f"{step_ms:.3f}",
              "train_tokens_per_s": f"{tokens_per_step / step_ms * 1e3:.0f}"}
    if busy <= 0:  # the profiler saw no device time: the CUDA-event time stands alone
        fields["device_busy_ms"] = "not measured"
        return fields
    by_kind = {}
    for name, t in ops:
        op_kind = next((k for k, pats in OP_KINDS if any(p in name for p in pats)), "other")
        by_kind[op_kind] = round(by_kind.get(op_kind, 0.0) + t, 4)
    fields.update({"device_busy_ms": f"{busy:.4f}",
                   "idle_share": f"{max(0.0, 1 - busy / step_ms):.3f}"})
    if kernel_pattern is not None:
        k_ms = sum(t for name, t in ops if kernel_pattern in name)
        fields.update({f"{kernel_field}_ms": f"{k_ms:.4f}",
                       f"{kernel_field}_share_of_device": f"{k_ms / busy:.4f}"})
    fields.update({"device_ms_by_kind": repr(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                   "top_device_ops_ms": repr(short(ops[:n_top]))})
    return fields


def step_card_vs_cpu(ph, what: str, fresh, dev, x_step, y_step, lrs, sparse_k,
                     rtol_of_max: float, watch=None):
    """One training step (sparse head, AdamW behind the global-norm clip)
    from the same weights and batch on the card and on the CPU, both held
    to the same step in float64 on the CPU: each gradient's error on the
    card may be GRAD_F64_FACTOR times the CPU's or ``rtol_of_max`` of the
    leaf's max|g|; the parameters within PARAM_ATOL where |g| is at least
    1e-2 of its leaf's max and within the movement bound 2·lr + PARAM_ATOL
    everywhere.  ``fresh(device)`` gives (model, optimizer, clip norm);
    ``watch`` is (field, name predicate) for leaves whose error ratios are
    printed one by one.  Fills ``ph.fields``, raises on a failed check, and
    returns the card's (model, optimizer, clip norm) after its step."""
    from tlie_tpu_torch.training import train_step
    from tlie_tpu_torch.training.state import clip_by_global_norm_
    from tlie_tpu_torch.training.steps import cross_entropy_loss, head_logits

    card_m, card_opt, clip = fresh(dev)
    cpu_m, cpu_opt, _ = fresh("cpu")
    train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip)
    t0 = time.perf_counter()
    train_step(cpu_m, cpu_opt, x_step.cpu(), y_step.cpu(), lrs, sparse_k, clip_norm=clip)
    cpu_g = {n: p.grad for n, p in cpu_m.named_parameters()}
    card_g = {n: p.grad.cpu() for n, p in card_m.named_parameters()}
    ref_m = fresh("cpu")[0].double()
    cross_entropy_loss(*head_logits(ref_m, x_step.cpu(), y_step.cpu(), sparse_k)).backward()
    raw_norm = float(clip_by_global_norm_(ref_m.parameters(), clip))
    cpu_s = time.perf_counter() - t0
    g_ratio, g_leaf, watched = 0.0, "", {}
    for n, p in ref_m.named_parameters():
        g64 = p.grad
        e_card = (card_g[n].double() - g64).abs().max().item()
        e_cpu = (cpu_g[n].double() - g64).abs().max().item()
        allowed = max(GRAD_F64_FACTOR * e_cpu, rtol_of_max * g64.abs().max().item())
        if watch is not None and watch[1](n):
            watched[n] = round(e_card / allowed, 4)
        if e_card / allowed > g_ratio:
            g_ratio, g_leaf = e_card / allowed, n
    g_worst = grad_err(card_g, cpu_g)
    p_worst = p_anywhere = 0.0
    for (n, p), q in zip(card_m.named_parameters(), cpu_m.parameters()):
        p_err = (p.detach().cpu() - q.detach()).abs()
        g_abs = cpu_g[n].abs()
        det = g_abs >= 1e-2 * g_abs.max()
        p_worst = max(p_worst, p_err[det].max().item() if bool(det.any()) else 0.0)
        p_anywhere = max(p_anywhere, p_err.max().item())
    ph.fields.update(raw_grad_norm_f64=f"{raw_norm:.4f}", clip=clip,
                     grad_err_over_allowed=f"{g_ratio:.3f}({g_leaf})")
    if watch is not None:
        ph.fields[watch[0]] = repr(watched)
    ph.fields.update(grad_card_vs_cpu_worst_rel_to_leaf_max=f"{g_worst:.3e}",
                     param_worst_where_grad_determined=f"{p_worst:.3e}",
                     param_worst_anywhere=f"{p_anywhere:.3e}", cpu_steps_s=f"{cpu_s:.1f}")
    if not (g_ratio <= 1.0 and p_worst <= PARAM_ATOL
            and p_anywhere <= 2 * lrs["regular"] + PARAM_ATOL):
        raise AssertionError(f"{what} card vs CPU step: {ph.fields}")
    return card_m, card_opt, clip


def transformer_path(dev, gen, flush, test_x, test_y, train_split, want_files):
    """Main path 5, the full-width MQAR softmax transformer
    (``MQAR_SM_ATTENTION_FULL``: 2 layers, d_model 128, one head of 128,
    vocab 8192, position table 512, L 512, batch 64, dropout 0.1, weights
    from seed 1919) through the three flash-attention kernels: first each
    kernel against its plain version at three shapes; then, with every
    launch count set to 0, the forward on the test batch (card against CPU),
    200 training steps with 2 evals, the checkpoint reloaded and
    eigen-analysed, and serving; the counts are read there.  Then one card
    step against the CPU step, the step's time and where it goes, and the
    kernels' times.  Returns (launches of the path, kernel times, max abs
    errors by kernel)."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import MQAR_SM_ATTENTION_FULL, derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops import attention as fa
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    kernels = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    with Phase("flash_attention_vs_plain") as ph:
        attn_errs, second = {}, None
        for name, (B, L, H, D) in ATTN_SHAPES.items():
            ins = attention_inputs(dev, gen, B, L, H, D)
            # float64 for the record at the MQAR and the ragged shape
            fields, errs, rows = check_flash_attention(fa, *ins,
                                                       f64=not name.startswith("heads"))
            ph.fields[name] = repr(fields)
            if not attn_errs:  # the MQAR shape comes first
                attn_errs, attn_io = errs, ins + rows
            elif second is None:  # the multi-head shape: dK/dV's time there, for the record
                second = name, ins + rows
            del ins, rows
        torch.cuda.empty_cache()

    sm = MQAR_SM_ATTENTION_FULL
    smm = sm["model"]
    n_layers, bsz, L = smm["num_layers"], sm["train"]["batch_size"], smm["seq_len"]
    _, model, _ = build_models(smm, generator=torch.Generator().manual_seed(sm["seed"]), device=dev)
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, smm["input_dim"],
                                lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("tf_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["flash_attention_fwd"] != n_layers:
            raise AssertionError(f"the transformer's forward launched flash_attention_fwd "
                                 f"{LAUNCHES['flash_attention_fwd']} times, expected {n_layers}")
        if logits.shape != (bsz, L, smm["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"transformer forward output {tuple(logits.shape)}")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top = top_device_ops(lambda: model(inputs))
        _, cpu_model, _ = build_models(smm, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"transformer card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         flash_attention_fwd_launches_per_forward=n_layers,
                         vs_cpu_max_abs=f"{cpu_err:.3e}", top_device_ops_ms=repr(short(top)))
        del cpu_model, ref

    tcfg = copy.deepcopy(sm)
    tmp = tempfile.mkdtemp(prefix="tlie_tf_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "mqar-sm-attention")
    tcfg["train"].update(total_steps=TF_STEPS, eval_every=TF_EVAL_EVERY)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    test_split = (test_x, test_y)
    try:
        with Phase("tf_train") as ph:
            fwd_before = LAUNCHES["flash_attention_fwd"]
            t0 = time.perf_counter()
            result = train(tcfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            path5 = dict(LAUNCHES)
            n_eval_batches = len(result.history) * (len(test_x) // bsz)
            # one forward launch per layer per step and eval batch, one of each
            # backward per layer per step; no other kernel
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(flash_attention_fwd=fwd_before + n_layers * (TF_STEPS + n_eval_batches),
                        flash_attention_bwd_dkv=n_layers * TF_STEPS,
                        flash_attention_bwd_dq=n_layers * TF_STEPS)
            if path5 != want:
                raise AssertionError(f"transformer training launches {path5}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite transformer training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(smm, generator=torch.Generator().manual_seed(sm["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"transformer parameters that did not move: {frozen}")
            ph.fields.update(steps=TF_STEPS, seconds=f"{train_s:.2f}", eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr(path5))

        with Phase("tf_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"transformer checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(tmp, "analysis")
            before = LAUNCHES["flash_attention_fwd"]
            eig, eig_init, perc, perc_init, _, _ = eval_eig(
                tcfg, {"save_path": eig_dir}, perf, ckpt_path, device=dev, batch=test_x[:bsz])
            if LAUNCHES["flash_attention_fwd"] - before != 2 * n_layers:
                raise AssertionError("eval_eig's two forwards did not go through the kernel")
            live = extract_attention_family(result.eval_model, inputs, smm)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, L - 1, smm["num_heads"], n_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"transformer spectra {eig.shape}, {eig_init.shape}")
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if not (np.array_equal(saved, eig) and live_rel <= 1e-6):
                raise AssertionError(f"transformer spectra from the checkpoint differ from the "
                                     f"live model's: {live_rel}")
            if not (np.all(eig_init > 0) and np.all(eig > 0) and np.isfinite(eig).all()):
                raise AssertionError("transformer η not finite and positive")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{smm['hidden_dim']}"):
                raise AssertionError(f"transformer artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_rel=f"{live_rel:.3e}",
                             eta_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())

        with Phase("tf_serving") as ph:
            n_new = 16
            dec = Decoder(smm, result.eval_model)
            prompts = inputs[:, :TF_PROMPT]
            before = LAUNCHES["flash_attention_fwd"]
            _, last = dec.prefill(prompts, TF_PROMPT + n_new)
            torch.cuda.synchronize()
            if LAUNCHES["flash_attention_fwd"] - before != n_layers:
                raise AssertionError("prefill did not go through flash_attention_fwd once a layer")
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"transformer prefill vs forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if out.shape != (bsz, TF_PROMPT + n_new) or not torch.equal(out[:, :TF_PROMPT], prompts):
                raise AssertionError(f"transformer generate output {tuple(out.shape)}")
            if int(out.min()) < 0 or int(out.max()) >= smm["output_dim"]:
                raise AssertionError("generated ids out of the vocab")
            # the step path over the KV cache against the full forward on the
            # generated tokens, every position
            n_check = 8
            sw = dec.stepwise_logits(out[:n_check])
            with torch.no_grad():
                full = result.eval_model(out[:n_check])
            step_err = (sw - full).abs().max().item()
            if not torch.allclose(sw, full, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"transformer stepwise vs forward: {step_err}")
            try:
                dec.generate(inputs[:2], n_new)  # 512 + 16 positions against a table of 512
                raise AssertionError("generation past max_pos_embed did not raise")
            except ValueError:
                pass
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                             prefill_vs_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_forward_max_abs=f"{step_err:.3e}",
                             past_max_pos_embed="ValueError")
        path5_all = dict(LAUNCHES)
        print(f"[launches] transformer forward and training: {path5}; with eval_eig, serving: "
              f"{path5_all}", flush=True)
        if any(path5_all[k] for k in LAUNCHES if k not in kernels):
            raise AssertionError(f"path 5 launched other kernels: {path5_all}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step (sparse head, AdamW behind the global-norm clip) from the same
    # weights and batch at dropout 0, on the card (kernels) and on the CPU
    # (plain versions), both held to the same step in float64 on the CPU
    step_cfg = dict(smm, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(smm, train_split[1], test_y)
    lrs = {"regular": f["lr"]}
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device):
        m, _, family = build_models(step_cfg, generator=torch.Generator().manual_seed(sm["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase("tf_train_step_card_vs_cpu") as ph:
        # Wqkv: the projection that the dK/dV kernel's gradients sum into
        card_m, card_opt, clip = step_card_vs_cpu(
            ph, "transformer", fresh, dev, x_step, y_step, lrs, sparse_k, TF_GRAD_RTOL_OF_MAX,
            watch=("wqkv_grad_err_over_allowed", lambda n: "Wqkv" in n))

    with Phase("tf_train_step_timing") as ph:
        ph.fields.update(step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip),
            bsz * L, "flash_attention", "flash_attention"))
        del card_m, card_opt

    # the kernels at the MQAR shape: time, bound, plain version and SDPA
    with Phase("flash_attention_timing") as ph:
        attn_times, sdpa_kernels = time_flash_attention(fa, *attn_io, flush)
        for name, t in attn_times.items():
            ph.fields[name] = timing_fields(t, "sdpa_ms", "over_library")
        # which SDPA backend ran for float32, and its device kernels by name
        ph.fields["sdpa_fwd_backend"] = sdpa_kernels[0]
        ph.fields["sdpa_fwd_device_kernels_ms"] = repr(sdpa_kernels[1])
        # the same at ATTN_SHAPES' second shape, for the record
        second_name, second_io = second
        for name, t in time_flash_attention(fa, *second_io, flush)[0].items():
            ph.fields[f"{name}_{second_name}"] = timing_fields(t, "sdpa_ms", "over_library")
        del attn_io, second, second_io
        torch.cuda.empty_cache()
    return path5_all, attn_times, attn_errs


def attention_family_path(dev, test_x, test_y, train_split, want_files, full, tag: str,
                          steps: int, eval_every: int):
    """Main path 6 (``MQAR_LIN_ATTENTION_FULL``: 2 layers, d_model 128, one
    head of 128, vocab 8192, position table 512, L 512, batch 64, dropout
    0.1) or 7 (``MQAR_NORM_ATTENTION_CONV_FULL``: the same widths, softplus
    decay with its offset, elu features, scale_B, conv 4, no position table),
    weights from seed 1919.  Neither reaches a Pallas kernel in tlie_tpu (the
    chunked linear attention is XLA einsums there, PyTorch matmuls here), so
    no port kernel may launch on it: with every launch count set to 0, the
    forward on the test batch (card against CPU), ``steps`` training steps
    with 2 evals, the checkpoint reloaded and eigen-analysed (η from
    activations, against the live model's), and serving (64 prompts of 496
    tokens, prefill plus 16 greedy tokens, the step path against the full
    forward); the counts are read and printed there.  Then one card step
    against the CPU step and the step's time, device busy time, idle share
    and six largest device kernels, and the chunked linear attention's
    forward and backward alone, with its share of the step's device time.
    Returns the path's launch counts."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import derive_runtime_fields, train_fields
    from tlie_tpu_torch.data import masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops.linear_attention import chunked_linear_attention
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    mc = full["model"]
    n_layers, bsz, L = mc["num_layers"], full["train"]["batch_size"], mc["seq_len"]
    _, model, _ = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                               device=dev)
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mc["input_dim"],
                                lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase(f"{tag}_forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if logits.shape != (bsz, L, mc["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward output {tuple(logits.shape)}")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top = top_device_ops(lambda: model(inputs))
        _, cpu_model, _ = build_models(mc, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"{tag} card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         vs_cpu_max_abs=f"{cpu_err:.3e}", top_device_ops_ms=repr(short(top)))
        del cpu_model, ref

    tcfg = copy.deepcopy(full)
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(full["save"]))
    tcfg["train"].update(total_steps=steps, eval_every=eval_every)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
    try:
        with Phase(f"{tag}_train") as ph:
            t0 = time.perf_counter()
            result = train(tcfg, train_split, (test_x, test_y), device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite {tag} training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(mc, generator=torch.Generator().manual_seed(full["seed"]),
                                device=dev)[0].state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"{tag} parameters that did not move: {frozen}")
            ph.fields.update(steps=steps, seconds=f"{train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]))

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"{tag} checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(tmp, "analysis")
            eig, eig_init, perc, perc_init, _, _ = eval_eig(
                tcfg, {"save_path": eig_dir}, perf, ckpt_path, device=dev, batch=test_x[:bsz])
            live = extract_attention_family(result.eval_model, inputs, mc)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, L - 1, mc["num_heads"], n_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"{tag} spectra {eig.shape}, {eig_init.shape}")
            live_rel = float(np.max(np.abs(eig - live) / np.abs(live)))
            if not (np.array_equal(saved, eig) and live_rel <= 1e-6):
                raise AssertionError(f"{tag} spectra from the checkpoint differ from the live "
                                     f"model's: {live_rel}")
            if not (np.all(eig_init > 0) and np.all(eig > 0) and np.isfinite(eig).all()
                    and np.isfinite(eig_init).all()):
                raise AssertionError(f"{tag} η not finite and positive")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{mc['hidden_dim']}"):
                raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_rel=f"{live_rel:.3e}",
                             eta_range_trained=f"[{eig.min():.4g}, {eig.max():.4g}]",
                             eta_median_init_trained=f"{np.median(eig_init):.4g},"
                                                     f"{np.median(eig):.4g}",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())

        with Phase(f"{tag}_serving") as ph:
            n_new = 16
            dec = Decoder(mc, result.eval_model)
            prompts = inputs[:, :ATT_PROMPT]
            _, last = dec.prefill(prompts, ATT_PROMPT + n_new)
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            prefill_err = (last - full_prompt).abs().max().item()
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"{tag} prefill vs forward: {prefill_err}")
            dec.generate(prompts, n_new)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.generate(prompts, n_new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if out.shape != (bsz, ATT_PROMPT + n_new) or not torch.equal(out[:, :ATT_PROMPT],
                                                                         prompts):
                raise AssertionError(f"{tag} generate output {tuple(out.shape)}")
            if int(out.min()) < 0 or int(out.max()) >= mc["output_dim"]:
                raise AssertionError("generated ids out of the vocab")
            # the step path over the O(1) state against the full forward on
            # the generated tokens, every position
            n_check = 4
            sw = dec.stepwise_logits(out[:n_check])
            with torch.no_grad():
                full_logits = result.eval_model(out[:n_check])
            step_err = (sw - full_logits).abs().max().item()
            if not torch.allclose(sw, full_logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(f"{tag} stepwise vs forward: {step_err}")
            past = "no position table"
            if mc["max_pos_embed"] > 0:
                try:
                    dec.generate(inputs[:2], n_new)  # 512 + 16 positions, a table of 512
                    raise AssertionError("generation past max_pos_embed did not raise")
                except ValueError:
                    past = "ValueError"
            ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                             tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                             prefill_vs_forward_max_abs=f"{prefill_err:.3e}",
                             stepwise_vs_forward_max_abs=f"{step_err:.3e}",
                             past_max_pos_embed=past)
        launches = dict(LAUNCHES)
        print(f"[launches] {tag} attention forward, training, eval_eig and serving: {launches} "
              "(expected: none; tlie_tpu reaches no Pallas kernel on this path)", flush=True)
        if any(launches.values()):
            raise AssertionError(f"the {tag} attention path launched port kernels: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one step (sparse head, AdamW behind the global-norm clip) from the same
    # weights and batch at dropout 0, on the card and on the CPU, both held to
    # the same step in float64 on the CPU
    step_cfg = dict(mc, dropout=0.0)
    f = train_fields(tcfg)
    sparse_k = sparse_head_k_for(mc, train_split[1], test_y)
    lrs = {"regular": f["lr"]}
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()

    def fresh(device):
        m, _, family = build_models(step_cfg,
                                    generator=torch.Generator().manual_seed(full["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, step_cfg, tcfg["train"], f)
        return m, opt, clip

    with Phase(f"{tag}_train_step_card_vs_cpu") as ph:
        card_m, card_opt, clip = step_card_vs_cpu(ph, tag, fresh, dev, x_step, y_step, lrs,
                                                  sparse_k, TF_GRAD_RTOL_OF_MAX)

    with Phase(f"{tag}_train_step_timing") as ph:
        fields = step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k, clip_norm=clip),
            bsz * L, None, "", n_top=6)
        ph.fields.update(fields)
        # the chunked linear attention alone, forward and backward, at the
        # path's (B, L, H, head_dim) with positive features and the layer's
        # normaliser choice: its share of the step's device time, the
        # number that says whether the op earns a kernel
        att = card_m.layers[0].attention
        normalizer = not hasattr(att, "Wvqkn")
        g = torch.Generator(device=dev).manual_seed(7)
        qkv = [torch.randn(bsz, L, att.num_heads, d, device=dev, generator=g)
               for d in (att.head_dim, att.head_dim, att.v_dim)]
        q, k = (torch.nn.functional.elu(x) + 1 for x in qkv[:2])
        leaves = [x.requires_grad_() for x in (q, k, qkv[2])]
        cot = torch.randn(bsz, L, att.num_heads, att.v_dim, device=dev, generator=g)

        def fwd_bwd():
            out = chunked_linear_attention(*leaves, return_normalizer=normalizer)
            y = out[0] / out[1][..., None] if normalizer else out
            torch.autograd.grad((y * cot).sum(), leaves)

        # between events (host waits inside it included) and, from the
        # profiler, the device time of its own kernels
        op_ms = median(cuda_ms(fwd_bwd, 11))
        op_busy = sum(t for _, t in top_device_ops(fwd_bwd, k=1000))
        ph.fields["chunked_linear_attention_fwd_bwd_ms"] = f"{op_ms:.4f}"
        ph.fields["chunked_linear_attention_fwd_bwd_device_busy_ms"] = f"{op_busy:.4f}"
        if fields["device_busy_ms"] != "not measured" and op_busy > 0:
            share = n_layers * op_busy / float(fields["device_busy_ms"])
            ph.fields["chunked_linear_attention_share_of_device"] = f"{share:.4f}"
        del card_m, card_opt, leaves, qkv, q, k, cot
        torch.cuda.empty_cache()
    return launches


REPO = os.path.dirname(os.path.abspath(__file__))


def wikitext_splits():
    """The synthetic WikiText-103 stream of ``configs/wikitext-mamba2-short.yaml``
    (block 1024), built once for paths 8 and 9: (train, test, l_max)."""
    from tlie_tpu_torch.config import load_yaml
    from tlie_tpu_torch.data import WikiText

    with Phase("wt_mamba2_data") as ph:
        cfg = load_yaml(os.path.join(REPO, "configs", "wikitext-mamba2-short.yaml"))
        data = WikiText(**cfg["dataset"])
        train_split, test_split = data.split("train"), data.split("test")
        ph.fields.update(train_blocks=len(train_split[0]), test_blocks=len(test_split[0]),
                         block=data.l_max, vocab=data.d_output)
    return train_split, test_split, data.l_max


def wikitext_mamba2_path(dev, splits, config: str, tag: str, want_files):
    """Main path 8 (``configs/wikitext-mamba2-short.yaml``: 6 layers, d_model
    and N 512, 8 heads of 64, block 1024, batch 8, vocab 50,257, the dense
    head, float32) or 9 (``configs/wikitext-mamba2-short-bf16.yaml``, the
    same model with ``compute_dtype: bfloat16``), weights from seed 1919, on
    the synthetic stream: with every count set to 0, ``WT_STEPS`` training
    steps and one perplexity eval; the counts read there must be the
    decay attention's three kernels of the path's dtype alone (the forward
    once per layer per step and eval batch, each backward once per layer per
    step).  Then the checkpoint reloaded and eigen-analysed (float32, as
    tlie_tpu extracts: the analysis launches the float32 forward, counted
    apart), and a training step's time, idle share and the decay
    attention's share of device time.  Returns the counts after the
    eigen-analysis (training's and the analysis's float32 forwards)."""
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_attention_family
    from tlie_tpu_torch.config import derive_runtime_fields, load_yaml, train_fields
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops.decay_attention import launch_name
    from tlie_tpu_torch.training import restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.state import make_family_optimizer

    train_split, test_split, l_max = splits
    cfg = load_yaml(os.path.join(REPO, "configs", config))
    m = cfg["model"]
    bsz, layers = cfg["train"]["batch_size"], m["num_layers"]
    dtype = torch.bfloat16 if m.get("compute_dtype") == "bfloat16" else torch.float32
    names = {k: launch_name(k, dtype) for k in ("fwd", "bwd_i", "bwd_j")}
    tmp = tempfile.mkdtemp(prefix=f"tlie_{tag}_")
    cfg["save"] = os.path.join(tmp, "checkpoint", os.path.basename(cfg["save"]))
    cfg["train"].update(total_steps=WT_STEPS, eval_every=WT_STEPS)
    cfg = derive_runtime_fields(cfg, l_max, len(train_split[0]))
    m = cfg["model"]
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase(f"{tag}_train") as ph:
            t0 = time.perf_counter()
            result = train(cfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            n_eval = len(result.history) * (len(test_split[0]) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)
            want.update({names["fwd"]: layers * (WT_STEPS + n_eval),
                         names["bwd_i"]: layers * WT_STEPS, names["bwd_j"]: layers * WT_STEPS})
            if launches != want:
                raise AssertionError(f"{tag} training launches {launches}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()) or rec["test_perf"] < 1.0:
                    raise AssertionError(f"{tag} training numbers {rec}")
            trained = result.model.state_dict()
            init = build_models(m, generator=torch.Generator().manual_seed(cfg["seed"]),
                                device=dev)[0].state_dict()
            bad = [k for k, v in trained.items()
                   if v.dtype != torch.float32 or torch.equal(v, init[k])]
            if bad:
                raise AssertionError(f"{tag} parameters not float32 or not moved: {bad}")
            ph.fields.update(steps=WT_STEPS, seconds=f"{train_s:.2f}", eval_batches=n_eval,
                             compute_dtype=str(dtype),
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr({k: v for k, v in launches.items() if v}))
            del init

        with Phase(f"{tag}_checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"{tag} checkpoint entry {k} differs from the live "
                                         "weights")
            batch = test_split[0][:bsz]  # configs/analysis/wikitext.yaml's batch_size: 8
            before = dict(LAUNCHES)
            eig_dir = os.path.join(tmp, "analysis")
            eig, eig_init, perc, perc_init, _, _ = eval_eig(cfg, {"save_path": eig_dir}, perf,
                                                            ckpt_path, device=dev, batch=batch)
            eig_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                            if LAUNCHES[k] != before[k]}
            path_all = dict(LAUNCHES)  # the path's: training and the analysis
            # the spectra of the trained weights in a float32 model
            f32_cfg = {k: v for k, v in m.items() if k != "compute_dtype"}
            _, f32_model, _ = build_models(f32_cfg, generator=torch.Generator(), device=dev)
            f32_model.load_state_dict(ckpt["model"])
            live = extract_attention_family(
                f32_model, torch.as_tensor(np.asarray(batch), device=dev).long(), f32_cfg)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            want_shape = (bsz, m["seq_len"], m["num_heads"], layers)
            if eig.shape != want_shape or eig.dtype != np.float32 or not np.array_equal(eig, live):
                raise AssertionError(f"{tag} spectra {eig.shape} {eig.dtype} differ from the "
                                     "float32 extraction of the trained weights")
            if not (np.all((eig_init > 0) & (eig_init <= 1)) and np.all((eig > 0) & (eig <= 1))):
                raise AssertionError(f"{tag} eigenvalues outside (0, 1]")
            if files != want_files or not run_dir.startswith("WikiText"):
                raise AssertionError(f"{tag} artifacts {run_dir}: {files}")
            if eig_launches != {"decay_attention_fwd": 2 * layers}:
                raise AssertionError(f"{tag} eigen-analysis launches {eig_launches}, expected "
                                     "the float32 forward of the init and trained models")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perplexity=f"{perf:.3f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_launches=repr(eig_launches),
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())
            del f32_model, ckpt

        with Phase(f"{tag}_train_step_timing") as ph:
            f = train_fields(cfg)
            opt, clip = make_family_optimizer(result.model, "mamba", m, cfg["train"], f)
            x = torch.as_tensor(train_split[0][:bsz], device=dev).long()
            y = torch.as_tensor(train_split[1][:bsz], device=dev).long()
            lrs = {"regular": f["lr"]}
            ph.fields.update(step_profile(
                lambda: train_step(result.model, opt, x, y, lrs, None, clip_norm=clip),
                bsz * m["seq_len"], "decay_attention", "decay_attention", n_warm=2, n_timed=5))
            del opt, x, y
        print(f"[launches] {tag} training: {launches}; eval_eig (float32): {eig_launches}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del result
    torch.cuda.empty_cache()
    return path_all


def sweep_path(dev, test_x, test_y, train_split, want_files):
    """Main path 10: ``tlie_tpu_torch.parallel.run_sweep`` (``launch
    --sweep_parallel``) on the four seeds of ``bench.py::_bench_sweep_grid``
    (SWEEP_SEEDS) of ``MQAR_LIN_ATTENTION_FULL`` at its rate, stacked on the
    card: SWEEP_STEPS steps with an eval every SWEEP_EVAL_EVERY, each point
    checkpointed, journaled and eigen-analysed, and the stacked training's
    point-steps/s; no port kernel may launch (the counts are set to 0 before
    and read after).  Then the same sweep again, which must skip every point
    from the journal; one point of the grid at dropout 0 against the same
    point trained alone, SWEEP_CHECK_STEPS steps; and a stacked step of the
    four points against a serial step of one (path 6's model), both timed
    at dropout 0.  Returns the counts."""
    from tlie_tpu_torch.config import (
        MQAR_LIN_ATTENTION_FULL, ExperimentConfig, apply_sweep_point, derive_runtime_fields,
        train_fields,
    )
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.parallel import run_sweep
    from tlie_tpu_torch.parallel.sweep import (
        _journal_path, _load_journal, _stacked_state, optimizer_groups, stacked_adamw_step,
        stacked_grads,
    )
    from tlie_tpu_torch.training import restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer

    full = MQAR_LIN_ATTENTION_FULL
    mc = full["model"]
    bsz, L, G = full["train"]["batch_size"], mc["seq_len"], len(SWEEP_SEEDS)
    tmp = tempfile.mkdtemp(prefix="tlie_sweep_")
    raw = copy.deepcopy(full)
    raw["save"] = os.path.join(tmp, "checkpoint", "mqar-lin-attention")
    raw["train"].update(total_steps=SWEEP_STEPS, eval_every=SWEEP_EVAL_EVERY)
    raw["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    base = ExperimentConfig(raw)
    points = [{("seed",): seed} for seed in SWEEP_SEEDS]
    conf = {"batch_size": bsz, "save_path": os.path.join(tmp, "analysis")}
    test_split = (test_x, test_y)
    try:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("sweep_train") as ph:
            t0 = time.perf_counter()
            res, waves = run_sweep(base, points, train_split, test_split, L, conf, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            if any(launches.values()):
                raise AssertionError(f"the stacked sweep launched port kernels: {launches}")
            (group,) = waves
            journal = _load_journal(_journal_path(base))
            runs = sorted(os.listdir(conf["save_path"]))
            if len(journal) != G or len(runs) != G:
                raise AssertionError(f"sweep journal {len(journal)} lines, {len(runs)} analyses")
            for (path, perf), seed, hist in zip(res, SWEEP_SEEDS, group["histories"]):
                ckpt = restore_checkpoint(path)
                if ckpt["config"]["train"]["lr"] != raw["train"]["lr"] or \
                        f"-seed-{seed}-" not in path:
                    raise AssertionError(f"sweep checkpoint {path}")
                if not hist or not all(np.isfinite(v) for r in hist for v in r.values()):
                    raise AssertionError(f"sweep history {hist}")
            for run in runs:
                if sorted(os.listdir(os.path.join(conf["save_path"], run))) != want_files:
                    raise AssertionError(f"sweep artifacts {run}")
            ph.fields.update(points=G, steps=group["steps"],
                             train_seconds=f"{group['train_seconds']:.2f}",
                             point_steps_per_s=f"{group['point_steps_per_s']:.1f}",
                             wall_seconds_with_evals_checkpoints_eval_eig=f"{wall:.2f}",
                             perfs=repr([round(p, 4) for _, p in res]),
                             histories=repr([[{k: round(v, 4) for k, v in r.items()} for r in h]
                                             for h in group["histories"]]))

        with Phase("sweep_resume") as ph:
            t0 = time.perf_counter()
            again, again_waves = run_sweep(base, points, train_split, test_split, L, conf,
                                           device=dev)
            if again_waves or again != res:
                raise AssertionError("the rerun of the sweep trained points in its journal")
            if len(_load_journal(_journal_path(base))) != G:
                raise AssertionError("the rerun of the sweep wrote to its journal")
            ph.fields.update(seconds=f"{time.perf_counter() - t0:.2f}", skipped=G)

        with Phase("sweep_point_vs_serial") as ph:
            check = copy.deepcopy(raw)
            check["model"]["dropout"] = 0.0
            check["save"] = os.path.join(tmp, "check", "mqar-lin-attention")
            check["train"].update(total_steps=SWEEP_CHECK_STEPS, eval_every=SWEEP_CHECK_STEPS)
            stacked, stacked_waves = run_sweep(ExperimentConfig(check), points, train_split,
                                               test_split, L, device=dev)
            one = derive_runtime_fields(apply_sweep_point(ExperimentConfig(check), points[0]).raw,
                                        L, len(train_split[0]))
            one["save"] = None
            serial = train(one, train_split, test_split, device=dev)
            hist, ser = stacked_waves[0]["histories"][0], serial.history
            # each eval's loss or metric error over its tolerance
            over = max(abs(h[k] - s[k]) / max(SWEEP_RTOL * abs(s[k]), SWEEP_ATOL)
                       for h, s in zip(hist, ser) for k in ("train_loss", "test_loss", "test_perf"))
            got = restore_checkpoint(stacked[0][0])["model"]
            param_worst = max((got[n] - v.cpu()).abs().max().item()
                              for n, v in serial.model.state_dict().items())
            ph.fields.update(evals=len(hist), metric_err_over_tol=f"{over:.3e}",
                             param_worst=f"{param_worst:.3e}")
            if not (len(hist) == len(ser) and over <= 1.0 and param_worst <= SWEEP_PARAM_ATOL):
                raise AssertionError(f"stacked point vs serial run: {ph.fields}")
            del serial, stacked, got

        with Phase("sweep_step_timing") as ph:
            # the four points' stacked step and one point's serial step, at
            # dropout 0 and the config's rate, on the same batches
            step_cfg = dict(mc, dropout=0.0)
            f = train_fields(derive_runtime_fields(raw, L, len(train_split[0])))
            sparse_k = sparse_head_k_for(mc, train_split[1], test_y)
            grid = [ExperimentConfig(dict(raw, seed=seed, model=step_cfg)) for seed in SWEEP_SEEDS]
            model0, _, _, params, buffers = _stacked_state(grid, list(range(G)), dev)
            group_of, clip = optimizer_groups(model0, "transformer", step_cfg, raw["train"], f)
            moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
            grads_fn = stacked_grads(model0, sparse_k)
            x = torch.as_tensor(train_split[0][:bsz], device=dev).long()
            y = torch.as_tensor(train_split[1][:bsz], device=dev).long()
            xs, ys = x.expand(G, -1, -1), y.expand(G, -1, -1)
            lrs = {"regular": torch.full((G,), f["lr"], device=dev)}
            n_step = [0]

            def stacked_step():
                n_step[0] += 1
                grads, _ = grads_fn(params, buffers, xs, ys)
                stacked_adamw_step(params, grads, moments, n_step[0], lrs, group_of, f["betas"],
                                   clip)

            stacked_fields = step_profile(stacked_step, G * bsz * L, None, "", n_top=6)
            serial_m = build_models(step_cfg, generator=torch.Generator().manual_seed(full["seed"]),
                                    device=dev)[0]
            serial_opt, _ = make_family_optimizer(serial_m, "transformer", step_cfg, raw["train"],
                                                  f)
            serial_fields = step_profile(
                lambda: train_step(serial_m, serial_opt, x, y, {"regular": f["lr"]}, sparse_k,
                                   clip_norm=clip), bsz * L, None, "", n_top=6)
            stacked_ms, serial_ms = (float(stacked_fields["ms_per_step"]),
                                     float(serial_fields["ms_per_step"]))
            ph.fields.update({f"stacked_{k}": v for k, v in stacked_fields.items()})
            ph.fields.update({f"serial_{k}": v for k, v in serial_fields.items()})
            ph.fields.update(stacked_point_steps_per_s=f"{G * 1e3 / stacked_ms:.1f}",
                             serial_steps_per_s=f"{1e3 / serial_ms:.1f}",
                             stacking_gain=f"{G * serial_ms / stacked_ms:.3f}")
            del model0, params, moments, serial_m, serial_opt
        print(f"[launches] stacked sweep: {launches} (expected: none)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    # imported after the card check: a copy of this script alone has no package
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import (
        extract_attention_family, extract_ssm_family, ssm_layer_params,
    )
    from tlie_tpu_torch.config import (
        MQAR_LIN_ATTENTION_FULL, MQAR_LRU_FULL, MQAR_MAMBA2_FULL, MQAR_NORM_ATTENTION_CONV_FULL,
        WIKITEXT_LRU_SHORT, derive_runtime_fields, train_fields,
    )
    from tlie_tpu_torch.data import MQAR, WikiText, masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES, diag_linear_scan
    from tlie_tpu_torch.ops import decay_attention as dattn
    from tlie_tpu_torch.ops.attention import FLASH_ATTENTION
    from tlie_tpu_torch.ops import fused_xent as fx
    from tlie_tpu_torch.ops._build import find_nvcc
    from tlie_tpu_torch.ops.ssd import _auto_chunk
    from tlie_tpu_torch.ops.scan import (
        DIAG_SCAN, DIAG_SCAN_BWD, diag_scan_bwd_cuda, diag_scan_bwd_plain, diag_scan_cuda,
        diag_scan_plain,
    )
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_family_optimizer, make_optimizer
    from tlie_tpu_torch.training.steps import cross_entropy_loss, head_logits

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")

    # 1. the device
    with Phase("device") as ph:
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        try:
            import yaml  # noqa: F401
            has_yaml = True
        except ImportError:
            has_yaml = False
        ph.fields.update(kind=repr(kind), smi=repr(smi), torch=torch.__version__,
                         cuda=torch.version.cuda, count=torch.cuda.device_count(),
                         yaml=has_yaml)

    # 2. the nvcc build: one nvcc per source, all started together
    with Phase("build") as ph:
        libs = {"diag_scan": DIAG_SCAN, "diag_scan_bwd": DIAG_SCAN_BWD,
                "fused_xent": fx.FUSED_XENT, "decay_attention": dattn.DECAY_ATTENTION,
                "flash_attention": FLASH_ATTENTION}
        with ThreadPoolExecutor(len(libs)) as pool:
            reports = dict(zip(libs, pool.map(lambda lib: lib.load(), libs.values())))
        for name, report in reports.items():
            regs = [ln.split(":", 1)[1].strip() for ln in report.log.splitlines()
                    if "registers" in ln]
            ph.fields[f"{name}_nvcc_s"] = f"{report.seconds:.2f}"
            ph.fields[f"{name}_ptxas"] = repr(regs)
            ph.fields[f"{name}_spill_bytes"] = repr(ptxas_spills(report.log))
        # the fused head's three kernels, the flash attention's three and the
        # decay attention's three run their products on the tensor cores:
        # each one's SASS holds TF32 HMMAs, and the decay attention's
        # bfloat16 instantiations bfloat16 ones
        hmma = tensor_core_hmma(
            [reports[lib].path for lib in sorted(set(TC_KERNELS.values()))], find_nvcc())
        ph.fields["tensor_core_sass_hmma"] = repr(hmma)
        if sorted(hmma) != sorted(TC_KERNELS) or not all(
                hmma[name].get(op, 0) > 0 for name, op in TC_HMMA.items()):
            raise AssertionError(f"tensor-core kernels without their HMMA: {hmma}")

    # 3. each kernel against its plain version, at the path's shape and two others
    gen = torch.Generator(device=dev).manual_seed(0)

    def ring(shape):
        r = 0.9 + 0.09 * torch.rand(shape, device=dev, generator=gen)
        th = 6.28 * torch.rand(shape, device=dev, generator=gen)
        return r * torch.cos(th), r * torch.sin(th)

    def normal_pair(shape):
        return (torch.randn(shape, device=dev, generator=gen),
                torch.randn(shape, device=dev, generator=gen))

    with Phase("kernel_vs_plain") as ph:
        # (a, b, reverse); a block takes 16 channels of one batch row and
        # walks time in rounds of 256 steps (16 chunks of 16)
        cases = {
            "complex_b64_l512_n128_bcast_a": (ring((512, 128)), normal_pair((64, 512, 128)),
                                              False),
            "real_b64_l512_n128_full_a": (ring((64, 512, 128))[0].abs(),
                                          torch.randn(64, 512, 128, device=dev, generator=gen),
                                          False),
            "complex_b3_l997_n96_const_a": (ring((96,)), normal_pair((3, 997, 96)), False),
            # the WikiText LM's shape: 32 blocks of 16 channels a batch row,
            # four rounds each
            "complex_b8_l1024_n512_lambda": (ring((512,)), normal_pair((8, 1024, 512)), False),
            # a ragged L of five whole rounds and a sixth, ragged N, reversed,
            # with a decay that varies in time
            "complex_b3_l1301_n40_full_a_rev": (ring((3, 1301, 40)), normal_pair((3, 1301, 40)),
                                                True),
        }
        for name, (a, b, reverse) in cases.items():
            h = diag_scan_cuda(a, b, reverse=reverse)
            torch.cuda.synchronize()
            err, scale = scan_err(h, diag_scan_plain(a, b, reverse=reverse))
            tol = SCAN_RTOL_OF_MAX * scale
            # no atomics, a fixed fold order: a second launch gives the same bits
            same = all(torch.equal(x, y) for x, y in
                       zip(_planes(h), _planes(diag_scan_cuda(a, b, reverse=reverse))))
            ph.fields[name] = (f"max_abs={err:.3e},rel_to_max={err / scale:.3e},tol={tol:.3e},"
                               f"same_bits_twice={same}")
            if not (err <= tol and same):
                raise AssertionError(f"diag_scan {name}: {ph.fields[name]}")

    # the backward kernel against diag_scan_bwd_plain, and the forward
    # kernel's reverse mode against the plain reverse scan
    with Phase("bwd_kernel_vs_plain") as ph:
        cases = {
            "complex_b64_l512_n128_lambda": (ring((128,)), normal_pair((64, 512, 128))),
            "real_b8_l512_n128_full_a": (ring((8, 512, 128))[0].abs(),
                                         torch.randn(8, 512, 128, device=dev, generator=gen)),
            "complex_b3_l997_n96_lambda": (ring((96,)), normal_pair((3, 997, 96))),
            "complex_b8_l1024_n512_lambda": (ring((512,)), normal_pair((8, 1024, 512))),
        }
        for name, (a, b) in cases.items():
            for reverse in (False, True):
                tag = f"{name}_{'rev' if reverse else 'fwd'}"
                h = diag_scan_cuda(a, b, reverse=reverse)
                ref = diag_scan_plain(a, b, reverse=reverse)
                torch.cuda.synchronize()
                h_err, h_scale = scan_err(h, ref)
                g = tuple(torch.randn(x.shape, device=dev, generator=gen) for x in _planes(b))
                g = g if isinstance(b, tuple) else g[0]
                da, d = diag_scan_bwd_cuda(a, ref, g, reverse=reverse)
                torch.cuda.synchronize()
                da_ref, d_ref = diag_scan_bwd_plain(a, ref, g, reverse=reverse)
                d_e, d_tol, da_e, da_ratio = bwd_err(a, ref, da, d, da_ref, d_ref, reverse)
                # no atomics: a second launch gives the same bits
                da2, d2 = diag_scan_bwd_cuda(a, ref, g, reverse=reverse)
                same = all(torch.equal(x, y) for x, y in zip(_planes(da) + _planes(d),
                                                             _planes(da2) + _planes(d2)))
                ph.fields[tag] = (f"h_rel={h_err / h_scale:.2e},d_abs={d_e:.2e}/tol={d_tol:.2e},"
                                  f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f},"
                                  f"same_bits_twice={same}")
                if not (h_err <= SCAN_RTOL_OF_MAX * h_scale and d_e <= d_tol and da_ratio <= 1.0
                        and same):
                    raise AssertionError(f"diag_scan_bwd {tag}: {ph.fields[tag]}")

    # a decay that varies by example and is constant in time, (B, 1, N):
    # the forward reads it at batch stride N and time stride 0, the backward
    # sums da over time within each row; (B1, 1, 1, N) against (B1, B2, L, N)
    # fits no one batch stride and is read from a broadcast copy.  Both
    # kernels through autograd against diag_scan_plain's autograd, real and
    # complex, forward and reversed, at a ragged L.
    with Phase("scan_per_example_decay_vs_plain") as ph:
        for a_shape, shape in (((3, 1, 40), (3, 601, 40)), ((3, 1, 1, 40), (3, 2, 601, 40))):
            for complex_mode in (False, True):
                for reverse in (False, True):
                    tag = (f"{'complex' if complex_mode else 'real'}_a{'x'.join(map(str, a_shape))}"
                           f"_{'rev' if reverse else 'fwd'}")
                    a = ring(a_shape) if complex_mode else ring(a_shape)[0].abs()
                    b = normal_pair(shape) if complex_mode else torch.randn(
                        shape, device=dev, generator=gen)
                    w = tuple(torch.randn(shape, device=dev, generator=gen) for _ in _planes(b))
                    k = len(_planes(a))

                    def run(leaves, scan):
                        args = ((tuple(leaves[:k]), tuple(leaves[k:])) if complex_mode
                                else (leaves[0], leaves[1]))
                        h = scan(*args, reverse=reverse)
                        sum((x * y).sum() for x, y in zip(_planes(h), w)).backward()
                        return tuple(x.detach() for x in _planes(h))

                    leaves = [x.clone().requires_grad_() for x in _planes(a) + _planes(b)]
                    ref_leaves = [x.clone().requires_grad_() for x in _planes(a) + _planes(b)]
                    before = dict(LAUNCHES)
                    h = run(leaves, diag_linear_scan)
                    torch.cuda.synchronize()
                    if (LAUNCHES["diag_scan"] != before["diag_scan"] + 1
                            or LAUNCHES["diag_scan_bwd"] != before["diag_scan_bwd"] + 1):
                        raise AssertionError(f"scan {tag} did not go through both kernels")
                    ref = run(ref_leaves, diag_scan_plain)
                    h_err, h_scale = scan_err(h, ref)
                    db = tuple(x.grad for x in leaves[k:])
                    db_ref = tuple(x.grad for x in ref_leaves[k:])
                    d_err, d_scale = scan_err(db, db_ref)
                    da = tuple(x.grad for x in leaves[:k])
                    da_ref = tuple(x.grad for x in ref_leaves[:k])
                    _, _, da_e, da_ratio = bwd_err(a, ref, da, db, da_ref, db_ref, reverse)
                    ok_shape = all(x.shape == a_shape for x in da)
                    ph.fields[tag] = (f"h_rel={h_err / h_scale:.2e},db_rel={d_err / d_scale:.2e},"
                                      f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f},"
                                      f"da_shape_ok={ok_shape}")
                    if not (h_err <= SCAN_RTOL_OF_MAX * h_scale
                            and d_err <= SCAN_RTOL_OF_MAX * d_scale and da_ratio <= 1.0
                            and ok_shape):
                        raise AssertionError(f"scan per-example decay {tag}: {ph.fields[tag]}")

    # the fused head's three kernels against the plain version, at the LM's
    # (B·L, D, V) and two small shapes; times at the LM's shape
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB, over the 50 MB L2
    with Phase("fused_xent_vs_plain") as ph:
        xent_errs = {}
        for name, (M, D, V) in XENT_SHAPES.items():
            h, weight, b, labels = xent_inputs(dev, gen, M, D, V)
            fields, errs, (lse, gscale) = check_fused_xent(
                fx, h, weight.t(), b, labels, f64=(M, D, V) == XENT_SHAPES["m8192_d512_v50257"])
            ph.fields[name] = repr(fields)
            if not xent_errs:  # the LM's shape comes first
                xent_errs, xent_io = errs, (h, weight, b, labels, lse, gscale)
    with Phase("fused_xent_timing") as ph:
        h, weight, b, labels, lse, gscale = xent_io
        xent_times = time_fused_xent(fx, h, weight.t(), b, labels, lse, gscale, flush)
        for name, (k_ms, w_ms, p_ms, l_ms, bound, by, n_bytes, flops,
                   f32) in xent_times.items():
            ph.fields[name] = (f"ms_cold_median={k_ms:.4f},ms_warm_median={w_ms:.4f},"
                               f"plain_ms={p_ms:.4f},"
                               f"library_ms={l_ms:.4f},over_library={k_ms / l_ms:.3f},"
                               f"bound_ms={bound:.4f}({by}),over_bound={k_ms / bound:.3f},"
                               f"bound_f32_ms={f32:.4f},"
                               f"gflop={flops / 1e9:.1f},tflops={flops / k_ms / 1e9:.2f}")
        del h, weight, b, labels, lse, gscale, xent_io
        torch.cuda.empty_cache()

    # the decay attention's three kernels against the plain version, at the
    # MQAR Mamba-2 shape, the WikiText Mamba-2 shape and a ragged one (with
    # float64 for the record there); the MQAR shape's inputs are kept for the
    # timing
    with Phase("decay_attention_vs_plain") as ph:
        decay_errs = {}
        for name, (BG, Q, N, Hg, P) in SSD_SHAPES.items():
            ins = decay_inputs(dev, gen, BG, Q, N, Hg, P)
            fields, errs = check_decay_attention(dattn, *ins, f64=name.startswith("ragged"))
            ph.fields[name] = repr(fields)
            if not decay_errs:  # the MQAR shape comes first
                decay_errs, decay_io = errs, ins
            del ins
        torch.cuda.empty_cache()

    # the decay attention's bfloat16 kernels against the plain bfloat16
    # version, at the WikiText Mamba-2 shape (path 9's), the MQAR shape and a
    # ragged one
    with Phase("decay_attention_bf16_vs_plain") as ph:
        decay_bf16_errs = {}
        for name, (BG, Q, N, Hg, P) in SSD_BF16_SHAPES.items():
            ins = decay_inputs(dev, gen, BG, Q, N, Hg, P, dtype=torch.bfloat16)
            fields, errs = check_decay_attention(dattn, *ins, f64=False)
            ph.fields[name] = repr(fields)
            for k, v in errs.items():
                decay_bf16_errs[k] = max(decay_bf16_errs.get(k, 0.0), v)
            del ins
        torch.cuda.empty_cache()

    # the full-width model, its data and its weights
    cfg = MQAR_LRU_FULL
    mcfg = cfg["model"]
    _, model, _ = build_models(mcfg, generator=torch.Generator().manual_seed(cfg["seed"]),
                               device=dev)
    data = MQAR(**cfg["dataset"])
    test_x, test_y = data.split("test")
    bsz, L = cfg["train"]["batch_size"], mcfg["seq_len"]
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mcfg["input_dim"],
                                lang_model=True, device=dev)
    n_layers = mcfg["num_layers"]
    n_new, n_check = 16, 8

    # main path 1, evaluation, eigen-analysis and serving: every count set
    # to 0 here, read after serving
    for k in LAUNCHES:
        LAUNCHES[k] = 0

    # 4. forward evaluation
    with Phase("forward") as ph, torch.no_grad():
        logits = model(inputs)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] != n_layers:
            raise AssertionError(f"forward launched diag_scan {LAUNCHES['diag_scan']} times, "
                                 f"expected {n_layers}")
        if logits.shape != (bsz, L, mcfg["output_dim"]) or not torch.isfinite(logits).all():
            raise AssertionError(f"forward output {tuple(logits.shape)} not finite/expected")
        acc = float(masked_accuracy(logits, labels))
        fwd_ms = min(cuda_ms(lambda: model(inputs), 3))
        top_ops = top_device_ops(lambda: model(inputs))
        # the same weights on the CPU (plain scan) for two examples
        _, cpu_model, _ = build_models(mcfg, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         diag_scan_launches_per_forward=n_layers,
                         vs_cpu_max_abs=f"{cpu_err:.3e}",
                         top_device_ops_ms=repr(short(top_ops)))

    # 5. eigen-analysis into a temporary directory
    tmp = tempfile.mkdtemp(prefix="tlie_eig_")
    try:
        with Phase("eval_eig") as ph:
            eig, eig_init, perc, perc_init, ph_perc, ph_init = eval_eig(
                cfg, {"save_path": tmp}, acc, model, device=dev)
            if eig.shape != (mcfg["state_dim"], n_layers) or eig_init.shape != eig.shape:
                raise AssertionError(f"eig shape {eig.shape}")
            r = np.abs(eig_init)
            phase = np.mod(np.angle(eig_init), 2 * np.pi)
            if not (np.all(r >= mcfg["r_min"] - 1e-6) and np.all(r <= mcfg["r_max"] + 1e-6)
                    and np.all(phase <= 6.28 + 1e-5)):
                raise AssertionError("init spectra off the [r_min, r_max] ring / phase range")
            (out_dir,) = [os.path.join(tmp, d) for d in os.listdir(tmp)]
            files = sorted(os.listdir(out_dir))
            want_files = sorted([f"{k}.npy" for k in (
                "eig", "eig_init", "percentage", "percentage_init", "percentage_phase",
                "percentage_phase_init", "percentage_mean", "percentage_init_mean",
                "percentage_std", "percentage_init_std")] + ["percentage_file.txt"]
                + (["used_config.yaml"] if has_yaml else []))
            if files != want_files:
                raise AssertionError(f"artifact files {files} != {want_files}")
            ph.fields.update(eig_shape=eig.shape, n_files=len(files),
                             radius_pct_layer0=np.round(perc[:, 0], 1).tolist())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6. serving
    with Phase("serving") as ph:
        dec = Decoder(mcfg, model)
        prompts = inputs[:, : L - n_new]
        before = LAUNCHES["diag_scan"]
        _, last = dec.prefill(prompts)
        torch.cuda.synchronize()
        if LAUNCHES["diag_scan"] - before != n_layers:
            raise AssertionError("prefill did not go through diag_scan once per layer")
        with torch.no_grad():
            full_prompt = model(prompts)[:, -1]
        if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"prefill vs forward: {(last - full_prompt).abs().max().item()}")
        dec.generate(prompts, n_new)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dec.generate(prompts, n_new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        if out.shape != (bsz, L) or not torch.equal(out[:, : L - n_new], prompts):
            raise AssertionError(f"generate output {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= mcfg["output_dim"]:
            raise AssertionError("generated ids out of the vocab")
        sw = dec.stepwise_logits(inputs[:n_check])
        step_err = (sw[:, -8:] - logits[:n_check, -8:]).abs().max().item()
        if not torch.allclose(sw[:, -8:], logits[:n_check, -8:], rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"stepwise vs forward, last 8 positions: {step_err}")
        ph.fields.update(prefill_plus_generate_s=f"{gen_s:.4f}",
                         tokens_per_s=f"{bsz * n_new / gen_s:.1f}",
                         prefill_vs_forward_max_abs=f"{(last - full_prompt).abs().max().item():.3e}",
                         stepwise_vs_forward_max_abs=f"{step_err:.3e}")

    path1 = dict(LAUNCHES)
    if path1["diag_scan"] == 0:
        raise AssertionError("diag_scan was not launched on the evaluation path")
    print(f"[launches] evaluation, eval_eig, serving: {path1}", flush=True)

    # 7. gradients through the kernels against autograd through the plain
    # loop, for every LRU parameter, at the path's inputs
    seq = model.encoder.layers[0].seq
    with torch.no_grad():
        u = model.encoder.encoder(inputs)
    with Phase("autograd_vs_plain") as ph:
        w = torch.randn(u.shape, device=dev, generator=gen)

        def lru_grads(scan_fn):
            seq.zero_grad(set_to_none=True)
            bn_re, bn_im = seq.input_matrix()
            h = scan_fn(seq.lam(), (u @ bn_re.T, u @ bn_im.T))
            (seq.readout(h, u) * w).sum().backward()
            return {n: None if p.grad is None else p.grad.clone()
                    for n, p in seq.named_parameters()}

        before = dict(LAUNCHES)
        kernel_g = lru_grads(diag_linear_scan)
        if (LAUNCHES["diag_scan"] - before["diag_scan"] != 1
                or LAUNCHES["diag_scan_bwd"] - before["diag_scan_bwd"] != 1):
            raise AssertionError("the LRU's gradient did not go through both kernels")
        plain_g = lru_grads(diag_scan_plain)
        worst = grad_err(kernel_g, plain_g)
        seq.zero_grad(set_to_none=True)
        ph.fields.update(params=sorted(plain_g), worst_rel_to_leaf_max=f"{worst:.3e}",
                         tol=GRAD_RTOL_OF_MAX)
        if not worst <= GRAD_RTOL_OF_MAX:
            raise AssertionError(f"kernel vs plain gradients: {worst}")

    # main path 2, training, checkpoint, eval_eig and serving of the trained
    # weights: every count set to 0 before training, read after training and
    # again after the checkpoint phase
    tcfg = copy.deepcopy(cfg)
    tmp = tempfile.mkdtemp(prefix="tlie_train_")
    tcfg["save"] = os.path.join(tmp, "checkpoint", "mqar-lru")
    tcfg["train"].update(total_steps=TRAIN_STEPS, eval_every=EVAL_EVERY)
    tcfg["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    try:
        with Phase("train_data") as ph:
            train_data = MQAR(**tcfg["dataset"])
            train_split = train_data.split("train")
            test_split = (test_x, test_y)
            tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
            ph.fields.update(generator=train_data.generator,
                             train_examples=f"{len(train_split[0])}(cut_from_100000)",
                             test_examples=len(test_split[0]))
            # the reference draws with the native generator wherever c++
            # builds it, and the card machine has the compiler nvcc needs
            if train_data.generator != "native" or data.generator != "native":
                raise AssertionError(f"MQAR drew with {train_data.generator}, not the native "
                                     "generator the reference uses")
        init = {k: v.clone() for k, v in build_models(
            mcfg, generator=torch.Generator().manual_seed(cfg["seed"]),
            device=dev)[0].state_dict().items()}

        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("train") as ph:
            t0 = time.perf_counter()
            result = train(tcfg, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            path2 = dict(LAUNCHES)
            n_eval_batches = len(result.history) * (len(test_split[0]) // bsz)
            want = dict.fromkeys(LAUNCHES, 0)  # the MQAR LRU trains through the sparse head
            want.update(diag_scan=n_layers * (TRAIN_STEPS + n_eval_batches),
                        diag_scan_bwd=n_layers * TRAIN_STEPS)
            if path2 != want:
                raise AssertionError(f"training launches {path2}, expected {want}")
            for rec in result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite training numbers {rec}")
            trained = result.model.state_dict()
            frozen = [k for k, v in trained.items() if torch.equal(v, init[k])]
            if frozen:
                raise AssertionError(f"parameters that did not move: {frozen}")
            ph.fields.update(steps=TRAIN_STEPS, seconds=f"{train_s:.2f}",
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in result.history]),
                             launches=repr(path2))

        # 8. the checkpoint, reloaded and eigen-analysed; serving from it
        with Phase("checkpoint_eval_eig") as ph:
            ckpt_path, perf = result
            ckpt = restore_checkpoint(ckpt_path)
            if set(ckpt["config"]) != {"model", "train", "data"}:
                raise AssertionError(f"checkpoint config keys {sorted(ckpt['config'])}")
            for k, v in trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"checkpoint entry {k} differs from the live weights")
            eig_dir = os.path.join(tmp, "analysis")
            eig, _, perc, _, _, _ = eval_eig(tcfg, {"save_path": eig_dir}, perf, ckpt_path,
                                             device=dev)
            live = extract_ssm_family(
                ssm_layer_params({k: v.cpu() for k, v in trained.items()}), mcfg)
            (run_dir,) = os.listdir(eig_dir)
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            if not (np.array_equal(eig, live) and np.array_equal(saved, live)):
                raise AssertionError("trained spectra from the checkpoint differ from eig_lru "
                                     "of the live weights")
            dec = Decoder(mcfg, result.eval_model)
            prompts = inputs[:, : L - n_new]
            out = dec.generate(prompts, n_new)
            _, last = dec.prefill(prompts)
            with torch.no_grad():
                full_prompt = result.eval_model(prompts)[:, -1]
            torch.cuda.synchronize()
            if out.shape != (bsz, L) or int(out.min()) < 0 or int(out.max()) >= mcfg["output_dim"]:
                raise AssertionError("generation from the trained weights failed")
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError("trained prefill vs forward")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             radius_pct_layer0=np.round(perc[:, 0], 1).tolist())
        path2_all = dict(LAUNCHES)
        print(f"[launches] training: {path2}; with checkpoint, eval_eig, serving: {path2_all}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 9. one step from the same weights and batch at dropout 0, on the card
    # (kernels) and on the CPU (plain versions)
    step_cfg = dict(mcfg, dropout=0.0)
    tf = tcfg["train"]
    x_step = torch.as_tensor(train_split[0][:bsz], device=dev).long()
    y_step = torch.as_tensor(train_split[1][:bsz], device=dev).long()
    sparse_k = sparse_head_k_for(mcfg, train_split[1], test_split[1])
    lrs = {"regular": tf["lr"], "ssm": tf["ssm_lr"]}

    def fresh(device):
        m, _, _ = build_models(step_cfg, generator=torch.Generator().manual_seed(cfg["seed"]),
                               device=device)
        opt = make_optimizer(m, mcfg["ssm_lr_vars"], tf["lr"], tf["ssm_lr"], tf["wd"],
                             (0.9, 0.999))
        return m, opt

    with Phase("train_step_card_vs_cpu") as ph:
        card_m, card_opt = fresh(dev)
        cpu_m, cpu_opt = fresh("cpu")
        train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k)
        train_step(cpu_m, cpu_opt, x_step.cpu(), y_step.cpu(), lrs, sparse_k)
        cpu_g = {n: p.grad for n, p in cpu_m.named_parameters()}
        card_g = {n: p.grad.cpu() for n, p in card_m.named_parameters()}
        # the same gradients in float64 on the CPU
        ref_m = fresh("cpu")[0].double()
        cross_entropy_loss(*head_logits(ref_m, x_step.cpu(), y_step.cpu(), sparse_k)).backward()
        g_ratio, g_leaf = 0.0, ""
        for n, p in ref_m.named_parameters():
            g64 = p.grad
            e_card = (card_g[n].double() - g64).abs().max().item()
            e_cpu = (cpu_g[n].double() - g64).abs().max().item()
            allowed = max(GRAD_F64_FACTOR * e_cpu, 1e-5 * g64.abs().max().item())
            if e_card / allowed > g_ratio:
                g_ratio, g_leaf = e_card / allowed, n
        g_worst = grad_err(card_g, cpu_g)
        p_worst = p_anywhere = 0.0
        for (n, p), q in zip(card_m.named_parameters(), cpu_m.parameters()):
            err = (p.detach().cpu() - q.detach()).abs()
            g = cpu_g[n].abs()
            det = g >= 1e-2 * g.max()
            p_worst = max(p_worst, err[det].max().item() if bool(det.any()) else 0.0)
            p_anywhere = max(p_anywhere, err.max().item())
        s_worst = max(((b.cpu() - c).abs() / c.abs().clamp_min(1.0)).max().item()
                      for b, c in zip(card_m.buffers(), cpu_m.buffers()))
        ph.fields.update(grad_err_over_allowed=f"{g_ratio:.3f}({g_leaf})",
                         grad_card_vs_cpu_worst_rel_to_leaf_max=f"{g_worst:.3e}",
                         param_worst_where_grad_determined=f"{p_worst:.3e}",
                         param_worst_anywhere=f"{p_anywhere:.3e}",
                         batch_stats_worst_rel=f"{s_worst:.3e}")
        if not (g_ratio <= 1.0 and p_worst <= PARAM_ATOL
                and p_anywhere <= 2 * tf["lr"] + PARAM_ATOL and s_worst <= STATS_RTOL):
            raise AssertionError(f"card vs CPU step: {ph.fields}")

    # 10. a training step's time and where it goes (dropout 0, the path's batch)
    with Phase("train_step_timing") as ph:
        def one_step():
            train_step(card_m, card_opt, x_step, y_step, lrs, sparse_k)

        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        n_timed = 20
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_timed):
            one_step()
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / n_timed
        t0 = time.perf_counter()
        for _ in range(n_timed):
            one_step()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n_timed * 1e3
        ops = top_device_ops(one_step, k=1000)
        busy = sum(t for _, t in ops)
        bwd_ms = sum(t for name, t in ops if "diag_scan_bwd" in name or "sum_rows" in name)
        by_kind = {}
        for name, t in ops:
            op_kind = next((k for k, pats in OP_KINDS if any(p in name for p in pats)), "other")
            by_kind[op_kind] = round(by_kind.get(op_kind, 0.0) + t, 4)
        ph.fields.update(ms_per_step=f"{step_ms:.3f}", wall_ms_per_synced_step=f"{wall_ms:.3f}",
                         train_tokens_per_s=f"{bsz * L / step_ms * 1e3:.0f}")
        if busy > 0:
            ph.fields.update(device_busy_ms=f"{busy:.4f}",
                             idle_share=f"{max(0.0, 1 - busy / step_ms):.3f}",
                             bwd_kernel_ms=f"{bwd_ms:.4f}",
                             bwd_kernel_share_of_device=f"{bwd_ms / busy:.4f}",
                             device_ms_by_kind=repr(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                             top_device_ops_ms=repr(short(ops[:12])))
        else:  # the profiler saw no device time: the CUDA-event time stands alone
            ph.fields.update(device_busy_ms="not measured")

    # 11. the kernels at the path's shape: time, bound, plain version; and
    # at the LM's shape (8, 1024, 512, complex, (N,) a), for the record
    lm_a, lm_b = ring((512,)), normal_pair((8, 1024, 512))
    with Phase("kernel_timing") as ph, torch.no_grad():
        lam, (bn_re, bn_im) = seq.lam(), seq.input_matrix()
        a = lam  # the (N,) pair the LRU passes
        b = (u @ bn_re.T, u @ bn_im.T)
        h = diag_scan_plain(a, b)
        err, scale = scan_err(diag_scan_cuda(a, b), h)
        if not err <= SCAN_RTOL_OF_MAX * scale:
            raise AssertionError(f"diag_scan at the path's inputs: {err}")
        scan_times = {}
        # the reverse mode at the path's inputs, beside the forward in this run
        for tag, (ta, tb), rev in (("", (a, b), False), ("_rev", (a, b), True),
                                   ("_lm_b8_l1024_n512", (lm_a, lm_b), False)):
            # each input read once (a, b), h written once; a complex
            # multiply-add (4 mul + 4 add) per element
            n_bytes = sum(distinct_bytes(t) for t in ta + tb) + sum(distinct_bytes(t) for t in tb)
            t = time_scan_kernel(lambda: diag_scan_cuda(ta, tb, reverse=rev),
                                 lambda: diag_scan_plain(ta, tb, reverse=rev),
                                 n_bytes, 8 * tb[0].numel(), flush)
            scan_times[tag] = t
            ph.fields["ms" + tag] = scan_timing_fields(t, n_bytes)
        ph.fields["max_abs_err"] = f"{err:.3e}"

    with Phase("bwd_kernel_timing") as ph, torch.no_grad():
        g = normal_pair(h[0].shape)
        da, d = diag_scan_bwd_cuda(a, h, g)
        da_ref, d_ref = diag_scan_bwd_plain(a, h, g)
        d_e, d_tol, da_e, da_ratio = bwd_err(a, h, da, d, da_ref, d_ref, False)
        if not (d_e <= d_tol and da_ratio <= 1.0):
            raise AssertionError(f"diag_scan_bwd at the path's inputs: d {d_e}, da {da_ratio}")
        bwd_times = {}
        lm_h = diag_scan_cuda(lm_a, lm_b)
        lm_g = normal_pair(lm_b[0].shape)
        for tag, (ta, th, tg) in (("", (a, h, g)), ("_lm_b8_l1024_n512", (lm_a, lm_h, lm_g))):
            tda, td = diag_scan_bwd_cuda(ta, th, tg)
            # each input read once (a, h, g), each output written once (da,
            # d); two complex multiply-adds per element
            n_bytes = sum(distinct_bytes(t) for t in ta + th + tg + tda + td)
            t = time_scan_kernel(lambda: diag_scan_bwd_cuda(ta, th, tg),
                                 lambda: diag_scan_bwd_plain(ta, th, tg), n_bytes,
                                 16 * tg[0].numel(), flush)
            bwd_times[tag] = t
            ph.fields["ms" + tag] = scan_timing_fields(t, n_bytes)
        ph.fields.update(d_max_abs_err=f"{d_e:.3e}", da_max_abs_err=f"{da_e:.3e}")
        del lm_a, lm_b, lm_h, lm_g

    # main path 3, the WikiText LM trained through the fused head, then its
    # checkpoint eigen-analysed and served: every count set to 0 before
    # training, read after training and again after serving
    lm_cfg = copy.deepcopy(WIKITEXT_LRU_SHORT)
    lm_m = lm_cfg["model"]
    lm_bsz, lm_L, lm_layers = lm_cfg["train"]["batch_size"], lm_m["seq_len"], lm_m["num_layers"]
    lm_tmp = tempfile.mkdtemp(prefix="tlie_lm_")
    lm_cfg["save"] = os.path.join(lm_tmp, "checkpoint", "wikitext-lru-short")
    lm_cfg["train"].update(total_steps=LM_STEPS, eval_every=LM_STEPS, fused_xent=True)
    try:
        with Phase("lm_data") as ph:
            lm_data = WikiText(**lm_cfg["dataset"])
            lm_train, lm_test = lm_data.split("train"), lm_data.split("test")
            lm_cfg = derive_runtime_fields(lm_cfg, lm_data.l_max, len(lm_train[0]))
            if lm_cfg["train"]["train_size"] != WIKITEXT_LRU_SHORT["train"]["train_size"]:
                raise AssertionError("the synthetic stream is not the config's")
            ph.fields.update(train_blocks=len(lm_train[0]), test_blocks=len(lm_test[0]),
                             block=lm_L, vocab=lm_data.d_output)

        for k in LAUNCHES:
            LAUNCHES[k] = 0
        with Phase("lm_train") as ph:
            t0 = time.perf_counter()
            lm_result = train(lm_cfg, lm_train, lm_test, device=dev)
            torch.cuda.synchronize()
            lm_train_s = time.perf_counter() - t0
            path3 = dict(LAUNCHES)
            n_eval_batches = len(lm_result.history) * (len(lm_test[0]) // lm_bsz)
            # the fused kernels once per step each and never in the eval
            # (dense head); the scans once per layer per step and eval batch
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(diag_scan=lm_layers * (LM_STEPS + n_eval_batches),
                        diag_scan_bwd=lm_layers * LM_STEPS, fused_xent_fwd=LM_STEPS,
                        fused_xent_dh=LM_STEPS, fused_xent_dw=LM_STEPS)
            if path3 != want:
                raise AssertionError(f"LM training launches {path3}, expected {want}")
            for rec in lm_result.history:
                if not all(np.isfinite(v) for v in rec.values()) or rec["test_perf"] < 1.0:
                    raise AssertionError(f"LM training numbers {rec}")
            ph.fields.update(steps=LM_STEPS, seconds=f"{lm_train_s:.2f}",
                             eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in lm_result.history]),
                             launches=repr(path3))

        with Phase("lm_checkpoint_eval_eig_serving") as ph:
            ckpt_path, perf = lm_result
            eig_dir = os.path.join(lm_tmp, "analysis")
            eig, eig_init, perc, _, _, _ = eval_eig(lm_cfg, {"save_path": eig_dir}, perf,
                                                    ckpt_path, device=dev)
            live = extract_ssm_family(ssm_layer_params(
                {k: v.cpu() for k, v in lm_result.model.state_dict().items()}), lm_m)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            if eig.shape != (lm_m["state_dim"], lm_layers) or not np.array_equal(eig, live):
                raise AssertionError("LM spectra from the checkpoint differ from the live weights")
            if files != want_files or not run_dir.startswith("WikiText"):
                raise AssertionError(f"LM artifacts {run_dir}: {files}")
            dec = Decoder(lm_m, lm_result.eval_model)
            prompts = torch.as_tensor(lm_test[0][:8, : lm_L - n_new], device=dev)
            out = dec.generate(prompts, n_new)
            _, last = dec.prefill(prompts)
            with torch.no_grad():
                full_prompt = lm_result.eval_model(prompts)[:, -1]
            torch.cuda.synchronize()
            if out.shape != (8, lm_L) or int(out.min()) < 0 or int(out.max()) >= lm_m["output_dim"]:
                raise AssertionError("generation from the trained LM failed")
            if not torch.allclose(last, full_prompt, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
                raise AssertionError(
                    f"LM prefill vs forward: {(last - full_prompt).abs().max().item()}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perplexity=f"{perf:.2f}",
                             artifacts=run_dir, n_files=len(files),
                             radius_pct_layer0=np.round(perc[:, 0], 1).tolist(),
                             prefill_vs_forward_max_abs=f"{(last - full_prompt).abs().max().item():.3e}")
        path3_all = dict(LAUNCHES)
        print(f"[launches] LM training: {path3}; with eval_eig, serving: {path3_all}", flush=True)
    finally:
        shutil.rmtree(lm_tmp, ignore_errors=True)

    # 12. one fused-head LM step against one dense-head step, on the card,
    # from the same weights (dropout 0) and batch
    with Phase("lm_fused_vs_dense_step") as ph:
        lm_x = torch.as_tensor(lm_train[0][:lm_bsz], device=dev)
        lm_y = torch.as_tensor(lm_train[1][:lm_bsz], device=dev)
        lt = lm_cfg["train"]
        lm_lrs = {"regular": lt["lr"], "ssm": lt["ssm_lr"]}

        def lm_step(fused):
            m, _, _ = build_models(lm_m, generator=torch.Generator().manual_seed(lm_cfg["seed"]),
                                   device=dev)
            opt = make_optimizer(m, lm_m["ssm_lr_vars"], lt["lr"], lt["ssm_lr"], lt["wd"],
                                 tuple(lt["betas"]))
            feats = []  # the backbone's features, then their gradient

            def keep(mod, inp, out):
                feats.append(out.detach())
                out.register_hook(feats.append)

            hook = m.encoder.register_forward_hook(keep)
            loss = train_step(m, opt, lm_x, lm_y, lm_lrs, fused_head=fused)
            hook.remove()
            grads = {n: p.grad for n, p in m.named_parameters()}
            return float(loss), feats[0], feats[1], grads, [b.clone() for b in m.buffers()]

        f_loss, feats, f_df, f_g, f_stats = lm_step(True)
        d_loss, _, d_df, d_g, d_stats = lm_step(False)
        # the same weights on the CPU: their decoder gives the head's term
        # sums, and the dense step in float64 is the reference
        ref_m, _, _ = build_models(lm_m, generator=torch.Generator().manual_seed(lm_cfg["seed"]),
                                   device="cpu")
        rows = feats.reshape(-1, feats.shape[-1])
        w_lm = ref_m.decoder.weight.detach().to(dev).t()
        b_lm = ref_m.decoder.bias.detach().to(dev)
        labels = lm_y.reshape(-1)
        _, lse = fx.fused_xent_fwd_plain(rows, w_lm, b_lm, labels)
        gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=dev)
        s_dh, s_dw, s_db = fx.grad_term_scales(rows, w_lm, b_lm, labels, lse, gscale)
        rtol = xent_grad_rtol(rows, w_lm, b_lm)
        head = {"features": ((f_df - d_df).reshape(-1, rows.shape[1]).abs(), s_dh),
                "decoder.weight": ((f_g["decoder.weight"] - d_g["decoder.weight"]).abs(), s_dw.t()),
                "decoder.bias": ((f_g["decoder.bias"] - d_g["decoder.bias"]).abs(), s_db)}
        head_ratio = max((err / (rtol * sc + 1e-30)).max().item() for err, sc in head.values())
        del rows, w_lm, b_lm, lse, s_dh, s_dw, s_db, head
        t0 = time.perf_counter()
        ref_m = ref_m.double()
        ref_loss = cross_entropy_loss(ref_m(lm_x.cpu()), lm_y.cpu())
        ref_loss.backward()
        f64_s = time.perf_counter() - t0
        g_ratio, g_leaf = 0.0, ""
        for n, p in ref_m.named_parameters():
            g64 = p.grad
            e_fused = (f_g[n].cpu().double() - g64).abs().max().item()
            e_dense = (d_g[n].cpu().double() - g64).abs().max().item()
            allowed = max(GRAD_F64_FACTOR * e_dense, 1e-5 * g64.abs().max().item())
            if e_fused / allowed > g_ratio:
                g_ratio, g_leaf = e_fused / allowed, n
        loss64_rel = abs(f_loss - ref_loss.item()) / abs(ref_loss.item())
        del ref_m, ref_loss
        s_worst = max(((a - c).abs() / c.abs().clamp_min(1.0)).max().item()
                      for a, c in zip(f_stats, d_stats))
        loss_rel = abs(f_loss - d_loss) / abs(d_loss)
        ph.fields.update(loss_fused=f"{f_loss:.6f}", loss_dense=f"{d_loss:.6f}",
                         loss_rel=f"{loss_rel:.2e}",
                         head_grads_err_over_tol=f"{head_ratio:.3f}(rtol_of_term_sums={rtol:.2e})",
                         loss_vs_f64_rel=f"{loss64_rel:.2e}", f64_cpu_step_s=f"{f64_s:.1f}",
                         grads_vs_f64_err_over_allowed=f"{g_ratio:.3f}({g_leaf})",
                         batch_stats_worst_rel=f"{s_worst:.2e}")
        if not (loss_rel <= XENT_RTOL and loss64_rel <= XENT_RTOL and head_ratio <= 1.0
                and g_ratio <= 1.0 and s_worst <= STATS_RTOL):
            raise AssertionError(f"fused vs dense LM step: {ph.fields}")
        del f_g, d_g, feats, f_df, d_df
        torch.cuda.empty_cache()

    # 13. an LM training step's time and the fused head's share of it
    with Phase("lm_train_step_timing") as ph:
        lm_opt = make_optimizer(lm_result.model, lm_m["ssm_lr_vars"], lt["lr"], lt["ssm_lr"],
                                lt["wd"], tuple(lt["betas"]))
        ph.fields.update(step_profile(
            lambda: train_step(lm_result.model, lm_opt, lm_x, lm_y, lm_lrs, fused_head=True),
            lm_bsz * lm_L, "xent", "fused_head", n_warm=2, n_timed=5))
    del lm_opt, lm_result, lm_x, lm_y
    torch.cuda.empty_cache()

    # main path 4, the MQAR Mamba-2: its forward on the test batch, then 200
    # training steps, the checkpoint reloaded and eigen-analysed; every count
    # set to 0 before the forward, read after training and again after the
    # eigen-analysis
    mam = MQAR_MAMBA2_FULL
    mm = mam["model"]
    m_layers = mm["num_layers"]
    _, mamba, _ = build_models(mm, generator=torch.Generator().manual_seed(mam["seed"]), device=dev)
    # the same dataset as the LRU's (L 512, 64 pairs): the same test split
    m_inputs, m_labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mm["input_dim"],
                                    lang_model=True, device=dev)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with Phase("mamba_forward") as ph, torch.no_grad():
        m_logits = mamba(m_inputs)
        torch.cuda.synchronize()
        if LAUNCHES["decay_attention_fwd"] != m_layers:
            raise AssertionError(f"the Mamba-2 forward launched decay_attention_fwd "
                                 f"{LAUNCHES['decay_attention_fwd']} times, expected {m_layers}")
        if m_logits.shape != (bsz, L, mm["output_dim"]) or not torch.isfinite(m_logits).all():
            raise AssertionError(f"Mamba-2 forward output {tuple(m_logits.shape)}")
        m_acc = float(masked_accuracy(m_logits, m_labels))
        m_fwd_ms = min(cuda_ms(lambda: mamba(m_inputs), 3))
        m_top = top_device_ops(lambda: mamba(m_inputs))
        _, cpu_mamba, _ = build_models(mm, generator=torch.Generator(), device="cpu")
        cpu_mamba.load_state_dict({k: v.cpu() for k, v in mamba.state_dict().items()})
        ref = cpu_mamba(m_inputs[:2].cpu())
        m_cpu_err = (m_logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(m_logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"Mamba-2 card vs CPU forward: max abs err {m_cpu_err}")
        ph.fields.update(chunk=_auto_chunk(bsz, L, mm["num_heads"], dev),
                         chunk_on_cpu=_auto_chunk(bsz, L, mm["num_heads"], "cpu"),
                         masked_acc=f"{m_acc:.6f}", forward_ms=f"{m_fwd_ms:.3f}",
                         decay_attention_fwd_launches_per_forward=m_layers,
                         vs_cpu_max_abs=f"{m_cpu_err:.3e}", top_device_ops_ms=repr(short(m_top)))
        del cpu_mamba, ref

    mcfg4 = copy.deepcopy(mam)
    m_tmp = tempfile.mkdtemp(prefix="tlie_mamba_")
    mcfg4["save"] = os.path.join(m_tmp, "checkpoint", "mqar-mamba2")
    mcfg4["train"].update(total_steps=MAMBA_STEPS, eval_every=MAMBA_EVAL_EVERY)
    mcfg4["dataset"]["num_train_examples"] = TRAIN_EXAMPLES
    mcfg4 = derive_runtime_fields(mcfg4, L, len(train_split[0]))
    try:
        with Phase("mamba_train") as ph:
            fwd_before = LAUNCHES["decay_attention_fwd"]
            t0 = time.perf_counter()
            m_result = train(mcfg4, train_split, test_split, device=dev)
            torch.cuda.synchronize()
            m_train_s = time.perf_counter() - t0
            path4 = dict(LAUNCHES)
            n_eval_batches = len(m_result.history) * (len(test_split[0]) // bsz)
            # one forward launch per layer per step and eval batch, one of each
            # backward per layer per step; no other kernel
            want = dict.fromkeys(LAUNCHES, 0)
            want.update(decay_attention_fwd=fwd_before + m_layers * (MAMBA_STEPS + n_eval_batches),
                        decay_attention_bwd_i=m_layers * MAMBA_STEPS,
                        decay_attention_bwd_j=m_layers * MAMBA_STEPS)
            if path4 != want:
                raise AssertionError(f"Mamba-2 training launches {path4}, expected {want}")
            for rec in m_result.history:
                if not all(np.isfinite(v) for v in rec.values()):
                    raise AssertionError(f"non-finite Mamba-2 training numbers {rec}")
            m_trained = m_result.model.state_dict()
            m_init = build_models(mm, generator=torch.Generator().manual_seed(mam["seed"]),
                                  device=dev)[0].state_dict()
            frozen = [k for k, v in m_trained.items() if torch.equal(v, m_init[k])]
            if frozen:
                raise AssertionError(f"Mamba-2 parameters that did not move: {frozen}")
            ph.fields.update(steps=MAMBA_STEPS, seconds=f"{m_train_s:.2f}",
                             eval_batches=n_eval_batches,
                             history=repr([{k: round(v, 4) for k, v in r.items()}
                                           for r in m_result.history]),
                             launches=repr(path4))

        with Phase("mamba_checkpoint_eval_eig") as ph:
            ckpt_path, perf = m_result
            ckpt = restore_checkpoint(ckpt_path)
            for k, v in m_trained.items():
                if not torch.equal(ckpt["model"][k], v.cpu()):
                    raise AssertionError(f"Mamba-2 checkpoint entry {k} differs from the live "
                                         "weights")
            eig_dir = os.path.join(m_tmp, "analysis")
            batch = test_x[:bsz]  # the analysis config's batch_size: the first 64 test examples
            eig, eig_init, perc, perc_init, _, _ = eval_eig(mcfg4, {"save_path": eig_dir}, perf,
                                                            ckpt_path, device=dev, batch=batch)
            live = extract_attention_family(m_result.eval_model, m_inputs, mm)
            (run_dir,) = os.listdir(eig_dir)
            files = sorted(os.listdir(os.path.join(eig_dir, run_dir)))
            saved = np.load(os.path.join(eig_dir, run_dir, "eig.npy"))
            want_shape = (bsz, L, mm["num_heads"], m_layers)
            if eig.shape != want_shape or eig_init.shape != want_shape:
                raise AssertionError(f"Mamba-2 spectra {eig.shape}, {eig_init.shape}")
            if not (np.array_equal(saved, eig) and np.abs(eig - live).max() <= 1e-6):
                raise AssertionError("Mamba-2 spectra from the checkpoint differ from the live "
                                     "model's")
            if not (np.all((eig_init > 0) & (eig_init <= 1)) and np.all((eig > 0) & (eig <= 1))):
                raise AssertionError("Mamba-2 eigenvalues outside (0, 1]")
            if files != want_files or not run_dir.startswith(f"MQARdmodel{mm['hidden_dim']}"):
                raise AssertionError(f"Mamba-2 artifacts {run_dir}: {files}")
            ph.fields.update(checkpoint=os.path.basename(ckpt_path), perf=f"{perf:.4f}",
                             artifacts=run_dir, n_files=len(files),
                             eig_vs_live_max_abs=f"{np.abs(eig - live).max():.3e}",
                             radius_pct_mean_layer0=np.round(perc[:, :, 0, 0].mean(1), 2).tolist(),
                             radius_pct_init_mean_layer0=np.round(
                                 perc_init[:, :, 0, 0].mean(1), 2).tolist())
        path4_all = dict(LAUNCHES)
        print(f"[launches] Mamba-2 forward and training: {path4}; with eval_eig: {path4_all}",
              flush=True)
    finally:
        shutil.rmtree(m_tmp, ignore_errors=True)

    # one Mamba-2 step (sparse head, AdamW behind the global-norm clip) from
    # the same weights and batch, on the card (kernels) and on the CPU (plain
    # versions), both held to the same step in float64 on the CPU
    m_f = train_fields(mcfg4)
    m_sparse_k = sparse_head_k_for(mm, train_split[1], test_split[1])
    m_lrs = {"regular": m_f["lr"]}

    def m_fresh(device):
        m, _, family = build_models(mm, generator=torch.Generator().manual_seed(mam["seed"]),
                                    device=device)
        opt, clip = make_family_optimizer(m, family, mm, mcfg4["train"], m_f)
        return m, opt, clip

    with Phase("mamba_train_step_card_vs_cpu") as ph:
        # dt_bias and A_log: the leaves that sum dcs = dcs_i + dcs_j over
        # every position
        card_m, card_opt, clip = step_card_vs_cpu(
            ph, "Mamba-2", m_fresh, dev, x_step, y_step, m_lrs, m_sparse_k,
            MAMBA_GRAD_RTOL_OF_MAX,
            watch=("dt_bias_a_log_grad_err_over_allowed",
                   lambda n: n.endswith(("dt_bias", "A_log"))))

    # a Mamba-2 training step's time and where it goes
    with Phase("mamba_train_step_timing") as ph:
        ph.fields.update(step_profile(
            lambda: train_step(card_m, card_opt, x_step, y_step, m_lrs, m_sparse_k,
                               clip_norm=clip),
            bsz * L, "decay_attention", "decay_attention"))
        del card_m, card_opt

    # the decay attention's kernels at the MQAR Mamba-2 shape and, for the
    # record, the WikiText Mamba-2 shape: time, bound, plain version and the
    # einsum form
    with Phase("decay_attention_timing") as ph:
        decay_times = time_decay_attention(dattn, *decay_io, flush)
        for name, t in decay_times.items():
            ph.fields[name] = timing_fields(t, "einsum_autograd_ms", "over_einsum")
        del decay_io
        wt_name = "wikitext_bg8_q1024_n512_hg8_p64"
        wt = decay_inputs(dev, gen, *SSD_SHAPES[wt_name])
        for name, t in time_decay_attention(dattn, *wt, flush).items():
            ph.fields[f"{name}_{wt_name}"] = timing_fields(t, "einsum_autograd_ms", "over_einsum")
        del wt
        torch.cuda.empty_cache()

    # the bfloat16 kernels at the WikiText Mamba-2 shape (path 9's, the one
    # the kernel line reports) and the MQAR shape: time, bound (the bfloat16
    # tensor-core rate), plain version and the bfloat16 einsum form
    with Phase("decay_attention_bf16_timing") as ph:
        for shape in ("wikitext_bg8_q1024_n512_hg8_p64", "mqar_bg64_q512_n128_hg1_p128"):
            ins = decay_inputs(dev, gen, *SSD_BF16_SHAPES[shape], dtype=torch.bfloat16)
            times = time_decay_attention(dattn, *ins, flush)
            for name, t in times.items():
                ph.fields[f"{name}_{shape}"] = timing_fields(t, "einsum_autograd_ms",
                                                             "over_einsum")
            if shape.startswith("wikitext"):
                decay_bf16_times = times
            del ins
        torch.cuda.empty_cache()

    # main path 5, the MQAR softmax transformer through the flash kernels
    path5_all, attn_times, attn_errs = transformer_path(dev, gen, flush, test_x, test_y,
                                                        train_split, want_files)

    # main paths 6 and 7, the MQAR linear and norm attention transformers:
    # no port kernel on either
    path6_all = attention_family_path(dev, test_x, test_y, train_split, want_files,
                                      MQAR_LIN_ATTENTION_FULL, "lin", LIN_STEPS, LIN_EVAL_EVERY)
    path7_all = attention_family_path(dev, test_x, test_y, train_split, want_files,
                                      MQAR_NORM_ATTENTION_CONV_FULL, "norm", NORM_STEPS,
                                      NORM_EVAL_EVERY)

    # main paths 8 and 9, the WikiText Mamba-2 LM in float32 and in bfloat16
    # (the decay attention's float32 and bfloat16 kernels), and 10, the
    # stacked seed sweep of the MQAR linear attention (no port kernel)
    wt_splits = wikitext_splits()
    path8_all = wikitext_mamba2_path(dev, wt_splits, "wikitext-mamba2-short.yaml", "wt_mamba2",
                                     want_files)
    path9_all = wikitext_mamba2_path(dev, wt_splits, "wikitext-mamba2-short-bf16.yaml",
                                     "wt_mamba2_bf16", want_files)
    del wt_splits
    path10_all = sweep_path(dev, test_x, test_y, train_split, want_files)

    def late(name):
        return (path6_all[name] + path7_all[name] + path8_all[name] + path9_all[name]
                + path10_all[name])

    kernels = [{
        "name": "diag_scan",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:107",
        "launches": (path1["diag_scan"] + path2_all["diag_scan"] + path3_all["diag_scan"]
                     + late("diag_scan")),
        "max_abs_err": err,
        "ms": scan_times[""][0],
        "plain_ms": scan_times[""][2],
        "bound_ms": scan_times[""][3],
        "bound_by": scan_times[""][4],
        "library_ms": None,  # no single PyTorch call computes a diagonal linear recurrence
    }, {
        "name": "diag_scan_bwd",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan_bwd.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:192",
        "launches": (path1["diag_scan_bwd"] + path2_all["diag_scan_bwd"]
                     + path3_all["diag_scan_bwd"] + late("diag_scan_bwd")),
        "max_abs_err": max(d_e, da_e),
        "ms": bwd_times[""][0],
        "plain_ms": bwd_times[""][2],
        "bound_ms": bwd_times[""][3],
        "bound_by": bwd_times[""][4],
        "library_ms": None,  # no single PyTorch call computes the recurrence's gradient
    }]
    replaces = {"fused_xent_fwd": "tlie_tpu/ops/fused_xent.py:126",
                "fused_xent_dh": "tlie_tpu/ops/fused_xent.py:228",
                "fused_xent_dw": "tlie_tpu/ops/fused_xent.py:246"}
    for name, (k_ms, _, p_ms, l_ms, bound, by, _, _, _) in xent_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/fused_xent.cu",
            "replaces": replaces[name],
            "launches": path3_all[name] + late(name),
            "max_abs_err": xent_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": l_ms,  # addmm + F.cross_entropy, autograd for the gradients
        })
    replaces = {"decay_attention_fwd": "tlie_tpu/ops/pallas_ssd.py:252",
                "decay_attention_bwd_i": "tlie_tpu/ops/pallas_ssd.py:272",
                "decay_attention_bwd_j": "tlie_tpu/ops/pallas_ssd.py:293"}
    for name, (k_ms, _, p_ms, _, bound, by, _, _, _) in decay_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/decay_attention.cu",
            "replaces": replaces[name],
            "launches": path4_all[name] + late(name),
            "max_abs_err": decay_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,  # no single PyTorch call computes the decay attention
        })
    replaces = {"decay_attention_fwd_bf16": "tlie_tpu/ops/pallas_ssd.py:252",
                "decay_attention_bwd_i_bf16": "tlie_tpu/ops/pallas_ssd.py:272",
                "decay_attention_bwd_j_bf16": "tlie_tpu/ops/pallas_ssd.py:293"}
    for name, (k_ms, _, p_ms, e_ms, bound, by, _, _, _) in decay_bf16_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/decay_attention.cu",
            "replaces": replaces[name],
            "launches": path4_all[name] + late(name),
            "max_abs_err": decay_bf16_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            # the einsum form is several cuBLAS calls and elementwise passes,
            # not one library call: reported in the timing phase, not here
            "library_ms": None,
        })
    replaces = {"flash_attention_fwd": "tlie_tpu/ops/attention.py:49",
                "flash_attention_bwd_dkv": "tlie_tpu/ops/attention.py:49",
                "flash_attention_bwd_dq": "tlie_tpu/ops/attention.py:49"}
    for name, (k_ms, _, p_ms, l_ms, bound, by, _, _, _) in attn_times.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tlie_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[name],
            "launches": path5_all[name] + late(name),
            "max_abs_err": attn_errs[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": l_ms,  # F.scaled_dot_product_attention, autograd for the gradients
        })
    print(f"[total] {time.perf_counter() - T_START:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
