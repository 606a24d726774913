#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``tlie_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tlie_tpu_torch/ops/csrc`` with
``nvcc`` (into ``tlie_tpu_torch/_build/``, one ``nvcc`` per source, all at
once), holds each kernel against its plain PyTorch version on the card, and
drives the full-width MQAR LRU (``MQAR_LRU_FULL``: L=512, d_model=128,
N=128, 2 layers, vocab 8192, batch 64, weights from the config's seed)
along two paths, each with the launch counts set to 0 just before it and
read just after:

1. evaluation, eigen-analysis and serving of the random-weight model;
2. training through ``tlie_tpu_torch.training.train`` (200 steps, an eval
   every 100, on a train split cut to 8,192 examples), the checkpoint, and
   eval_eig and serving of the trained weights.

It then checks one training step on the card against the same step on the
CPU, and times each kernel against its bound and its plain version.  Each
phase prints one line with its wall seconds; any failed check raises and the
exit code is non-zero.  The last three lines are the kernel table as JSON,
the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it fails and
prints no result.  It writes nothing inside the checkout except the kernel
build; the checkpoint and the eigen-analysis artifacts go to a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import copy
import json
import math
import os
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
# device kernels of a training step by kind, from their names (first match)
OP_KINDS = (
    ("scan kernels", ("diag_scan", "sum_rows")),
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


def cuda_ms(fn, repeat: int, flush: torch.Tensor = None):
    """Per-call device times (ms) of ``fn`` from CUDA events, one call per
    pair of events.  Before each call the stream gets work of its own
    (``flush`` overwritten, which also leaves the L2 cache cold, or a short
    device sleep), so the host enqueues the call before the start event fires
    and the time is the device's, not the wrapper's host overhead."""
    times = []
    for _ in range(repeat):
        if flush is not None:
            flush.zero_()
        else:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    # imported after the card check: a copy of this script alone has no package
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
    from tlie_tpu_torch.config import MQAR_LRU_FULL, derive_runtime_fields
    from tlie_tpu_torch.data import MQAR, masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES, diag_linear_scan
    from tlie_tpu_torch.ops.scan import (
        DIAG_SCAN, DIAG_SCAN_BWD, diag_scan_bwd_cuda, diag_scan_bwd_plain, diag_scan_cuda,
        diag_scan_plain,
    )
    from tlie_tpu_torch.training import prep_batch, restore_checkpoint, train, train_step
    from tlie_tpu_torch.training.scan_loop import sparse_head_k_for
    from tlie_tpu_torch.training.state import make_optimizer
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
        libs = {"diag_scan": DIAG_SCAN, "diag_scan_bwd": DIAG_SCAN_BWD}
        with ThreadPoolExecutor(len(libs)) as pool:
            reports = dict(zip(libs, pool.map(lambda lib: lib.load(), libs.values())))
        for name, report in reports.items():
            regs = [ln.split(":", 1)[1].strip() for ln in report.log.splitlines()
                    if "registers" in ln]
            ph.fields[f"{name}_nvcc_s"] = f"{report.seconds:.2f}"
            ph.fields[f"{name}_ptxas"] = repr(regs)

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
        cases = {
            "complex_b64_l512_n128_bcast_a": (ring((512, 128)), normal_pair((64, 512, 128))),
            "real_b64_l512_n128_full_a": (ring((64, 512, 128))[0].abs(),
                                          torch.randn(64, 512, 128, device=dev, generator=gen)),
            "complex_b3_l997_n96_const_a": (ring((96,)), normal_pair((3, 997, 96))),
        }
        for name, (a, b) in cases.items():
            h = diag_scan_cuda(a, b)
            torch.cuda.synchronize()
            err, scale = scan_err(h, diag_scan_plain(a, b))
            tol = SCAN_RTOL_OF_MAX * scale
            ph.fields[name] = f"max_abs={err:.3e},rel_to_max={err / scale:.3e},tol={tol:.3e}"
            if not err <= tol:
                raise AssertionError(f"diag_scan {name}: max abs err {err} > {tol}")

    # the backward kernel against diag_scan_bwd_plain, and the forward
    # kernel's reverse mode against the plain reverse scan
    with Phase("bwd_kernel_vs_plain") as ph:
        cases = {
            "complex_b64_l512_n128_lambda": (ring((128,)), normal_pair((64, 512, 128))),
            "real_b8_l512_n128_full_a": (ring((8, 512, 128))[0].abs(),
                                         torch.randn(8, 512, 128, device=dev, generator=gen)),
            "complex_b3_l997_n96_lambda": (ring((96,)), normal_pair((3, 997, 96))),
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
                ph.fields[tag] = (f"h_rel={h_err / h_scale:.2e},d_abs={d_e:.2e}/tol={d_tol:.2e},"
                                  f"da_abs={da_e:.2e},da_err_over_tol={da_ratio:.3f}")
                if not (h_err <= SCAN_RTOL_OF_MAX * h_scale and d_e <= d_tol and da_ratio <= 1.0):
                    raise AssertionError(f"diag_scan_bwd {tag}: {ph.fields[tag]}")

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
            want = sorted([f"{k}.npy" for k in (
                "eig", "eig_init", "percentage", "percentage_init", "percentage_phase",
                "percentage_phase_init", "percentage_mean", "percentage_init_mean",
                "percentage_std", "percentage_init_std")] + ["percentage_file.txt"]
                + (["used_config.yaml"] if has_yaml else []))
            if files != want:
                raise AssertionError(f"artifact files {files} != {want}")
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
            train_split = MQAR(**tcfg["dataset"]).split("train")
            test_split = (test_x, test_y)
            tcfg = derive_runtime_fields(tcfg, L, len(train_split[0]))
            ph.fields.update(train_examples=f"{len(train_split[0])}(cut_from_100000)",
                             test_examples=len(test_split[0]))
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
            want = {"diag_scan": n_layers * (TRAIN_STEPS + n_eval_batches),
                    "diag_scan_bwd": n_layers * TRAIN_STEPS}
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

    # 11. the kernels at the path's shape: time, bound, plain version
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB, over the 50 MB L2
    with Phase("kernel_timing") as ph, torch.no_grad():
        lam, (bn_re, bn_im) = seq.lam(), seq.input_matrix()
        a = lam  # the (N,) pair the LRU passes
        b = (u @ bn_re.T, u @ bn_im.T)
        h = diag_scan_plain(a, b)
        err, scale = scan_err(diag_scan_cuda(a, b), h)
        if not err <= SCAN_RTOL_OF_MAX * scale:
            raise AssertionError(f"diag_scan at the path's inputs: {err}")
        cold = sorted(cuda_ms(lambda: diag_scan_cuda(a, b), 21, flush))
        warm = sorted(cuda_ms(lambda: diag_scan_cuda(a, b), 21))
        plain = min(cuda_ms(lambda: diag_scan_plain(a, b), 2))
        n_bytes = sum(distinct_bytes(t) for t in a + b) + sum(distinct_bytes(t) for t in b)
        flops = 8 * b[0].numel()  # complex multiply-add: 4 mul + 4 add per element
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        ms = cold[len(cold) // 2]
        ph.fields.update(ms_cold_median=f"{ms:.5f}", ms_warm_median=f"{warm[len(warm) // 2]:.5f}",
                         bound_ms=f"{bound_ms:.5f}", bytes=n_bytes, plain_ms=f"{plain:.3f}",
                         max_abs_err=f"{err:.3e}")

    with Phase("bwd_kernel_timing") as ph, torch.no_grad():
        g = (torch.randn(h[0].shape, device=dev, generator=gen),
             torch.randn(h[0].shape, device=dev, generator=gen))
        da, d = diag_scan_bwd_cuda(a, h, g)
        da_ref, d_ref = diag_scan_bwd_plain(a, h, g)
        d_e, d_tol, da_e, da_ratio = bwd_err(a, h, da, d, da_ref, d_ref, False)
        if not (d_e <= d_tol and da_ratio <= 1.0):
            raise AssertionError(f"diag_scan_bwd at the path's inputs: d {d_e}, da {da_ratio}")
        b_cold = sorted(cuda_ms(lambda: diag_scan_bwd_cuda(a, h, g), 21, flush))
        b_warm = sorted(cuda_ms(lambda: diag_scan_bwd_cuda(a, h, g), 21))
        b_plain = min(cuda_ms(lambda: diag_scan_bwd_plain(a, h, g), 2))
        # each input read once (a, h, g), each output written once (da, d)
        b_bytes = sum(distinct_bytes(t) for t in a + h + g + da + d)
        b_flops = 16 * g[0].numel()  # two complex multiply-adds per element
        b_bytes_ms = b_bytes / HBM_BYTES_PER_S * 1e3
        b_flops_ms = b_flops / FP32_FLOPS_PER_S * 1e3
        b_bound = max(b_bytes_ms, b_flops_ms)
        b_ms = b_cold[len(b_cold) // 2]
        ph.fields.update(ms_cold_median=f"{b_ms:.5f}",
                         ms_warm_median=f"{b_warm[len(b_warm) // 2]:.5f}",
                         bound_ms=f"{b_bound:.5f}", bytes=b_bytes, plain_ms=f"{b_plain:.3f}",
                         d_max_abs_err=f"{d_e:.3e}", da_max_abs_err=f"{da_e:.3e}")

    kernels = [{
        "name": "diag_scan",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:107",
        "launches": path1["diag_scan"] + path2_all["diag_scan"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a diagonal linear recurrence
    }, {
        "name": "diag_scan_bwd",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan_bwd.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:192",
        "launches": path1["diag_scan_bwd"] + path2_all["diag_scan_bwd"],
        "max_abs_err": max(d_e, da_e),
        "ms": b_ms,
        "plain_ms": b_plain,
        "bound_ms": b_bound,
        "bound_by": "bytes" if b_bytes_ms >= b_flops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the recurrence's gradient
    }]
    print(f"[total] {time.perf_counter() - T_START:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
