#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``tlie_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tlie_tpu_torch/ops/csrc`` with
``nvcc`` (into ``tlie_tpu_torch/_build/``), holds each kernel against its
plain PyTorch version on the card, then drives the full-width MQAR LRU
(``MQAR_LRU_FULL``: L=512, d_model=128, N=128, 2 layers, vocab 8192, random
weights from the config's seed) through evaluation, eigen-analysis and
serving, and shows from the launch counts that those paths went through the
kernels.  Each phase prints one line with its wall seconds; any failed check
raises and the exit code is non-zero.  The last three lines are the kernel
table as JSON, the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it fails and
prints no result.  It writes nothing inside the checkout except the kernel
build; the eigen-analysis artifacts go to a temporary directory that is
removed at the end.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

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
    ``fn``, from ``torch.profiler`` (empty when it sees no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((ev.self_device_time_total, ev.key) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    return [(name[:48], round(us / 1e3, 4)) for us, name in rows[:k]]


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a stride-0 broadcast counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def scan_err(h, ref):
    """(max abs error, max|ref|) over the planes of two scan results."""
    h = h if isinstance(h, tuple) else (h,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max((x - y).abs().max().item() for x, y in zip(h, ref))
    scale = max(y.abs().max().item() for y in ref)
    return err, scale


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    # imported after the card check: a copy of this script alone has no package
    from tlie_tpu_torch.analysis import eval_eig
    from tlie_tpu_torch.config import MQAR_LRU_FULL
    from tlie_tpu_torch.data import MQAR, masked_accuracy
    from tlie_tpu_torch.inference import Decoder
    from tlie_tpu_torch.models import build_models
    from tlie_tpu_torch.ops import LAUNCHES
    from tlie_tpu_torch.ops.scan import DIAG_SCAN, diag_scan_cuda, diag_scan_plain
    from tlie_tpu_torch.training import prep_batch

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

    # 2. the nvcc build
    with Phase("build") as ph:
        report = DIAG_SCAN.load()
        regs = [ln.strip() for ln in report.log.splitlines() if "registers" in ln]
        ph.fields.update(diag_scan_nvcc_s=f"{report.seconds:.2f}", ptxas=repr(regs))

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

    # the full-width model, its data and its weights
    cfg = MQAR_LRU_FULL
    mcfg = cfg["model"]
    model = build_models(mcfg, generator=torch.Generator().manual_seed(cfg["seed"]), device=dev)
    data = MQAR(**cfg["dataset"])
    test_x, test_y = data.split("test")
    bsz, L = cfg["train"]["batch_size"], mcfg["seq_len"]
    inputs, labels = prep_batch((test_x[:bsz], test_y[:bsz]), L, mcfg["input_dim"],
                                lang_model=True, device=dev)
    n_layers = mcfg["num_layers"]

    # main path: every count set to 0 here, read after serving
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
        cpu_model = build_models(mcfg, generator=torch.Generator(), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = cpu_model(inputs[:2].cpu())
        cpu_err = (logits[:2].cpu() - ref).abs().max().item()
        if not torch.allclose(logits[:2].cpu(), ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
            raise AssertionError(f"card vs CPU forward: max abs err {cpu_err}")
        ph.fields.update(masked_acc=f"{acc:.6f}", forward_ms=f"{fwd_ms:.3f}",
                         diag_scan_launches_per_forward=n_layers,
                         vs_cpu_max_abs=f"{cpu_err:.3e}",
                         top_device_ops_ms=repr(top_ops))

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
    n_new, n_check = 16, 8
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

    launches = dict(LAUNCHES)
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

    # 7. the kernel at the path's shape: time, bound, plain version
    with Phase("kernel_timing") as ph, torch.no_grad():
        seq = model.encoder.layers[0].seq
        x = model.encoder.encoder(inputs)
        lam, (bn_re, bn_im) = seq.lam(), seq.input_matrix()
        a = (lam[0].expand(L, seq.d_hidden), lam[1].expand(L, seq.d_hidden))
        b = (x @ bn_re.T, x @ bn_im.T)
        ref = diag_scan_plain(a, b)
        err, scale = scan_err(diag_scan_cuda(a, b), ref)
        if not err <= SCAN_RTOL_OF_MAX * scale:
            raise AssertionError(f"diag_scan at the path's inputs: {err}")
        flush = torch.empty(64 * 2**20, device=dev)  # 256 MB, over the 50 MB L2
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

    kernels = [{
        "name": "diag_scan",
        "route": "cuda",
        "source": "tlie_tpu_torch/ops/csrc/diag_scan.cu",
        "replaces": "tlie_tpu/ops/pallas_scan.py:107",
        "launches": launches["diag_scan"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a diagonal linear recurrence
    }]
    print(f"[total] {time.perf_counter() - T_START:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
