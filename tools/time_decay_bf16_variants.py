#!/usr/bin/env python3
"""Where the decay attention's bfloat16 kernels spend their time, on the
card: the forward, bwd_i and bwd_j timed as they are and with parts of their
work cut.

    python3 tools/time_decay_bf16_variants.py [--csrc DIR] [--source NAME]

It reads ``NAME`` (default ``decay_attention_bf16.cu``) from ``DIR``
(default the port's ``tlie_tpu_torch/ops/csrc``; point it at the ``csrc``
of a tree unpacked with ``git archive`` to measure that tree's kernels:
``--source decay_attention.cu`` takes the bfloat16 kernels of a tree from
before ``decay_attention_bf16.cu`` held them: the forward and bwd_j of a
tree before it existed, bwd_i of one before bwd_i moved there, when
``decay_attention.cu`` instantiated its templates on bfloat16), writes one
copy of it per variant with the edits of ``VARIANTS`` applied (each edit
must match the source exactly once, or the script fails), builds each copy
with ``nvcc`` beside the port's own kernel builds (``tlie_tpu_torch/_build/
variants/``, in parallel) and times ``tlie_decay_attention_fwd_bf16``,
``tlie_decay_attention_bwd_i_bf16`` and ``tlie_decay_attention_bwd_j_bf16``
of each (those the copy exports) at the WikiText Mamba-2 shape
(BG 8, Q 1024, N 512, Hg 8, P 64): L2-cold and warm medians of 21
launches, as ``chip_smoke.py`` times every kernel.  The variants:

* ``as_is``: the source unchanged;
* ``resident``: no tile is loaded from device memory (the copies into
  shared memory return at once), so the products and the epilogue run on
  whatever the shared tiles hold: what the walk costs without its loads;
* ``no_epilogue``: the CUDA-core epilogue cut (the exps of the decay; in
  bwd_j and bwd_i also Dh, the sum over heads of dS·decay and dcs, in
  bwd_j S^T), the products kept (they are ``asm volatile``, so the
  compiler keeps them);
* ``products``: both cuts;
* for ``decay_attention_bf16.cu`` also ``fwd_one_slab`` (the forward with
  four chunks a warp, all eight heads in one block), ``bwd_j_four_blocks``
  (bwd_j with two parts a warp, four blocks a j-tile pair) and
  ``bwd_i_one_block`` (bwd_i with four parts a warp, all of N in one block
  an i-tile pair, where the entry splits N over two blocks that each form
  every head's dS): the splits the entries do not choose at this shape.

The timed outputs of the cut variants are meaningless; the others are
held to the plain version (the largest error is printed).  Prints one
line per variant, the ptxas lines of each build and the card's name and
power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# Exact edits of each source, by file name: (text, replacement).
_LOADS_FLOAT = (
    "                                          const __nv_bfloat16*, int tid, int n) {\n"
    "  if (vec) {",
    "                                          const __nv_bfloat16*, int tid, int n) {\n"
    "  if (true) return;\n  if (vec) {")
_EPILOGUE_FLOAT = [
    ("round_as<T>(s[0][n][2 * hh + e] * expf(ci - cs_j[hf * kT + lj]))",
     "round_as<T>(s[0][n][2 * hh + e])"),
    ("round_as<T>(f[0][n][2 * hh + e] * expf(ch[kT + li] - cj))",
     "round_as<T>(f[0][n][2 * hh + e])"),
    ("if (a_step && p0 + kW >= d.P) {  // head h's dS^T is whole",
     "if (false) {  // head h's dS^T is whole"),
    ("if (a_step && p0 + kW >= d.P) {  // head h's dS is whole",
     "if (false) {  // head h's dS is whole"),
]
_LOADS_BF16 = [
    ("                                          const bf16* safe) {\n  if constexpr (kVec) {",
     "                                          const bf16* safe) {\n"
     "  if (true) return;\n  if constexpr (kVec) {"),
]
_EPILOGUE_BF16 = [
    ("__device__ __forceinline__ float decay_exp(float d) { return expf(d); }",
     "__device__ __forceinline__ float decay_exp(float d) { return 1.f; }"),
    ("        for (int hh = 0; hh < 2; ++hh) {\n          const int lj = r0 + g + 8 * hh;\n"
     "          const int lo",
     "        for (int hh = 0; hh < 0; ++hh) {\n          const int lj = r0 + g + 8 * hh;\n"
     "          const int lo"),
    ("        for (int hh = 0; hh < 2; ++hh) {\n          const int li = r0 + g + 8 * hh;\n"
     "          const float ci = csi[li];",
     "        for (int hh = 0; hh < 0; ++hh) {\n          const int li = r0 + g + 8 * hh;\n"
     "          const float ci = csi[li];"),
]
VARIANTS = {
    "decay_attention.cu": {
        "as_is": [],
        "resident": [_LOADS_FLOAT],
        "no_epilogue": _EPILOGUE_FLOAT,
        "products": [_LOADS_FLOAT] + _EPILOGUE_FLOAT,
    },
    "decay_attention_bf16.cu": {
        "as_is": [],
        "resident": _LOADS_BF16,
        "no_epilogue": _EPILOGUE_BF16,
        "products": _LOADS_BF16 + _EPILOGUE_BF16,
        # the other splits the entries could choose at this shape
        "fwd_one_slab": [("               : launch_fwd<2, true>(C, B, cs, x, y, d, BG, s);",
                          "               : launch_fwd<4, true>(C, B, cs, x, y, d, BG, s);")],
        "bwd_j_four_blocks": [("  const bool two = (N <= 2 * kT && Hg * parts(P) <= 2) ||",
                               "  const bool two = true ||")],
        "bwd_i_one_block": [(
            "               : launch_bwd_i<2, true>(C, B, cs, x, dy, dC, dcs_i, d, BG, s);",
            "               : launch_bwd_i<4, true>(C, B, cs, x, dy, dC, dcs_i, d, BG, s);")],
    },
}
SHAPE = (8, 1024, 512, 8, 64)  # BG, Q, N, Hg, P: the WikiText Mamba-2's
_P, _I = ctypes.c_void_p, ctypes.c_int64
ARGS = {"fwd": (_P,) * 5 + (_I,) * 9 + (_P,), "bwd_i": (_P,) * 7 + (_I,) * 9 + (_P,),
        "bwd_j": (_P,) * 8 + (_I,) * 9 + (_P,)}


def patched(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"edit does not match exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(csrc: Path, source: str, variant: str, text: str):
    """nvcc the variant's text into a library; returns (path, ptxas lines)."""
    from tlie_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    src = out_dir / f"{Path(source).stem}-{variant}-{tag}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {variant}:\n{proc.stdout}{proc.stderr}")
    regs = [ln.split(":", 1)[1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln]
    return lib, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=str(ROOT / "tlie_tpu_torch" / "ops" / "csrc"))
    ap.add_argument("--source", default="decay_attention_bf16.cu", choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tlie_tpu_torch.ops import decay_attention as da

    csrc = Path(args.csrc).resolve()
    text = (csrc / args.source).read_text()
    variants = VARIANTS[args.source]
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda kv: build(csrc, args.source, kv[0], patched(text, kv[1])),
            variants.items())))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    C, B, cs_, x, dy = cs.decay_inputs(dev, gen, *SHAPE, dtype=torch.bfloat16)
    BG, Q, N, Hg, P = SHAPE
    dims = (BG, Q, N, Hg, P, C.stride(0), C.stride(1), B.stride(0), B.stride(1))
    flush = torch.empty(64 * 2**20, device=dev)
    y, dB, dx = torch.empty_like(x), torch.empty_like(B), torch.empty_like(x)
    dC, dcs, dcs_i = torch.empty_like(B), torch.empty_like(cs_), torch.empty_like(cs_)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"csrc={csrc} source={args.source} shape={SHAPE}", flush=True)
    for variant, (lib_path, regs) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        fns = {}
        for k, argtypes in ARGS.items():
            fn = getattr(lib, f"tlie_decay_attention_{k}_bf16", None)
            if fn is not None:  # a copy exports those of the three it holds
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                fns[k] = fn

        def fwd():
            da.check(fns["fwd"](C.data_ptr(), B.data_ptr(), cs_.data_ptr(), x.data_ptr(),
                                y.data_ptr(), *dims, stream), variant)

        def bwd_i():
            da.check(fns["bwd_i"](C.data_ptr(), B.data_ptr(), cs_.data_ptr(), x.data_ptr(),
                                  dy.data_ptr(), dC.data_ptr(), dcs_i.data_ptr(), *dims,
                                  stream), variant)

        def bwd_j():
            da.check(fns["bwd_j"](C.data_ptr(), B.data_ptr(), cs_.data_ptr(), x.data_ptr(),
                                  dy.data_ptr(), dB.data_ptr(), dx.data_ptr(), dcs.data_ptr(),
                                  *dims, stream), variant)

        runs = {k: f for k, f in (("fwd", fwd), ("bwd_i", bwd_i), ("bwd_j", bwd_j)) if k in fns}
        fields = {}
        for name, fn in runs.items():
            cold = cs.median(cs.cuda_ms(fn, 21, flush))
            warm = cs.median(cs.cuda_ms(fn, 21))
            fields[name] = f"cold={cold:.5f},warm={warm:.5f}"
        if variant not in ("resident", "no_epilogue", "products"):
            for fn in runs.values():
                fn()
            torch.cuda.synchronize()
            pairs = []
            if "fwd" in runs:
                pairs.append(("y", y, da.decay_attention_plain(C, B, cs_, x)))
            if "bwd_i" in runs:
                pairs += zip(("dC", "dcs_i"), (dC, dcs_i),
                             da.decay_attention_bwd_i_plain(C, B, cs_, x, dy))
            if "bwd_j" in runs:
                pairs += zip(("dB", "dxdt", "dcs_j"), (dB, dx, dcs),
                             da.decay_attention_bwd_j_plain(C, B, cs_, x, dy))
            fields["max_abs_err"] = ",".join(
                f"{n}={(a.float() - b.float()).abs().max().item():.3e}" for n, a, b in pairs)
        print(f"[variant] {variant}: " + " ".join(f"{k}={v}" for k, v in fields.items())
              + f" ptxas={regs!r}", flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
