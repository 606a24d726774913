#!/usr/bin/env python3
"""Where the fused head's bfloat16 kernels spend their time, on the card: one
kernel (dh, the forward or dW/db) timed as it is and with parts of its work
cut.

    python3 tools/time_xent_bf16_variants.py [--kernel dh|fwd|dw] [--csrc DIR]
                                            [--variants as_is,...]

It reads ``fused_xent_bf16.cu`` from ``DIR`` (default the port's
``tlie_tpu_torch/ops/csrc``; point it at the ``csrc`` of a tree unpacked
with ``git archive`` to measure that tree's kernel), writes one copy of it
per variant of ``--kernel`` (default dw) with the edits of ``VARIANTS``
applied (each edit must match the source exactly once, or the script
fails; ``--variants`` picks some, ``as_is`` alone for a source the edits
were not written for), builds each copy with ``nvcc`` (``tlie_tpu_torch/_build/variants/``,
in parallel) and times the kernel's entry (``tlie_fused_xent_dh_bf16``,
``tlie_fused_xent_fwd_bf16`` with the wrapper's splits, or
``tlie_fused_xent_dw_bf16``) of each at the WikiText LM head's shape (M
8192, D 512, V 50257): L2-cold and warm medians of 11 launches, as
``chip_smoke.py`` times every kernel.  dh and dW/db run one walk
(``bwd_walk_bf16``) with the roles of h and W swapped, so their shared
variants cut the same lines and each times its own instantiation.  The
variants:

* ``as_is``: the source unchanged;
* ``resident``: no streamed tile is loaded (its boxes are not asked of the
  tensor memory accelerator), so the products run on whatever the slots
  hold: the walk without its loads;
* ``no_logits``: the logits' products cut (t, or the statistics, formed
  from zeros);
* ``no_second_product`` (dh, dW/db): bf16(t) times the streamed tile cut;
* ``no_t`` (dh, dW/db): p and t left at zero (no exp), the exchange kept;
* ``fast_exp``: the softmax's exp by ``__expf`` (the hardware's ex2),
  where the source takes ``expf``;
* ``no_p_exp`` (dh, dW/db): the exp cut from the softmax;
* ``no_exchange`` (dh, dW/db): the band's warps neither wait for each other
  nor read each other's logits (t formed from zeros past the warp's own);
* ``no_epilogue`` (the forward): the running (max, sum-exp, picked) update
  cut, the logits formed and dropped;
* ``one_box_sum`` (the forward): a tile's logits summed from its first box
  alone, the other boxes' products formed and dropped.

The timed outputs of the cut variants are meaningless; the others are held
to the plain version (the largest error and the bit-equal share are
printed).  Prints one line per variant, the ptxas lines of each build and
the card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from time_decay_bf16_variants import build, patched  # noqa: E402

SOURCE = "fused_xent_bf16.cu"
# edits of the walk that dh and dW/db share
_WALK = {
    "resident": [("      mbar_expect(&bars[sl], static_cast<uint32_t>(kHQ * Dpad * 2));\n"
                  "      for (int c = 0; c < Dpad / kBox; ++c)",
                  "      mbar_expect(&bars[sl], 0u);\n      for (int c = 0; c < 0; ++c)")],
    "no_logits": [("      for (int k0 = 0; k0 < Dpad; k0 += kBK) {\n        const bf16* wa",
                   "      for (int k0 = 0; k0 < 0; k0 += kBK) {\n        const bf16* wa")],
    "no_second_product": [("        if (kBox * j >= dcols || d0 + kBox * j >= Dpad) continue;",
                           "        if (true) continue;")],
    "no_exchange": [
        ("    asm volatile(\"bar.sync %0, %1;\\n\" ::\"r\"(1 + band), \"r\"(32 * PL::kSplit) "
         ": \"memory\");\n", ""),
        ("      const float4 f = xch[(owner * kQN + m % kQN) * 32 + lane];",
         "      const float4 f = make_float4(0.f * owner, 0.f, 0.f, 0.f);")],
}
_DH_EXP = "? expf(s[n][2 * hh + e] + bq - r_lse[hh])"
_DW_EXP = "? expf(s[n][2 * hh + e] + bias[hh] - l)"
VARIANTS = {
    "dh": {
        "as_is": [], **_WALK,
        "no_t": [("                                 ? expf(s[n][2 * hh + e] + bq - r_lse[hh])",
                  "                                 && false ? 0.f"),
                 ("            t[hh][e] = (pv[2 * hh + e] - (v == r_lab[hh] ? 1.f : 0.f)) * g_scale;",
                  "            t[hh][e] = 0.f;")],
        "fast_exp": [(_DH_EXP, _DH_EXP.replace("expf", "__expf"))],
        "no_p_exp": [(_DH_EXP, "? (s[n][2 * hh + e] + bq - r_lse[hh])")],
    },
    "dw": {
        "as_is": [], **_WALK,
        "no_t": [("            pv[2 * hh + e] = q_ok ? expf(",
                  "            pv[2 * hh + e] = false ? expf("),
                 ("            t[hh][e] = (pv[2 * hh + e] - (v32[hh] == lab ? 1.f : 0.f)) * g_scale;",
                  "            t[hh][e] = 0.f;")],
        "fast_exp": [(_DW_EXP, _DW_EXP.replace("expf", "__expf"))],
        "no_p_exp": [(_DW_EXP, "? (s[n][2 * hh + e] + bias[hh] - l)")],
    },
    "fwd": {
        "as_is": [],
        "resident": [("        mbar_expect(bar, static_cast<uint32_t>(kVT * Dpad * 2));\n"
                      "        for (int c = 0; c < n_box; ++c)",
                      "        mbar_expect(bar, 0u);\n        for (int c = 0; c < 0; ++c)")],
        "no_logits": [("    if (k >= n_box) continue;  // uniform over the block\n",
                       "    if (true) continue;\n")],
        "no_epilogue": [("    for (int hh = 0; hh < 2; ++hh) {\n      float tmax = kNegBig;",
                         "    for (int hh = 0; hh < 0; ++hh) {\n      float tmax = kNegBig;")],
        "fast_exp": [("add += expf(x[4 * j + 2 * hh + e] - mn);",
                      "add += __expf(x[4 * j + 2 * hh + e] - mn);")],
        "one_box_sum": [("    if (k >= n_box) continue;\n#pragma unroll\n    for (int r = 0; r < PL::kNF",
                         "    if (k >= 1) continue;\n#pragma unroll\n    for (int r = 0; r < PL::kNF")],
    },
}
SHAPE = (8192, 512, 50257)  # M, D, V: the WikiText LM head's
_P, _I = ctypes.c_void_p, ctypes.c_int64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="dw", choices=sorted(VARIANTS))
    ap.add_argument("--csrc", default=str(ROOT / "tlie_tpu_torch" / "ops" / "csrc"))
    ap.add_argument("--variants", default=None, help="comma-separated, default all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tlie_tpu_torch.ops import fused_xent as fx

    csrc = Path(args.csrc).resolve()
    text = (csrc / SOURCE).read_text()
    variants = VARIANTS[args.kernel]
    if args.variants:
        variants = {k: variants[k] for k in args.variants.split(",")}
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda kv: build(csrc, SOURCE, f"{args.kernel}-{kv[0]}", patched(text, kv[1])),
            variants.items())))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, weight, b, labels = cs.xent_inputs(dev, gen, *SHAPE, dtype=torch.bfloat16)
    w = weight.t()
    M, D, V = SHAPE
    want_loss, lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=dev)
    want = dict(zip(("dh", "dw", "db"), fx.fused_xent_bwd_plain(h, w, b, labels, lse, gscale)))
    want["dw"] = want["dw"].t()  # as (V, D) rows
    want.update(loss=want_loss, lse=lse)
    flush = torch.empty(64 * 2**20, device=dev)
    splits = fx.forward_splits_bf16(
        M, D, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    # the entry's outputs after the pointers of (h, W, b, labels), and its arguments
    outs = {"dh": {"lse": lse, "gscale": gscale, "dh": torch.empty_like(h)},
            "dw": {"lse": lse, "gscale": gscale,
                   "dw": torch.empty(V, D, device=dev, dtype=torch.bfloat16),
                   "db": torch.empty(V, device=dev, dtype=torch.bfloat16)},
            "fwd": {"loss": torch.empty(M, device=dev), "lse": torch.empty(M, device=dev),
                    "part": torch.empty(3, splits, M, device=dev)}}[args.kernel]
    sizes = (M, D, V, splits) if args.kernel == "fwd" else (M, D, V)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"kernel={args.kernel} csrc={csrc} shape={SHAPE}", flush=True)
    for variant, (lib_path, regs) in built.items():
        fn = getattr(ctypes.CDLL(str(lib_path)), f"tlie_fused_xent_{args.kernel}_bf16")
        fn.argtypes, fn.restype = [_P] * (4 + len(outs)) + [_I] * len(sizes) + [_P], ctypes.c_int

        def run():
            fx.check(fn(h.data_ptr(), weight.data_ptr(), b.data_ptr(), labels.data_ptr(),
                        *(t.data_ptr() for t in outs.values()), *sizes, stream), variant)

        cold = cs.median(cs.cuda_ms(run, 11, flush))
        warm = cs.median(cs.cuda_ms(run, 11))
        fields = {args.kernel: f"cold={cold:.5f},warm={warm:.5f}"}
        if variant == "as_is":
            run()
            torch.cuda.synchronize()
            got = {k: t for k, t in outs.items() if k in want and t is not lse}
            fields["max_abs_err"] = ",".join(
                f"{k}={(t.float() - want[k].float()).abs().max().item():.3e}"
                for k, t in got.items())
            fields["equal_share"] = ",".join(
                f"{k}={(t == want[k]).float().mean().item():.4f}" for k, t in got.items())
        print(f"[variant] {variant}: " + " ".join(f"{k}={v}" for k, v in fields.items())
              + f" ptxas={regs!r}", flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
