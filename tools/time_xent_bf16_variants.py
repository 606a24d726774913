#!/usr/bin/env python3
"""Where the fused head's bfloat16 dW/db kernel spends its time, on the card:
the kernel timed as it is and with parts of its work cut.

    python3 tools/time_xent_bf16_variants.py [--csrc DIR]

It reads ``fused_xent_bf16.cu`` from ``DIR`` (default the port's
``tlie_tpu_torch/ops/csrc``; point it at the ``csrc`` of a tree unpacked
with ``git archive`` to measure that tree's kernel), writes one copy of it
per variant with the edits of ``VARIANTS`` applied (each edit must match the
source exactly once, or the script fails), builds each copy with ``nvcc``
(``tlie_tpu_torch/_build/variants/``, in parallel) and times
``tlie_fused_xent_dw_bf16`` of each at the WikiText LM head's shape (M 8192,
D 512, V 50257): L2-cold and warm medians of 11 launches, as
``chip_smoke.py`` times every kernel.  The variants:

* ``as_is``: the source unchanged;
* ``resident``: no q-tile of h is loaded (its boxes are not asked of the
  tensor memory accelerator), so the products run on whatever the slots
  hold: the walk without its loads;
* ``no_logits``: the logits' products cut (t formed from zeros);
* ``no_dw_product``: the second product, bf16(t) h into dW, cut;
* ``no_t``: p and t left at zero (no exp), the exchange kept;
* ``fast_exp``: the softmax's exp by ``__expf`` (the hardware's ex2),
  where the source takes ``expf``;
* ``no_p_exp``: the exp cut from the softmax;
* ``no_exchange``: the band's warps neither wait for each other nor read
  each other's logits (t formed from zeros past the warp's own).

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
VARIANTS = {
    "as_is": [],
    "resident": [("      mbar_expect(&bars[sl], static_cast<uint32_t>(kHQ * Dpad * 2));\n"
                  "      for (int c = 0; c < Dpad / kBox; ++c)",
                  "      mbar_expect(&bars[sl], 0u);\n      for (int c = 0; c < 0; ++c)")],
    "no_logits": [("      for (int k0 = 0; k0 < Dpad; k0 += kBK) {\n        const bf16* wa",
                   "      for (int k0 = 0; k0 < 0; k0 += kBK) {\n        const bf16* wa")],
    "no_dw_product": [("        if (kBox * j >= dcols || d0 + kBox * j >= Dpad) continue;",
                       "        if (true) continue;")],
    "no_t": [("          pv[2 * hh + e] = q_ok ? expf(",
              "          pv[2 * hh + e] = false ? expf("),
             ("          t[hh][e] = (pv[2 * hh + e] - (v32[hh] == lab ? 1.f : 0.f)) * g_scale;",
              "          t[hh][e] = 0.f;")],
    "fast_exp": [("? expf(s[n][2 * hh + e] + bias[hh] - l)",
                  "? __expf(s[n][2 * hh + e] + bias[hh] - l)")],
    "no_p_exp": [("? expf(s[n][2 * hh + e] + bias[hh] - l)",
                  "? (s[n][2 * hh + e] + bias[hh] - l)")],
    "no_exchange": [
        ("    asm volatile(\"bar.sync %0, %1;\\n\" ::\"r\"(1 + band), \"r\"(32 * PL::kSplit) "
         ": \"memory\");\n", ""),
        ("      const float4 f = xch[(owner * kQN + m % kQN) * 32 + lane];",
         "      const float4 f = make_float4(0.f * owner, 0.f, 0.f, 0.f);")],
}
SHAPE = (8192, 512, 50257)  # M, D, V: the WikiText LM head's
_P, _I = ctypes.c_void_p, ctypes.c_int64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=str(ROOT / "tlie_tpu_torch" / "ops" / "csrc"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tlie_tpu_torch.ops import fused_xent as fx

    csrc = Path(args.csrc).resolve()
    text = (csrc / SOURCE).read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(csrc, SOURCE, kv[0], patched(text, kv[1])), VARIANTS.items())))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, weight, b, labels = cs.xent_inputs(dev, gen, *SHAPE, dtype=torch.bfloat16)
    w = weight.t()
    M, D, V = SHAPE
    _, lse = fx.fused_xent_fwd_plain(h, w, b, labels)
    gscale = torch.full((1,), 1.0 / int((labels != -100).sum()), device=dev)
    want_dw, want_db = fx.fused_xent_bwd_plain(h, w, b, labels, lse, gscale)[1:]
    flush = torch.empty(64 * 2**20, device=dev)
    dw_rows = torch.empty(V, D, device=dev, dtype=torch.bfloat16)
    db = torch.empty(V, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"csrc={csrc} shape={SHAPE}", flush=True)
    for variant, (lib_path, regs) in built.items():
        fn = ctypes.CDLL(str(lib_path)).tlie_fused_xent_dw_bf16
        fn.argtypes, fn.restype = [_P] * 8 + [_I] * 3 + [_P], ctypes.c_int

        def dw():
            fx.check(fn(h.data_ptr(), weight.data_ptr(), b.data_ptr(), labels.data_ptr(),
                        lse.data_ptr(), gscale.data_ptr(), dw_rows.data_ptr(), db.data_ptr(),
                        M, D, V, stream), variant)

        cold = cs.median(cs.cuda_ms(dw, 11, flush))
        warm = cs.median(cs.cuda_ms(dw, 11))
        fields = {"dw": f"cold={cold:.5f},warm={warm:.5f}"}
        if variant == "as_is":
            dw()
            torch.cuda.synchronize()
            got_dw = dw_rows.t()
            fields["max_abs_err"] = (
                f"dw={(got_dw.float() - want_dw.float()).abs().max().item():.3e},"
                f"db={(db.float() - want_db.float()).abs().max().item():.3e}")
            fields["equal_share"] = (f"dw={(got_dw == want_dw).float().mean().item():.4f},"
                                     f"db={(db == want_db).float().mean().item():.4f}")
        print(f"[variant] {variant}: " + " ".join(f"{k}={v}" for k, v in fields.items())
              + f" ptxas={regs!r}", flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
