"""The decay attention's bfloat16 kernels as the port binds them: all three
from ``csrc/decay_attention_bf16.cu``, the three float32 kernels from
``csrc/decay_attention.cu``.

On the CPU no kernel builds or runs: these tests hold the bindings to the
sources (one library entry for each kernel and operand dtype, no symbol
defined in both sources), the routing of CPU tensors to the plain version
(no launch counted), and :func:`decay_attention.load_route`, which names
how the bfloat16 kernels land their tiles, to the conditions the source
tests.  The kernels themselves are held to the plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``), their numerical
design on the CPU in ``tests/test_torch_bf16_tiles.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_independence as independence
from torch_parity import load_chip_smoke
from tlie_tpu_torch.ops import LAUNCHES
from tlie_tpu_torch.ops import decay_attention as da

CSRC = Path(da.__file__).resolve().parent / "csrc"
OLD = (CSRC / "decay_attention.cu").read_text()
NEW = (CSRC / "decay_attention_bf16.cu").read_text()
KERNELS = ("fwd", "bwd_i", "bwd_j")
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _exported(src: str) -> set:
    """The extern "C" names a source defines, its entry macro expanded."""
    names = set(re.findall(r'extern "C" int (tlie_\w+)\(', src))
    for suffix in re.findall(r"^TLIE_DECAY_ENTRIES\((\w+), ", src, re.M):
        names |= {f"tlie_decay_attention_{k}_{suffix}" for k in KERNELS}
    return names


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_each_kernel_and_dtype_has_one_library_entry(kernel, dtype):
    """Each of the six (kernel, dtype) pairs is an entry of exactly one
    library, the one the wrappers take it from: the bfloat16 kernels of
    ``decay_attention_bf16``, the float32 ones of ``decay_attention``."""
    entry = f"tlie_decay_attention_{kernel}_{DTYPES[dtype]}"
    owners = [lib for lib in (da.DECAY_ATTENTION, da.DECAY_ATTENTION_BF16)
              if entry in lib.signatures]
    assert owners == [da._library(kernel, dtype)]
    new = dtype == torch.bfloat16
    assert owners[0].name == ("decay_attention_bf16" if new else "decay_attention")
    assert da.launch_name(kernel, dtype) in LAUNCHES


def test_the_sources_define_each_entry_once():
    """No symbol of ``decay_attention_bf16.cu`` is also defined in
    ``decay_attention.cu`` (both libraries load into one process), and each
    source exports exactly its library's entries."""
    old, new = _exported(OLD), _exported(NEW)
    assert old & new == set()
    assert old == set(da.DECAY_ATTENTION.signatures)
    assert new == set(da.DECAY_ATTENTION_BF16.signatures)
    assert len(old | new) == 6
    assert "TLIE_DECAY_ENTRIES(bf16" not in OLD and "_bwd_i_bf16(" not in OLD


def _inputs(BG, Q, N, Hg, P, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)

    cs = torch.from_numpy(np.cumsum(-rng.uniform(0.0, 1.6, (BG, Hg, Q)), -1).astype(np.float32))
    return t(BG, Q, N), t(BG, Q, N), cs, t(BG, Hg, Q, P), t(BG, Hg, Q, P)


def test_bf16_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """bfloat16 CPU tensors through ``decay_attention``'s autograd: the plain
    forward and backward functions' outputs, no launch and no load route
    counted."""
    C, B, cs, x, dy = _inputs(2, 70, 24, 3, 16, seed=1)
    launches, routes = dict(LAUNCHES), dict(da.LOAD_ROUTES)
    leaves = [t.clone().requires_grad_() for t in (C, B, cs, x)]
    y = da.decay_attention(*leaves)
    y.backward(dy)
    assert LAUNCHES == launches and da.LOAD_ROUTES == routes
    dC, dcs_i, dB, dxdt, dcs_j = da.decay_attention_bwd_plain(C, B, cs, x, dy)
    assert torch.equal(y, da.decay_attention_plain(C, B, cs, x))
    for got, want in zip((leaves[0].grad, leaves[1].grad, leaves[2].grad, leaves[3].grad),
                         (dC, dB, dcs_i + dcs_j, dxdt)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _views(N, pad, off, P, x_off):
    """C as a view at element ``off`` of rows of N + pad, B contiguous, xdt
    and dy starting ``x_off`` elements into their storage (bfloat16)."""
    C = torch.zeros(2, 64, N + pad, dtype=torch.bfloat16)[:, :, off:off + N]
    B = torch.zeros(2, 64, N, dtype=torch.bfloat16)
    n = 2 * 3 * 64 * P
    x, dy = (torch.zeros(n + x_off, dtype=torch.bfloat16)[x_off:].view(2, 3, 64, P)
             for _ in range(2))
    return C, B, x, dy


@pytest.mark.parametrize("N, pad, off, P, x_off, want", [
    (512, 16, 8, 64, 0, "cp.async16"),  # ops/ssd.py's views of the conv output
    (512, 8, 4, 64, 0, "ordinary"),     # C 8 bytes off a 16-byte boundary
    (65, 16, 8, 64, 0, "ordinary"),     # odd N
    (40, 16, 8, 33, 0, "ordinary"),     # P 33
    (128, 0, 0, 128, 1, "ordinary"),    # xdt one element off
], ids=["ssd_views", "c_8_bytes_off", "odd_n", "p33", "x_off_by_one"])
def test_load_route_follows_the_sources_conditions(N, pad, off, P, x_off, want):
    """16-byte copies of every tile where N, P and C's and B's batch and row
    strides are multiples of 8 elements and the bases of C, B, xdt and dy
    16-byte aligned (``vec_tiles``), ordinary loads otherwise.  The source
    tests those conditions in the same terms, and picks its kernels'
    instantiation by them on the host: the forward on C, B and xdt, bwd_i
    and bwd_j on C, B, xdt and dy.  A launch of each counts under the
    route it takes."""
    C, B, x, dy = _views(N, pad, off, P, x_off)
    if pad:
        assert C.data_ptr() - C._base.data_ptr() == 2 * off
    assert da.load_route(C, B, x, dy) == want
    assert "(d.N | d.P | d.c_bs | d.c_ld | d.b_bs | d.b_ld) % kChunk == 0" in NEW
    assert ("(reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B) |\n"
            "          reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0"
            ) in NEW
    assert NEW.count("if (vec_tiles(C, B, x, x, d))") == 1
    assert NEW.count("if (vec_tiles(C, B, x, dy, d))") == 2
    routes = {}
    for kernel in ("fwd", "bwd_i", "bwd_j"):
        saved = dict(da.LOAD_ROUTES)
        try:
            da.LOAD_ROUTES.clear()
            da._count(kernel, torch.bfloat16, C, B, x, *((dy,) if kernel != "fwd" else ()))
            routes.update(da.LOAD_ROUTES)
        finally:
            LAUNCHES[da.launch_name(kernel, torch.bfloat16)] -= 1
            da.LOAD_ROUTES.clear()
            da.LOAD_ROUTES.update(saved)
    want_fwd = da.load_route(C, B, x)
    assert routes == {f"decay_attention_fwd_bf16:{want_fwd}": 1,
                      f"decay_attention_bwd_i_bf16:{want}": 1,
                      f"decay_attention_bwd_j_bf16:{want}": 1}
    assert re.search(r"constexpr int kChunk = 8;", NEW)


def test_the_independence_checks_cover_the_binding():
    """``decay_attention.py``, which binds both libraries, is among the files
    the JAX-independence test scans, and neither source names JAX."""
    assert Path(da.__file__).resolve() in {p.resolve() for p in independence.PORT_FILES}
    roots = set(independence._imported_roots(Path(da.__file__)))
    assert not roots & set(independence.FORBIDDEN)
    for src in (OLD, NEW):
        assert "jax" not in src.lower()


def test_chip_smoke_holds_the_new_kernels_to_bfloat16_hmma():
    """``chip_smoke.py``'s build phase reads the three bfloat16 kernels from
    the new library and demands ``HMMA.16816.F32.BF16`` of them."""
    cs = load_chip_smoke()
    assert cs.TC_KERNELS["decay_fwd_bf16"] == "decay_attention_bf16"
    assert cs.TC_KERNELS["decay_bwd_j_bf16"] == "decay_attention_bf16"
    assert cs.TC_KERNELS["decay_bwd_i_bf16"] == "decay_attention_bf16"
    for name in ("decay_fwd_bf16", "decay_bwd_j_bf16", "decay_bwd_i_bf16"):
        assert cs.TC_HMMA[name] == "HMMA.16816.F32.BF16"
    assert "decay_attention_fwd_bf16_kernel<kFC, kVec>" in NEW
    assert "decay_attention_bwd_j_bf16_kernel<kParts, kVec>" in NEW
    assert "decay_attention_bwd_i_bf16_kernel<kParts, kVec>" in NEW
