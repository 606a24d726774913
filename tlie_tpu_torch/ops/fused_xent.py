"""Fused decoder + softmax cross-entropy, counterpart of
``tlie_tpu/ops/fused_xent.py``.

``fused_softmax_xent(h, w, b, labels)`` is the mean, over the rows whose
label is not −100 (their count clamped to at least 1), of the softmax
cross-entropy of ``h @ w + b``: h (M, D), w (D, V), b (V,), labels (M,) in
JAX's layout.  :class:`FusedXentFn` is its ``torch.autograd.Function``
(the ``jax.custom_vjp`` of the reference), giving (dh, dw, db).

The weight's layout: the port's decoder is an ``nn.Linear`` whose weight is
(V, D), and ``w`` is its transpose ``weight.t()``, a (D, V) view with strides
(1, D).  That is the one layout the function takes, on every device: the
kernels read the (V, D) rows in place, so the 103 MB weight of the WikiText
LM is never copied, and a contiguous (D, V) ``w`` raises instead of being
transposed silently.  ``dw`` comes back in the same layout.

h, w and b are all float32 or all bfloat16 (``_fused_loss``,
``tlie_tpu/training/scan_loop.py:265-267``, casts all three under
``compute_dtype: bfloat16``); a mix raises.  On bfloat16 operands the
function computes what the Pallas kernels compute there
(``tlie_tpu/ops/fused_xent.py:23-29``): the logits are float32 sums of the
(exact) products of bfloat16 values plus the bias widened to float32; lse,
the picked logit and the loss are float32; t = (softmax − onehot) · g is
float32 and rounded to bfloat16 before its two products (``_cast_for_dot``);
dh = bf16(t) wᵀ and dw = hᵀ bf16(t) are float32 sums rounded to bfloat16
once, and db is the float32 row sum of the unrounded t rounded once.  The
gradients come back in the primal dtypes (``_vjp_bwd``).

Where the work runs follows the tensors:

* CUDA tensors go to the three kernels of ``csrc/fused_xent.cu`` on float32
  operands and of ``csrc/fused_xent_bf16.cu`` on bfloat16 ones
  (:func:`fused_xent_fwd_cuda`, :func:`fused_xent_dh_cuda`,
  :func:`fused_xent_dw_cuda`), which replace the reference's three Pallas
  kernels; the logits never reach device memory.  Their launches count
  under ``fused_xent_{fwd,dh,dw}`` and ``fused_xent_{fwd,dh,dw}_bf16``.
  There is no fallback: a tensor they do not take raises.
* CPU tensors go to :func:`fused_xent_fwd_plain` and
  :func:`fused_xent_bwd_plain`: the materialised ``h @ w + b``, its masked
  logsumexp, and the backward written out as
  ``(softmax − onehot) · g / n_valid`` (the reference's ``_vjp_bwd``), with
  the rounding points above on bfloat16 operands.  They are also what the
  kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._build import LAUNCHES, CudaLibrary, check

IGNORE = -100

# The reference's row tiles (tlie_tpu/ops/fused_xent.py:46).  The CUDA
# kernels tile rows by their own 64 (forward) and 64 or 32 (backward);
# _pick_tm keeps the reference's rule for which row counts the function takes.
_TM_CANDIDATES = (1024, 512, 256, 128)
_MAX_D = 1024  # the kernels' plans go to 1024 (64 or 32 rows a block past 512)
_KERNEL_Q = 128  # vocabulary rows per tile of the float32 forward kernel
_KERNEL_ROWS = 64  # rows of h per block of the float32 forward kernel (kFwdRows)
# Blocks of the float32 forward kernel per SM, two at a time: many short
# blocks shorten the last wave's tail.  On an H100 at the LM's shape (M
# 8192, D 512, V 50257) 33 splits (4,224 blocks) took 7.35 ms, 5 splits
# (640) 7.58.
_BLOCKS_PER_SM = 32

_P, _I = ctypes.c_void_p, ctypes.c_int64


def _signatures(sfx: str) -> dict:
    return {f"tlie_fused_xent_fwd_{sfx}": (_P,) * 7 + (_I,) * 4 + (_P,),
            f"tlie_fused_xent_dh_{sfx}": (_P,) * 7 + (_I,) * 3 + (_P,),
            f"tlie_fused_xent_dw_{sfx}": (_P,) * 8 + (_I,) * 3 + (_P,)}


FUSED_XENT = CudaLibrary("fused_xent", _signatures("f32"))
FUSED_XENT_BF16 = CudaLibrary("fused_xent_bf16", _signatures("bf16"))
# the library and the entry points' suffix of each operand dtype
_LIBRARY = {torch.float32: (FUSED_XENT, "f32"), torch.bfloat16: (FUSED_XENT_BF16, "bf16")}
for _kernel in ("fwd", "dh", "dw"):
    LAUNCHES.setdefault(f"fused_xent_{_kernel}", 0)
    LAUNCHES.setdefault(f"fused_xent_{_kernel}_bf16", 0)


def launch_name(kernel: str, dtype: torch.dtype) -> str:
    """The name under which a kernel's launches count: ``fused_xent_fwd``
    for float32 operands, ``fused_xent_fwd_bf16`` for bfloat16."""
    return f"fused_xent_{kernel}" + ("_bf16" if dtype == torch.bfloat16 else "")


def _pick_tm(M: int) -> int:
    for tm in _TM_CANDIDATES:
        if M % tm == 0:
            return tm
    raise ValueError(f"row count {M} not tileable by 128")


def fused_xent_eligible(M: int, D: int, V: int) -> bool:
    # V needs no divisibility: a ragged trailing vocab tile is masked to
    # -1e30 in-kernel, contributing exp(-1e30 - m) = 0 to every statistic
    # and zero gradient
    return M % _TM_CANDIDATES[-1] == 0 and D <= 1024


def fused_softmax_xent(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       labels: torch.Tensor, shard=None) -> torch.Tensor:
    """Mean masked softmax cross-entropy of ``h @ w + b`` against
    ``labels`` (−100 ignored), a scalar; differentiable in h, w and b.
    With ``shard`` (a data-parallel rank's
    :class:`~tlie_tpu_torch.parallel.mesh.Shard`, holding its rows of a
    global batch) the mean divides by the valid count summed over the
    group, so the ranks' losses and gradients sum to the global batch's."""
    _check_operands(h, w, b, labels)
    args = (h, w, b, labels) if shard is None else (h, w, b, labels, shard)
    return FusedXentFn.apply(*args)


def _check_operands(h, w, b, labels) -> None:
    """The contract of the function on every device: h (M, D) contiguous,
    w (D, V) as the transpose of a row-major (V, D) weight, b (V,), all
    three float32 or all three bfloat16, integer labels (M,), and M a
    multiple of 128 (``_pick_tm``)."""
    if h.dtype not in _LIBRARY or not h.dtype == w.dtype == b.dtype:
        raise TypeError("fused_softmax_xent takes h, w and b all float32 or all bfloat16; "
                        f"got {h.dtype}, {w.dtype}, {b.dtype}")
    if h.dim() != 2 or w.dim() != 2 or b.dim() != 1 or labels.dim() != 1:
        raise ValueError("fused_softmax_xent takes h (M, D), w (D, V), b (V,), labels (M,)")
    (M, D), V = h.shape, w.shape[1]
    if w.shape[0] != D or b.shape[0] != V or labels.shape[0] != M:
        raise ValueError(f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, "
                         f"labels {tuple(labels.shape)} do not agree")
    if not w.t().is_contiguous():
        raise ValueError(
            "fused_softmax_xent takes w as the transpose of a row-major (V, D) weight "
            f"(nn.Linear.weight.t(), strides (1, D)); got strides {w.stride()}: "
            "the 103 MB decoder weight is not copied to another layout")
    if not h.is_contiguous() or not b.is_contiguous():
        raise ValueError("fused_softmax_xent takes contiguous h and b")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    if not (h.device == w.device == b.device == labels.device):
        raise ValueError("fused_softmax_xent: operands on different devices")
    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_softmax_xent runs on cuda or cpu, not {h.device}")
    _pick_tm(M)  # raises where the reference's kernel takes no row tile
    if D > _MAX_D:
        raise ValueError(f"fused_softmax_xent takes D <= {_MAX_D}, got {D}")


def _on_cuda(t: torch.Tensor) -> bool:
    """The routing decision: the kernels for CUDA tensors, the plain
    versions for CPU tensors (``_check_operands`` refuses any other)."""
    return t.device.type == "cuda"


class FusedXentFn(torch.autograd.Function):
    """Autograd around the fused head: the kernels for CUDA tensors, the
    plain versions for CPU tensors, forward and backward alike.  Saves
    (h, w, b, labels, lse, n_valid) as the reference's ``_vjp_fwd`` does;
    the loss is float32 and the gradients come in the primal dtypes."""

    @staticmethod
    def forward(ctx, h, w, b, labels, shard=None):
        labels = labels.long()
        ctx.cuda = _on_cuda(h)
        fwd = fused_xent_fwd_cuda if ctx.cuda else fused_xent_fwd_plain
        loss_rows, lse = fwd(h, w, b, labels)
        n_valid = (labels != IGNORE).sum()
        if shard is not None:
            n_valid = shard.sum(n_valid)
        n_valid = n_valid.clamp_min(1)
        ctx.save_for_backward(h, w, b, labels, lse, n_valid)
        return loss_rows.sum() / n_valid

    @staticmethod
    def backward(ctx, g):
        h, w, b, labels, lse, n_valid = ctx.saved_tensors
        gscale = (g.float() / n_valid).reshape(1)
        if ctx.cuda:
            dh = fused_xent_dh_cuda(h, w, b, labels, lse, gscale)
            dw, db = fused_xent_dw_cuda(h, w, b, labels, lse, gscale)
        else:
            dh, dw, db = fused_xent_bwd_plain(h, w, b, labels, lse, gscale)
        return dh, dw, db, None, None


# -- plain versions -------------------------------------------------------------


def _widen(*ts):
    """bfloat16 tensors as float32, the precision their products are taken
    in (a product of two bfloat16 values is exact in float32); others as
    they are."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)


def fused_xent_fwd_plain(h, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss per row, lse per row) from the materialised logits; the loss
    is 0 on ignored rows, the lse is every row's.  bfloat16 operands are
    widened to float32 first."""
    h, w, b = _widen(h, w, b)
    logits = torch.addmm(b, h, w)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != IGNORE
    picked = torch.gather(logits, 1, labels.clamp_min(0)[:, None])[:, 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse)), lse


def fused_xent_bwd_plain(h, w, b, labels, lse, gscale):
    """(dh, dw, db) for the cotangent ``gscale`` (g / n_valid, shape (1,))
    on every valid row's loss: t = (softmax − onehot) · gscale on valid rows
    and 0 on ignored ones; dh = t wᵀ, dw = hᵀ t, db = Σ_rows t, in the
    operands' dtype.  dw comes back in w's layout.  On bfloat16 operands t
    is rounded to bfloat16 before both products, which sum in float32 and
    round once, and db sums the unrounded t in float32 and rounds once."""
    dtype = h.dtype
    h, w, b = _widen(h, w, b)
    t = _dlogits_plain(h, w, b, labels, lse, gscale)
    tr = _round_t(t, dtype)
    dw = (tr.t() @ h).to(dtype).t()  # (D, V) with strides (1, D), as w
    return (tr @ w.t()).to(dtype), dw, t.sum(0).to(dtype)


def _round_t(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as the products take it: rounded to bfloat16 (to nearest even) and
    widened back on bfloat16 operands (``_cast_for_dot``), else as it is."""
    return t.to(torch.bfloat16).float() if dtype == torch.bfloat16 else t


def _dlogits_plain(h, w, b, labels, lse, gscale) -> torch.Tensor:
    """The materialised (M, V) t = (softmax − onehot) · gscale · valid, in
    float32 on bfloat16 operands."""
    h, w, b = _widen(h, w, b)
    t = torch.exp(torch.addmm(b, h, w) - lse[:, None])
    valid = labels != IGNORE
    rows = torch.arange(labels.shape[0], device=labels.device)
    t[rows[valid], labels[valid]] -= 1.0
    return t * (gscale * valid.to(t.dtype))[:, None]


# -- the kernels ------------------------------------------------------------------


def _check_cuda(tensors, what: str) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what} takes CUDA tensors on one device")
    return dev


def forward_splits(M: int, V: int, n_sms: int) -> int:
    """Vocabulary splits of the float32 forward kernel: enough blocks for
    about ``_BLOCKS_PER_SM`` per SM, each split with at least one 128-row
    vocabulary tile."""
    row_tiles = -(-M // _KERNEL_ROWS)
    n_tiles = -(-V // _KERNEL_Q)
    want = max(1, min(n_tiles, -(-_BLOCKS_PER_SM * n_sms // row_tiles)))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split)


def forward_tiles_bf16(D: int) -> Tuple[int, int]:
    """(rows of h a block, vocabulary rows a tile) of the bfloat16 forward
    kernel (``FwdPlan``): 128 and 32 where D rounded up to 64 is at most
    512, 64 and 16 above.  A block keeps its rows of h resident and walks
    its split's tiles."""
    rows = 128 if -(-D // 64) * 64 <= 512 else 64
    return rows, rows // 4


def forward_splits_bf16(M: int, D: int, V: int, n_sms: int) -> int:
    """Vocabulary splits of the bfloat16 forward kernel: it runs one block
    an SM (225 KB of shared memory at D 512), so as many splits as fill one
    wave with row blocks (at least one), each split with the same whole
    number of tiles.  At the LM's shape (M 8192, D 512, V 50257) on 132 SMs:
    64 row blocks, 2 splits, 128 blocks."""
    rows, tile = forward_tiles_bf16(D)
    row_tiles = -(-M // rows)
    n_tiles = -(-V // tile)
    want = max(1, min(n_tiles, n_sms // row_tiles))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def fused_xent_fwd_cuda(h, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward of ``csrc/fused_xent.cu`` (float32 operands) or
    ``csrc/fused_xent_bf16.cu`` (bfloat16): (loss per row, lse per row),
    float32, as :func:`fused_xent_fwd_plain`.  Operands as
    :func:`fused_softmax_xent` takes them, labels int64, all on one card."""
    dev = _check_cuda((h, w, b, labels), "fused_xent_fwd_cuda")
    _check_operands(h, w, b, labels)
    M, D = h.shape
    V = w.shape[1]
    labels = labels.long()
    loss = torch.empty(M, device=dev)
    lse = torch.empty(M, device=dev)
    if M == 0:
        return loss, lse
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = (forward_splits_bf16(M, D, V, n_sms) if h.dtype == torch.bfloat16
              else forward_splits(M, V, n_sms))
    part = torch.empty(3, splits, M, device=dev)
    lib, sfx = _LIBRARY[h.dtype]
    fn = lib.fn(f"tlie_fused_xent_fwd_{sfx}")
    with torch.cuda.device(dev):
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), loss.data_ptr(),
                 lse.data_ptr(), part.data_ptr(), M, D, V, splits, _stream(dev))
    name = launch_name("fwd", h.dtype)
    check(err, name)
    LAUNCHES[name] += 1
    return loss, lse


def _bwd_args(h, w, b, labels, lse, gscale, what):
    dev = _check_cuda((h, w, b, labels, lse, gscale), what)
    _check_operands(h, w, b, labels)
    M = h.shape[0]
    if lse.shape != (M,) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{what}: lse must be contiguous float32 ({M},)")
    if gscale.shape != (1,) or gscale.dtype != torch.float32:
        raise ValueError(f"{what}: gscale must be float32 of shape (1,)")
    return dev, labels.long()


def fused_xent_dh_cuda(h, w, b, labels, lse, gscale) -> torch.Tensor:
    """Launch the dh kernel of ``csrc/fused_xent.cu`` or
    ``csrc/fused_xent_bf16.cu``: dh (M, D) in h's dtype, as the first
    output of :func:`fused_xent_bwd_plain`."""
    dev, labels = _bwd_args(h, w, b, labels, lse, gscale, "fused_xent_dh_cuda")
    M, D = h.shape
    dh = torch.empty(M, D, device=dev, dtype=h.dtype)
    if dh.numel() == 0:
        return dh.zero_()
    lib, sfx = _LIBRARY[h.dtype]
    fn = lib.fn(f"tlie_fused_xent_dh_{sfx}")
    with torch.cuda.device(dev):
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                 gscale.data_ptr(), dh.data_ptr(), M, D, w.shape[1], _stream(dev))
    name = launch_name("dh", h.dtype)
    check(err, name)
    LAUNCHES[name] += 1
    return dh


def fused_xent_dw_cuda(h, w, b, labels, lse, gscale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dW/db kernel of ``csrc/fused_xent.cu`` or
    ``csrc/fused_xent_bf16.cu``: (dw, db) in w's dtype, dw (D, V) in w's
    layout (written as its (V, D) rows), as :func:`fused_xent_bwd_plain`."""
    dev, labels = _bwd_args(h, w, b, labels, lse, gscale, "fused_xent_dw_cuda")
    M, D = h.shape
    V = w.shape[1]
    dw_rows = torch.empty(V, D, device=dev, dtype=w.dtype)
    db = torch.empty(V, device=dev, dtype=w.dtype)
    if M == 0 or dw_rows.numel() == 0:
        return dw_rows.zero_().t(), db.zero_()
    lib, sfx = _LIBRARY[h.dtype]
    fn = lib.fn(f"tlie_fused_xent_dw_{sfx}")
    with torch.cuda.device(dev):
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                 gscale.data_ptr(), dw_rows.data_ptr(), db.data_ptr(), M, D, V, _stream(dev))
    name = launch_name("dw", h.dtype)
    check(err, name)
    LAUNCHES[name] += 1
    return dw_rows.t(), db


def grad_term_scales(h, w, b, labels, lse, gscale):
    """Σ|terms| of every gradient element, the scale to which float32
    rounding of a sum is held: (|t| |w|ᵀ, |h|ᵀ |t| in w's layout, Σ_rows |t|)
    with t as in :func:`fused_xent_bwd_plain` (rounded to bfloat16 in the
    two products on bfloat16 operands), in float32 or float64.  dh sums V
    terms per element and dw M, so their errors are held to these sums, not
    to max|dh|."""
    dtype = h.dtype
    h, w, b = _widen(h, w, b)
    t = _dlogits_plain(h, w, b, labels, lse, gscale).abs()
    tr = _round_t(t, dtype)
    return tr @ w.t().abs(), (tr.t() @ h.abs()).t(), t.sum(0)


def loss_term_scales(loss, lse):
    """Σ|terms| of each row's loss lse − picked, |lse| + |picked| (2|lse| on
    an ignored row, whose loss is 0): the scale to which the float32
    rounding of a row's loss is held.  The picked logit's rounding enters
    the loss undamped, while lse averages its logits' roundings."""
    return lse.abs() + (lse - loss).abs()
