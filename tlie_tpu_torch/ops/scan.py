"""Diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t`` with ``h_{-1} = 0``.

Counterpart of ``tlie_tpu/ops/scan.py::diag_linear_scan`` for real tensors
and complex recurrences carried as (re, im) pairs of real tensors.  The time
axis is -2, as in ``(..., L, N)``, and ``a`` broadcasts against ``b``: the
LRU passes one decay (L, N) for the whole batch (B, L, N).

Where the work runs follows the tensors:

* CUDA tensors go to the hand-written kernel ``csrc/diag_scan.cu``
  (:func:`diag_scan_cuda`), which replaces the TPU kernel
  ``tlie_tpu/ops/pallas_scan.py::_run_scan_planes``.  There is no fallback:
  a tensor the kernel does not take raises.
* CPU tensors go to :func:`diag_scan_plain`, the sequential loop that is the
  counterpart of ``_scan_sequential_real`` / ``_scan_sequential_pair`` and the
  reference the kernel is held against.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from ._build import LAUNCHES, CudaLibrary, check

Pair = Tuple[torch.Tensor, torch.Tensor]
TensorOrPair = Union[torch.Tensor, Pair]

_P, _I = ctypes.c_void_p, ctypes.c_int64
DIAG_SCAN = CudaLibrary(
    "diag_scan", {"tlie_diag_scan_f32": (_P,) * 6 + (_I,) * 5 + (ctypes.c_int, _P)}
)
LAUNCHES.setdefault("diag_scan", 0)
_LANES = 32  # channels per block in the kernel
_MAX_BLOCKS = 2**31 - 1


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2


def _as_pair(x: TensorOrPair) -> Pair:
    return x if _is_pair(x) else (x, torch.zeros_like(x))


def _on_cuda(t: torch.Tensor) -> bool:
    """The routing decision: the kernel for CUDA tensors, the plain loop for
    CPU tensors, nothing else."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"diag_linear_scan runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def diag_linear_scan(
    a: TensorOrPair, b: TensorOrPair, *, axis: int = -2, reverse: bool = False
) -> TensorOrPair:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along ``axis`` (-2).

    ``a``/``b`` are real tensors or (re, im) pairs; if either is a pair the
    result is a pair.  ``reverse`` scans right to left; on CUDA it belongs to
    the training slice and raises ``NotImplementedError``."""
    pair = _is_pair(a) or _is_pair(b)
    if pair:
        a, b = _as_pair(a), _as_pair(b)
    ref = b[0] if pair else b
    if axis not in (-2, ref.dim() - 2):
        raise ValueError(f"diag_linear_scan takes the time axis at -2, got {axis}")
    if _on_cuda(ref):
        if reverse:
            raise NotImplementedError(
                "the reverse scan kernel comes with the training slice"
            )
        return diag_scan_cuda(a, b)
    return diag_scan_plain(a, b, reverse=reverse)


def diag_scan_plain(a: TensorOrPair, b: TensorOrPair, reverse: bool = False):
    """Sequential reference, one time step at a time along dim -2."""
    pair = _is_pair(b)
    if pair:
        ar, ai, br, bi = torch.broadcast_tensors(a[0], a[1], b[0], b[1])
    else:
        dtype = torch.result_type(a, b)
        ar, br = torch.broadcast_tensors(a.to(dtype), b.to(dtype))
    L = br.shape[-2]
    steps = range(L - 1, -1, -1) if reverse else range(L)
    hr = torch.empty_like(br, memory_format=torch.contiguous_format)
    cr = torch.zeros_like(br[..., 0, :])
    if pair:
        hi = torch.empty_like(hr)
        ci = torch.zeros_like(cr)
        for t in steps:
            art, ait = ar[..., t, :], ai[..., t, :]
            cr, ci = art * cr - ait * ci + br[..., t, :], art * ci + ait * cr + bi[..., t, :]
            hr[..., t, :] = cr
            hi[..., t, :] = ci
        return hr, hi
    for t in steps:
        cr = ar[..., t, :] * cr + br[..., t, :]
        hr[..., t, :] = cr
    return hr


def _a_strides(a: torch.Tensor, shape: torch.Size) -> Tuple[int, int]:
    """(batch, time) element strides at which the kernel reads ``a`` broadcast
    to ``shape`` (leading dims flattened into one batch axis)."""
    full = torch.broadcast_to(a, shape)  # raises if a does not broadcast
    L, N = shape[-2], shape[-1]
    if N > 1 and full.stride(-1) != 1:
        raise ValueError("diag_scan_cuda: a must be contiguous along channels")
    t_stride = full.stride(-2) if L > 1 else 0
    if all(s == 1 for s in a.shape[:-2]):
        return 0, t_stride
    if a.shape == shape and a.is_contiguous():
        return L * N, t_stride
    raise ValueError(
        f"diag_scan_cuda: a {tuple(a.shape)} must be shared across the batch "
        f"or match b {tuple(shape)} and be contiguous"
    )


def diag_scan_cuda(a: TensorOrPair, b: TensorOrPair) -> TensorOrPair:
    """Launch ``csrc/diag_scan.cu`` on the current stream: float32 CUDA
    tensors, ``b`` contiguous (..., L, N), ``a`` broadcasting to it.  Raises
    on anything else; never computes the result another way."""
    pair = _is_pair(b)
    a_planes = tuple(a) if pair else (a,)
    b_planes = tuple(b) if pair else (b,)
    ref = b_planes[0]
    for t in a_planes + b_planes:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("diag_scan_cuda takes CUDA tensors only")
        if t.device != ref.device:
            raise ValueError("diag_scan_cuda: operands on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"diag_scan_cuda takes float32, got {t.dtype}")
    if ref.dim() < 2:
        raise ValueError("diag_scan_cuda: b must be (..., L, N)")
    for t in b_planes:
        if t.shape != ref.shape or not t.is_contiguous():
            raise ValueError("diag_scan_cuda: b planes must share a contiguous shape")
    shape = ref.shape
    L, N = shape[-2], shape[-1]
    batch = math.prod(shape[:-2])
    a_bstride, a_tstride = _a_strides(a_planes[0], shape)
    if pair and (a[1].shape != a[0].shape or a[1].stride() != a[0].stride()):
        raise ValueError("diag_scan_cuda: a planes must share shape and strides")
    if batch * -(-N // _LANES) > _MAX_BLOCKS:
        raise ValueError(f"diag_scan_cuda: shape {tuple(shape)} needs too many blocks")

    h_planes = tuple(torch.empty_like(ref) for _ in b_planes)
    if ref.numel() == 0:
        return h_planes if pair else h_planes[0]
    fn = DIAG_SCAN.fn("tlie_diag_scan_f32")
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(
            a_planes[0].data_ptr(), a_planes[1].data_ptr() if pair else None,
            b_planes[0].data_ptr(), b_planes[1].data_ptr() if pair else None,
            h_planes[0].data_ptr(), h_planes[1].data_ptr() if pair else None,
            batch, L, N, a_bstride, a_tstride, int(pair), stream,
        )
    check(err, "diag_scan")
    LAUNCHES["diag_scan"] += 1
    return h_planes if pair else h_planes[0]
