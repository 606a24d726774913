"""Diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t`` with ``h_{-1} = 0``,
and its gradient.

Counterpart of ``tlie_tpu/ops/scan.py::diag_linear_scan`` for real tensors
and complex recurrences carried as (re, im) pairs of real tensors.  The time
axis is -2, as in ``(..., L, N)``, and ``a`` broadcasts against ``b``: the
LRU passes one decay λ of shape (N,) for the whole batch (B, L, N).

:class:`DiagScanFn` is the autograd function, the counterpart of the
``jax.custom_vjp`` cores of ``tlie_tpu/ops/pallas_scan.py``.  It saves
``(a, h)`` and, given the cotangent ``g`` on ``h``, returns
``db = d`` with ``d_t = conj(a_{t+1}) d_{t+1} + g_t`` and
``da = Σ d_t conj(h_{t-1})`` summed to ``a``'s own shape.

Where the work runs follows the tensors:

* CUDA tensors go to the hand-written kernels: ``csrc/diag_scan.cu``
  (:func:`diag_scan_cuda`, forward and reverse) and ``csrc/diag_scan_bwd.cu``
  (:func:`diag_scan_bwd_cuda`), which replace the TPU kernel
  ``tlie_tpu/ops/pallas_scan.py::_run_scan_planes`` and the backward built
  on it.  A block of either takes 16 channels of one batch row, and each
  thread holds its chunk of time in registers between two passes, so b
  (forward) and g (backward) are read from device memory once.  The kernels
  read ``a`` at a batch stride and a time stride (:func:`_a_strides`): 0 for
  a decay shared across the batch, N for one per example and constant in
  time ((B, 1, N)), L·N for the full (B, L, N); a decay whose leading dims
  fit no one batch stride is read from a broadcast copy.  There is no
  fallback: a tensor the kernels do not take raises.
* CPU tensors go to :func:`diag_scan_plain` and :func:`diag_scan_bwd_plain`,
  the sequential loops that are the counterparts of
  ``_scan_sequential_real`` / ``_scan_sequential_pair`` and of
  ``_scan_core_real_bwd`` / ``_scan_core_pair_bwd``, and the references the
  kernels are held against.

Under the :class:`sequence_parallel` context (``ops/scan.py:105-132``),
every :func:`diag_linear_scan` runs
:func:`tlie_tpu_torch.parallel.sp.sp_diag_linear_scan` over the context's
time shard instead: each rank scans its own steps through this function's
kernels and takes its carry from the others.  The linear and softmax
attention, the causal convolution, the position table and the pooling over
time read the same context (:func:`sp_shard`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from ._build import LAUNCHES, CudaLibrary, check
from ._grid import to_front

Pair = Tuple[torch.Tensor, torch.Tensor]
TensorOrPair = Union[torch.Tensor, Pair]

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
DIAG_SCAN = CudaLibrary(
    "diag_scan", {"tlie_diag_scan_f32": (_P,) * 6 + (_I,) * 5 + (_C, _C, _P)}
)
DIAG_SCAN_BWD = CudaLibrary(
    "diag_scan_bwd", {"tlie_diag_scan_bwd_f32": (_P,) * 12 + (_I,) * 5 + (_C, _C, _P)}
)
LAUNCHES.setdefault("diag_scan", 0)
LAUNCHES.setdefault("diag_scan_bwd", 0)
_LANES = 16  # channels per block in the forward and backward kernels
_MAX_BLOCKS = 2**31 - 1


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2


def _as_pair(x: TensorOrPair) -> Pair:
    return x if _is_pair(x) else (x, torch.zeros_like(x))


def _planes(x: TensorOrPair) -> tuple:
    return tuple(x) if _is_pair(x) else (x,)


def _on_cuda(t: torch.Tensor) -> bool:
    """The routing decision: the kernel for CUDA tensors, the plain loop for
    CPU tensors, nothing else."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"diag_linear_scan runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


# the sequence-parallel route's time shard while a ``sequence_parallel``
# context is active (tlie_tpu's ``_SP_STATE``), else None
_SP_STATE = None


class sequence_parallel:
    """Context manager: route the time-mixing ops over a time shard (a
    :class:`~tlie_tpu_torch.parallel.mesh.Shard` with ``axis`` 1), as
    ``tlie_tpu``'s ``sequence_parallel(mesh)`` does (``ops/scan.py:105-132``).

    >>> with sequence_parallel(shard):
    ...     logits = model(x_steps)   # x_steps: this rank's time steps
    """

    def __init__(self, shard):
        self.state = shard
        self._prev = None

    def __enter__(self):
        global _SP_STATE
        self._prev = _SP_STATE
        _SP_STATE = self.state
        return self

    def __exit__(self, *exc):
        global _SP_STATE
        _SP_STATE = self._prev
        return False


def sp_shard():
    """The active :class:`sequence_parallel` context's shard, or None."""
    return _SP_STATE


def diag_linear_scan(
    a: TensorOrPair, b: TensorOrPair, *, axis: int = -2, reverse: bool = False
) -> TensorOrPair:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along ``axis`` (-2),
    or of ``h_t = a_t * h_{t+1} + b_t`` with ``reverse``.

    ``a``/``b`` are real tensors or (re, im) pairs; if either is a pair the
    result is a pair.  ``a`` may have any shape that broadcasts to ``b``'s
    (..., L, N), (N,) included; its gradient comes back at that shape.
    Under a :class:`sequence_parallel` context the inputs are this rank's
    time steps and the scan spans the group
    (:func:`~tlie_tpu_torch.parallel.sp.sp_diag_linear_scan`)."""
    if _SP_STATE is not None:
        from ..parallel.sp import sp_diag_linear_scan

        return sp_diag_linear_scan(a, b, _SP_STATE, axis=axis, reverse=reverse)
    pair = _is_pair(a) or _is_pair(b)
    if pair:
        a, b = _as_pair(a), _as_pair(b)
    ref = b[0] if pair else b
    if axis not in (-2, ref.dim() - 2):
        raise ValueError(f"diag_linear_scan takes the time axis at -2, got {axis}")
    return DiagScanFn.apply(reverse, *_planes(a), *_planes(b))


class DiagScanFn(torch.autograd.Function):
    """Autograd around the scan: ``apply(reverse, *a_planes, *b_planes)``
    with one plane each (real) or two (re, im).  The kernels run for CUDA
    tensors, the plain loops for CPU tensors, forward and backward alike.
    The backward is :class:`DiagScanBwdFn`; both have a ``vmap`` rule
    (``ops/_grid.py``) that folds a stacked sweep's grid into the scan's
    batch axis, so the grid takes one launch of each kernel."""

    @staticmethod
    def forward(reverse: bool, *planes):
        a, b = _operands(planes, 2)
        scan = diag_scan_cuda if _on_cuda(planes[-1]) else diag_scan_plain
        return scan(a, b, reverse=reverse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        reverse, *planes = inputs
        k = len(planes) // 2
        ctx.reverse, ctx.b_shape = reverse, planes[k].shape
        ctx.save_for_backward(*planes[:k], *_planes(output))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        k = len(saved) // 2
        out = DiagScanBwdFn.apply(ctx.reverse, *saved, *(g.contiguous() for g in grads))
        db = tuple(_sum_to(x, ctx.b_shape) for x in out[k:])  # b may broadcast too
        return (None, *out[:k], *db)

    @staticmethod
    def vmap(info, in_dims, reverse, *planes):
        k = len(planes) // 2
        a, b = _grid_planes(info.batch_size, planes[:k], in_dims[1:k + 1], planes[k:],
                            in_dims[k + 1:])
        h = DiagScanFn.apply(reverse, *a, *b)
        return h, (0, 0) if k == 2 else 0


class DiagScanBwdFn(torch.autograd.Function):
    """The scan's backward as a Function of its own, ``apply(reverse,
    *a_planes, *h_planes, *g_planes) -> (*da_planes, *db_planes)`` with
    ``da`` at ``a``'s shape: :func:`diag_scan_bwd_cuda` for CUDA tensors,
    :func:`diag_scan_bwd_plain` for CPU tensors.  Its ``vmap`` rule folds
    the grid as :class:`DiagScanFn`'s does and sums ``da`` per point."""

    @staticmethod
    def forward(reverse: bool, *planes):
        a, h, g = _operands(planes, 3)
        bwd = diag_scan_bwd_cuda if _on_cuda(planes[-1]) else diag_scan_bwd_plain
        da, db = bwd(a, h, g, reverse=reverse)
        return (*_planes(da), *_planes(db))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the scan's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, reverse, *planes):
        k = len(planes) // 3
        G = info.batch_size
        a, hg = _grid_planes(G, planes[:k], in_dims[1:k + 1], planes[k:], in_dims[k + 1:])
        out = DiagScanBwdFn.apply(reverse, *a, *hg)
        # da at the folded a's (G, 1, ..., *a_shape): summed over each point's
        # own batch, never across points
        da = tuple(x.reshape(G, *_point_shape(p, d))
                   for x, p, d in zip(out[:k], planes[:k], in_dims[1:k + 1]))
        return (*da, *out[k:]), (0,) * len(out)


def _operands(planes, n: int) -> tuple:
    """``apply``'s planes as its ``n`` operands, each a tensor (real) or a
    (re, im) pair."""
    k = len(planes) // n
    return tuple(planes[i * k:(i + 1) * k] if k == 2 else planes[i] for i in range(n))


def _point_shape(x: torch.Tensor, bdim) -> tuple:
    """One grid point's shape of a plane vmap holds with grid dim ``bdim``."""
    return tuple(x.shape) if bdim is None else tuple(s for i, s in enumerate(x.shape)
                                                      if i != bdim)


def _grid_planes(G: int, a_planes, a_dims, rest, rest_dims):
    """The operands of one launch for the whole grid of G points: each of
    ``rest`` (b, or h and g: per point (..., L, N)) with the grid at dim 0,
    contiguous (G, ..., L, N), and each a plane (per point any shape that
    broadcasts to them: the LRU's and S5's (N,) decay of each point, or
    Mamba-1's (B, L, N)) as a contiguous (G, 1, ..., 1, *a_shape) of the
    same rank, which the launchers read at its batch stride or from a
    broadcast copy.  An operand the grid shares is expanded over it."""
    rest = tuple(to_front(x, d, G).contiguous() for x, d in zip(rest, rest_dims))
    rank = rest[0].dim()
    folded = []
    for x, d in zip(a_planes, a_dims):
        x = to_front(x, d, G)
        folded.append(x.reshape(G, *(1,) * (rank - x.dim()), *x.shape[1:]).contiguous())
    return tuple(folded), rest


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


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x_{t+k}`` along dim -2 (k = ±1), zero where t+k falls outside."""
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    if k > 0:
        out[..., :-k, :] = x[..., k:, :]
    else:
        out[..., -k:, :] = x[..., :k, :]
    return out


def _sum_to(x: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sum ``x`` over the axes along which ``shape`` was broadcast to it."""
    lead = x.dim() - len(shape)
    dims = list(range(lead)) + [
        lead + i for i, s in enumerate(shape) if s == 1 and x.shape[lead + i] != 1
    ]
    return (x.sum(dims, keepdim=True) if dims else x).reshape(shape)


def diag_scan_bwd_plain(a: TensorOrPair, h: TensorOrPair, g: TensorOrPair,
                        reverse: bool = False):
    """Sequential reference of the backward: ``(da, db)`` for the cotangent
    ``g`` on ``h = diag_scan_plain(a, b, reverse)``, with ``da`` summed to
    ``a``'s shape.  It walks time one step at a time, as
    ``_scan_core_pair_bwd`` does after its flips: the scan of
    ``conj(a_{t+1})`` over ``g`` in the other direction gives ``d = db``,
    then ``da_t = d_t * conj(h_{t-1})``."""
    pair = _is_pair(g)
    shape = _planes(g)[0].shape
    step = -1 if reverse else 1  # the physical offset of the logical next step
    a_next = [_shift(torch.broadcast_to(p, shape), step) for p in _planes(a)]
    h_prev = [_shift(p, -step) for p in _planes(h)]
    if pair:
        d = diag_scan_plain((a_next[0], -a_next[1]), g, reverse=not reverse)
        da = (d[0] * h_prev[0] + d[1] * h_prev[1], d[1] * h_prev[0] - d[0] * h_prev[1])
        return tuple(_sum_to(x, p.shape) for x, p in zip(da, a)), d
    d = diag_scan_plain(a_next[0], g, reverse=not reverse)
    return _sum_to(d * h_prev[0], a.shape), d


def _a_strides(a: torch.Tensor, shape: torch.Size) -> Optional[Tuple[int, int]]:
    """(batch, time) element strides at which the kernel reads ``a`` broadcast
    to ``shape`` (leading dims flattened into one batch axis): batch stride 0
    for a decay shared across the batch, N for a per-example decay constant
    in time ((B, 1, N) against (B, L, N)), L·N for the full contiguous
    (B, L, N).  None where the leading dims of ``a`` cannot be read at one
    batch stride; the launchers then read a broadcast copy."""
    full = torch.broadcast_to(a, shape)  # raises if a does not broadcast
    L, N = shape[-2], shape[-1]
    if N > 1 and full.stride(-1) != 1:
        return None
    t_stride = full.stride(-2) if L > 1 else 0
    if all(s == 1 for s in a.shape[:-2]):
        return 0, t_stride
    if tuple(a.shape[:-2]) == tuple(shape[:-2]) and a.is_contiguous():
        return a.shape[-2] * N, t_stride
    return None


def _check_cuda_f32(tensors, what: str, ref: torch.Tensor) -> None:
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{what} takes CUDA tensors only")
        if t.device != ref.device:
            raise ValueError(f"{what}: operands on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")


def _check_planes(planes, what: str) -> Tuple[torch.Size, int, int, int]:
    """Shape checks shared by the launchers: contiguous planes of one
    (..., L, N) shape, within the grid of blocks of ``_LANES`` channels;
    returns (shape, batch, L, N)."""
    ref = planes[0]
    if ref.dim() < 2:
        raise ValueError(f"{what}: operands must be (..., L, N)")
    for t in planes:
        if t.shape != ref.shape or not t.is_contiguous():
            raise ValueError(f"{what}: planes must share a contiguous shape")
    L, N = ref.shape[-2], ref.shape[-1]
    batch = math.prod(ref.shape[:-2])
    if batch * -(-N // _LANES) > _MAX_BLOCKS:
        raise ValueError(f"{what}: shape {tuple(ref.shape)} needs too many blocks")
    return ref.shape, batch, L, N


def _a_layout(a_planes, shape, what: str) -> Tuple[tuple, int, int]:
    """(a planes as the kernel reads them, batch stride, time stride): the
    planes themselves, or, where :func:`_a_strides` cannot read them at one
    batch stride, contiguous copies broadcast over the leading dims of
    ``shape`` (time and channels kept as ``a`` has them)."""
    if len(a_planes) == 2 and (a_planes[1].shape != a_planes[0].shape
                               or a_planes[1].stride() != a_planes[0].stride()):
        raise ValueError(f"{what}: a planes must share shape and strides")
    strides = _a_strides(a_planes[0], shape)
    if strides is None:
        a = a_planes[0]
        time = a.shape[-2] if a.dim() >= 2 else 1
        full = torch.Size((*shape[:-2], time, shape[-1]))
        a_planes = tuple(torch.broadcast_to(p, full).contiguous() for p in a_planes)
        strides = _a_strides(a_planes[0], shape)
    return (a_planes, *strides)


def diag_scan_cuda(a: TensorOrPair, b: TensorOrPair, reverse: bool = False) -> TensorOrPair:
    """Launch ``csrc/diag_scan.cu`` on the current stream: float32 CUDA
    tensors, ``b`` contiguous (..., L, N), ``a`` broadcasting to it;
    ``reverse`` scans right to left.  Raises on anything else; never
    computes the result another way."""
    pair = _is_pair(b)
    a_planes, b_planes = _planes(a), _planes(b)
    ref = b_planes[0]
    _check_cuda_f32(a_planes + b_planes, "diag_scan_cuda", ref)
    shape, batch, L, N = _check_planes(b_planes, "diag_scan_cuda")
    a_planes, a_bstride, a_tstride = _a_layout(a_planes, shape, "diag_scan_cuda")

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
            batch, L, N, a_bstride, a_tstride, int(pair), int(reverse), stream,
        )
    check(err, "diag_scan")
    LAUNCHES["diag_scan"] += 1
    return h_planes if pair else h_planes[0]


def diag_scan_bwd_cuda(a: TensorOrPair, h: TensorOrPair, g: TensorOrPair,
                       reverse: bool = False):
    """Launch ``csrc/diag_scan_bwd.cu`` on the current stream: ``(da, db)``
    for the cotangent ``g`` on ``h = diag_scan_cuda(a, b, reverse)``, with
    ``da`` at ``a``'s shape.  ``h`` and ``g`` are float32 CUDA tensors of one
    contiguous (..., L, N) shape, ``a`` as the forward took it.  Raises on
    anything else; never computes the result another way."""
    pair = _is_pair(g)
    a_planes, h_planes, g_planes = _planes(a), _planes(h), _planes(g)
    ref = g_planes[0]
    _check_cuda_f32(a_planes + h_planes + g_planes, "diag_scan_bwd_cuda", ref)
    if len(a_planes) != len(g_planes) or len(h_planes) != len(g_planes):
        raise ValueError("diag_scan_bwd_cuda: a, h and g must all be pairs or all real")
    shape, batch, L, N = _check_planes(h_planes + g_planes, "diag_scan_bwd_cuda")
    read, a_bstride, a_tstride = _a_layout(a_planes, shape, "diag_scan_bwd_cuda")

    d_planes = tuple(torch.empty_like(ref) for _ in g_planes)
    # da at a's reduced shape (see the C entry); per-row partials where the
    # batch is summed in a second launch
    rows = batch if a_bstride else 1
    per_row = (L if a_tstride else 1) * N
    da_planes = tuple(torch.empty(rows, per_row, device=ref.device) for _ in g_planes)
    reduce = a_bstride == 0 and batch > 1
    part = tuple(torch.empty(batch, per_row, device=ref.device) for _ in g_planes) \
        if reduce else da_planes
    if ref.numel() == 0:
        da_planes = tuple(torch.zeros_like(p) for p in da_planes)
    else:
        fn = DIAG_SCAN_BWD.fn("tlie_diag_scan_bwd_f32")
        with torch.cuda.device(ref.device):
            stream = torch.cuda.current_stream(ref.device).cuda_stream
            err = fn(
                read[0].data_ptr(), read[1].data_ptr() if pair else None,
                h_planes[0].data_ptr(), h_planes[1].data_ptr() if pair else None,
                g_planes[0].data_ptr(), g_planes[1].data_ptr() if pair else None,
                d_planes[0].data_ptr(), d_planes[1].data_ptr() if pair else None,
                part[0].data_ptr(), part[1].data_ptr() if pair else None,
                da_planes[0].data_ptr(), da_planes[1].data_ptr() if pair else None,
                batch, L, N, a_bstride, a_tstride, int(pair), int(reverse), stream,
            )
        check(err, "diag_scan_bwd")
        LAUNCHES["diag_scan_bwd"] += 1
    # at the shape the kernel read a at, summed over a copy's broadcast dims
    da = tuple(_sum_to(x.reshape(r.shape), p.shape) for x, r, p in zip(da_planes, read, a_planes))
    if pair:
        return da, d_planes
    return da[0], d_planes[0]
