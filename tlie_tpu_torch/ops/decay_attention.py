"""SSD intra-chunk decay attention, counterpart of
``tlie_tpu/ops/pallas_ssd.py::decay_attention``::

    y[bg,h,i] = Σ_{j≤i} (C_i · B_j) · exp(cs[h,i] − cs[h,j]) · xdt[bg,h,j]

C, B: (BG, Q, N), shared by the Hg heads of a group; cs: (BG, Hg, Q)
float32, the within-chunk cumsum of dt·A; xdt and y: (BG, Hg, Q, P).
:class:`DecayAttentionFn` is its ``torch.autograd.Function`` (the
reference's ``jax.custom_vjp``): the i-indexed backward gives dC and +dcs_i,
the j-indexed one dB, dxdt and −dcs_j, and ``dcs = dcs_i + dcs_j``.

Where the work runs follows the tensors:

* CUDA tensors go to three kernels (:func:`decay_attention_fwd_cuda`,
  :func:`decay_attention_bwd_i_cuda`, :func:`decay_attention_bwd_j_cuda`),
  which replace the reference's three Pallas kernels; the (Q, Q) scores
  never reach device memory.  On float32 operands all three are
  ``csrc/decay_attention.cu``'s, each product three TF32 products of a
  split operand (float32 accuracy); on bfloat16 operands all three are
  ``csrc/decay_attention_bf16.cu``'s (bfloat16 tiles in shared memory,
  landed by 16-byte ``cp.async`` where the shapes and pointers allow it,
  else by ordinary loads, see :func:`load_route`), each product one
  bfloat16 product.  There is no fallback: a tensor they
  do not take raises.
* CPU tensors go to :func:`decay_attention_plain`,
  :func:`decay_attention_bwd_i_plain` and :func:`decay_attention_bwd_j_plain`:
  the materialised form of
  ``tlie_tpu/ops/ssd.py:212-223``, with the segment sums masked to −inf
  *before* the exp (an entry above the diagonal may have cs_i − cs_j > 88,
  whose exp overflows), and its gradient written out.  They are also what the
  kernels are held against on the card.

Float32 or bfloat16 operands, and on the CPU also float64 (the plain
version, for references).  C, B, xdt and the cotangent share one dtype; cs
is float32 beside float32 or bfloat16 operands (float64 beside float64).
On bfloat16 operands (``model.compute_dtype: bfloat16``) the kernels
``tlie_decay_attention_*_bf16`` and the plain version compute what
``tlie_tpu``'s Pallas kernels compute on them: C·B accumulated in float32,
the score C·B·decay rounded to bfloat16 before its product with xdt (and
dy), dS = dy·xdtᵀ and both halves of dcs in float32, the sum over heads of
dS·decay rounded to bfloat16 before its products with B and C, and y, dC, dB
and dxdt rounded to bfloat16 from their float32 sums; dcs comes back in
float32.  Their launches count under ``decay_attention_*_bf16``, and also
under their load route in :data:`LOAD_ROUTES`.
C and B may be views with any batch and row strides (the SSD
slices them out of the conv output, and the kernels read them in place);
their last dimension, and all of cs, xdt and the cotangent, must be
contiguous.  Anything else raises, on every device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ._build import LAUNCHES, CudaLibrary, check
from ._grid import fold, unfold

_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = {"fwd": (_P,) * 5 + (_I,) * 9 + (_P,), "bwd_i": (_P,) * 7 + (_I,) * 9 + (_P,),
         "bwd_j": (_P,) * 8 + (_I,) * 9 + (_P,)}
# the entry points of each operand dtype, and the suffix of their names and counts
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
DECAY_ATTENTION = CudaLibrary("decay_attention", {
    f"tlie_decay_attention_{k}_f32": args for k, args in _ARGS.items()})
DECAY_ATTENTION_BF16 = CudaLibrary("decay_attention_bf16", {
    f"tlie_decay_attention_{k}_bf16": args for k, args in _ARGS.items()})
for _k in _ARGS:
    LAUNCHES.setdefault(f"decay_attention_{_k}", 0)
    LAUNCHES.setdefault(f"decay_attention_{_k}_bf16", 0)
# Launches of the bfloat16 kernels by how their tiles land,
# "<launch name>:<route>" (see load_route); each wrapper adds one where it
# launches, beside its LAUNCHES count.
LOAD_ROUTES: Dict[str, int] = {}


def launch_name(kernel: str, dtype: torch.dtype) -> str:
    """The count a launch of ``kernel`` (``fwd``, ``bwd_i``, ``bwd_j``) on
    operands of ``dtype`` adds to: ``decay_attention_fwd`` for float32,
    ``decay_attention_fwd_bf16`` for bfloat16."""
    return f"decay_attention_{kernel}" + ("_bf16" if dtype == torch.bfloat16 else "")


def decay_attention(Cm: torch.Tensor, Bm: torch.Tensor, cs: torch.Tensor,
                    xdt: torch.Tensor) -> torch.Tensor:
    """y (BG, Hg, Q, P), differentiable in all four inputs."""
    _check_operands(Cm, Bm, cs, xdt)
    return DecayAttentionFn.apply(Cm, Bm, cs, xdt)


def _check_operands(Cm, Bm, cs, xdt, dy=None) -> None:
    """The contract on every device (see the module docstring)."""
    named = [("C", Cm), ("B", Bm), ("cs", cs), ("xdt", xdt)]
    if dy is not None:
        named.append(("dy", dy))
    if xdt.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decay_attention runs on cuda or cpu, not {xdt.device}")
    dtypes = (torch.float32, torch.bfloat16) + ((torch.float64,) if xdt.device.type == "cpu"
                                                else ())
    cs_dtype = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    for name, t in named:
        want = cs_dtype if name == "cs" else xdt.dtype
        if t.dtype != want or xdt.dtype not in dtypes:
            raise TypeError(f"decay_attention takes {' or '.join(map(str, dtypes))} operands of "
                            f"one dtype on {xdt.device.type}, cs in float32 (float64 beside "
                            f"float64); {name} is {t.dtype} beside xdt's {xdt.dtype}")
        if t.device != xdt.device:
            raise ValueError("decay_attention: operands on different devices")
    if Cm.dim() != 3 or Bm.dim() != 3 or cs.dim() != 3 or xdt.dim() != 4:
        raise ValueError("decay_attention takes C, B (BG, Q, N), cs (BG, Hg, Q), "
                         "xdt (BG, Hg, Q, P)")
    BG, Hg, Q, P = xdt.shape
    N = Cm.shape[2]
    if Cm.shape != (BG, Q, N) or Bm.shape != (BG, Q, N) or cs.shape != (BG, Hg, Q):
        raise ValueError(f"shapes C {tuple(Cm.shape)}, B {tuple(Bm.shape)}, cs {tuple(cs.shape)}, "
                         f"xdt {tuple(xdt.shape)} do not agree")
    if dy is not None and dy.shape != xdt.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have xdt's shape {tuple(xdt.shape)}")
    for name, t in (("C", Cm), ("B", Bm)):
        if N > 1 and t.stride(2) != 1:
            raise ValueError(f"decay_attention: {name}'s last dimension must be contiguous")
    for name, t in named[2:]:
        if not t.is_contiguous():
            raise ValueError(f"decay_attention takes a contiguous {name}")


def _on_cuda(t: torch.Tensor) -> bool:
    """The routing decision: the kernels for CUDA tensors, the plain
    versions for CPU tensors (``_check_operands`` refuses any other)."""
    return t.device.type == "cuda"


class DecayAttentionFn(torch.autograd.Function):
    """Autograd around the decay attention: the kernels for CUDA tensors,
    the plain versions for CPU tensors, forward and backward alike.  Saves
    the four inputs, as the reference's ``_fwd`` does.  The backward is
    :class:`DecayAttentionBwdFn`; both have a ``vmap`` rule
    (``ops/_grid.py``) that folds a stacked sweep's grid into BG, so the grid
    takes one launch of each kernel (float32 and bfloat16 alike)."""

    @staticmethod
    def forward(Cm, Bm, cs, xdt):
        fwd = decay_attention_fwd_cuda if _on_cuda(xdt) else decay_attention_plain
        return fwd(Cm, Bm, cs, xdt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        return DecayAttentionBwdFn.apply(*ctx.saved_tensors, dy.contiguous())

    @staticmethod
    def vmap(info, in_dims, *operands):
        G = info.batch_size
        return unfold(DecayAttentionFn.apply(*_fold_operands(G, operands, in_dims)), G), 0


class DecayAttentionBwdFn(torch.autograd.Function):
    """The decay attention's backward as a Function of its own,
    ``apply(C, B, cs, xdt, dy) -> (dC, dB, dcs, dxdt)``: the i-indexed and
    j-indexed kernels (or plain versions), ``dcs = dcs_i + dcs_j``."""

    @staticmethod
    def forward(Cm, Bm, cs, xdt, dy):
        cuda = _on_cuda(xdt)
        bwd_i = decay_attention_bwd_i_cuda if cuda else decay_attention_bwd_i_plain
        bwd_j = decay_attention_bwd_j_cuda if cuda else decay_attention_bwd_j_plain
        dC, dcs_i = bwd_i(Cm, Bm, cs, xdt, dy)
        dB, dxdt, dcs_j = bwd_j(Cm, Bm, cs, xdt, dy)
        return dC, dB, dcs_i + dcs_j, dxdt

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the decay attention's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, *operands):
        G = info.batch_size
        out = DecayAttentionBwdFn.apply(*_fold_operands(G, operands, in_dims))
        return tuple(unfold(x, G) for x in out), (0,) * 4


def _fold_operands(G: int, operands, in_dims):
    """C and B (views, their last dim contiguous) and cs, xdt (and dy)
    contiguous, each with the grid of G points folded into BG."""
    folded = [fold(t, d, G) for t, d in zip(operands, in_dims)]
    return (*folded[:2], *(t.contiguous() for t in folded[2:]))


# -- plain versions -------------------------------------------------------------


def _decay(cs: torch.Tensor) -> torch.Tensor:
    """exp(cs_i − cs_j) on and below the diagonal, 0 above: (BG, Hg, Q, Q).
    The mask goes on the segment sum before the exp, so no overflowed exp
    is ever multiplied by 0 (which would send NaN into a gradient)."""
    Q = cs.shape[-1]
    seg = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(seg.masked_fill(~causal, float("-inf")))


def _wide(*ts):
    """The tensors in the precision their products are taken in: bfloat16
    operands as float32 (every product of two bfloat16 values is exact in
    float32, summed in float32 as the tensor cores sum them), others as
    they are."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)


def _round_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even) and widened back where
    ``like`` is bfloat16, the points where the Pallas kernels cast to the
    operand dtype; unchanged otherwise."""
    return t.to(torch.bfloat16).float() if like.dtype == torch.bfloat16 else t


def decay_attention_plain(Cm, Bm, cs, xdt) -> torch.Tensor:
    """The materialised scores (CB ⊙ decay) times xdt, y in xdt's dtype."""
    C, B, x = _wide(Cm, Bm, xdt)
    cb = C @ B.transpose(1, 2)  # (BG, Q_i, Q_j), group-level
    return (_round_as(cb[:, None] * _decay(cs), xdt) @ x).to(xdt.dtype)


def _dscores(Cm, Bm, cs, xdt, dy):
    """(CB, decay, dS ⊙ decay) with dS = dy xdtᵀ, materialised, in the
    products' precision."""
    C, B, x, g = _wide(Cm, Bm, xdt, dy)
    cb = C @ B.transpose(1, 2)
    decay = _decay(cs)
    return cb, decay, (g @ x.transpose(2, 3)) * decay


def decay_attention_bwd_i_plain(Cm, Bm, cs, xdt, dy):
    """(dC, dcs_i), as the i-indexed kernel: dCB = Σ_h dS ⊙ decay, dC =
    dCB B, dcs_i = Σ_j dS ⊙ decay ⊙ CB."""
    cb, _, dsd = _dscores(Cm, Bm, cs, xdt, dy)
    (B,) = _wide(Bm)
    dC = _round_as(dsd.sum(1), Bm) @ B
    return dC.to(Cm.dtype), (dsd * cb[:, None]).sum(-1)


def decay_attention_bwd_j_plain(Cm, Bm, cs, xdt, dy):
    """(dB, dxdt, dcs_j), as the j-indexed kernel: dB = dCBᵀ C, dxdt =
    (CB ⊙ decay)ᵀ dy, dcs_j = −Σ_i dS ⊙ decay ⊙ CB."""
    cb, decay, dsd = _dscores(Cm, Bm, cs, xdt, dy)
    C, g = _wide(Cm, dy)
    dxdt = _round_as(cb[:, None] * decay, xdt).transpose(2, 3) @ g
    dB = _round_as(dsd.sum(1), Cm).transpose(1, 2) @ C
    return dB.to(Bm.dtype), dxdt.to(xdt.dtype), -(dsd * cb[:, None]).sum(-2)


def decay_attention_bwd_plain(Cm, Bm, cs, xdt, dy):
    """(dC, dcs_i, dB, dxdt, dcs_j) for the cotangent ``dy`` on y; the
    gradient of cs is dcs_i + dcs_j."""
    return decay_attention_bwd_i_plain(Cm, Bm, cs, xdt, dy) + decay_attention_bwd_j_plain(
        Cm, Bm, cs, xdt, dy)


def term_scales(Cm, Bm, cs, xdt, dy):
    """Σ|terms| of every output element, the scale to which float32
    rounding of its sums is held: the plain forward and backward on |C|,
    |B|, |xdt| and |dy| (the decay is positive), each term's own inner
    product (C·B over N, dy·xdt over P) counted by its magnitudes.
    Returns (y, dC, dcs_i, dB, dxdt, dcs_j) scales."""
    a, b, x, g = _wide(Cm.abs(), Bm.abs(), xdt.abs(), dy.abs())
    dC, dcs_i, dB, dxdt, dcs_j = decay_attention_bwd_plain(a, b, cs, x, g)
    return decay_attention_plain(a, b, cs, x), dC, dcs_i, dB, dxdt, -dcs_j


# -- the kernels ------------------------------------------------------------------


def _cuda_args(what, Cm, Bm, cs, xdt, dy=None):
    _check_operands(Cm, Bm, cs, xdt, dy)
    for t in (Cm, Bm, cs, xdt) + ((dy,) if dy is not None else ()):
        if t.device.type != "cuda":
            raise ValueError(f"{what} takes CUDA tensors only")
    BG, Hg, Q, P = xdt.shape
    N = Cm.shape[2]
    dims = (BG, Q, N, Hg, P, Cm.stride(0), Cm.stride(1), Bm.stride(0), Bm.stride(1))
    return xdt.device, dims, xdt.numel() == 0 or N == 0


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _library(kernel: str, dtype: torch.dtype) -> CudaLibrary:
    """The library that holds ``kernel`` on operands of ``dtype``."""
    return DECAY_ATTENTION_BF16 if dtype == torch.bfloat16 else DECAY_ATTENTION


def _entry(kernel: str, dtype: torch.dtype):
    return _library(kernel, dtype).fn(f"tlie_decay_attention_{kernel}_{_SUFFIX[dtype]}")


def load_route(Cm, Bm, xdt, dy=None) -> str:
    """How ``csrc/decay_attention_bf16.cu`` lands these bfloat16 operands in
    shared memory, by its ``vec_tiles``: ``cp.async16`` (16-byte
    ``cp.async``) where N, P and C's and B's batch and row strides are
    multiples of 8 elements and the bases of C, B, xdt (and dy) 16-byte
    aligned, else ``ordinary`` (ordinary loads, for every tile)."""
    strides = (*Cm.stride()[:2], *Bm.stride()[:2])
    ptrs = Cm.data_ptr() | Bm.data_ptr() | xdt.data_ptr() | (dy.data_ptr() if dy is not None
                                                             else 0)
    vec = (Cm.shape[2] % 8 == 0 and xdt.shape[3] % 8 == 0 and all(s % 8 == 0 for s in strides)
           and ptrs % 16 == 0)
    return "cp.async16" if vec else "ordinary"


def _count(kernel: str, dtype: torch.dtype, *operands) -> None:
    """Add one launch of ``kernel`` on ``dtype`` operands to LAUNCHES and,
    on bfloat16 operands, to LOAD_ROUTES."""
    name = launch_name(kernel, dtype)
    LAUNCHES[name] += 1
    if dtype == torch.bfloat16:
        key = f"{name}:{load_route(*operands)}"
        LOAD_ROUTES[key] = LOAD_ROUTES.get(key, 0) + 1


def decay_attention_fwd_cuda(Cm, Bm, cs, xdt) -> torch.Tensor:
    """Launch the forward for the operands' dtype (``csrc/decay_attention.cu``
    on float32, ``csrc/decay_attention_bf16.cu`` on bfloat16): y, as
    :func:`decay_attention_plain`."""
    dev, dims, empty = _cuda_args("decay_attention_fwd_cuda", Cm, Bm, cs, xdt)
    y = torch.empty_like(xdt)
    if empty:
        return y.zero_()
    fn = _entry("fwd", xdt.dtype)
    with torch.cuda.device(dev):
        err = fn(Cm.data_ptr(), Bm.data_ptr(), cs.data_ptr(), xdt.data_ptr(), y.data_ptr(),
                 *dims, _stream(dev))
    check(err, launch_name("fwd", xdt.dtype))
    _count("fwd", xdt.dtype, Cm, Bm, xdt)
    return y


def decay_attention_bwd_i_cuda(Cm, Bm, cs, xdt, dy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the i-indexed backward for the operands' dtype
    (``csrc/decay_attention.cu`` on float32, ``csrc/decay_attention_bf16.cu``
    on bfloat16): (dC, dcs_i), as :func:`decay_attention_bwd_plain`; dC is
    contiguous (BG, Q, N)."""
    dev, dims, empty = _cuda_args("decay_attention_bwd_i_cuda", Cm, Bm, cs, xdt, dy)
    dC = torch.empty(Cm.shape, device=dev, dtype=Cm.dtype)
    dcs_i = torch.empty_like(cs)
    if empty:
        return dC.zero_(), dcs_i.zero_()
    fn = _entry("bwd_i", xdt.dtype)
    with torch.cuda.device(dev):
        err = fn(Cm.data_ptr(), Bm.data_ptr(), cs.data_ptr(), xdt.data_ptr(), dy.data_ptr(),
                 dC.data_ptr(), dcs_i.data_ptr(), *dims, _stream(dev))
    check(err, launch_name("bwd_i", xdt.dtype))
    _count("bwd_i", xdt.dtype, Cm, Bm, xdt, dy)
    return dC, dcs_i


def decay_attention_bwd_j_cuda(Cm, Bm, cs, xdt, dy):
    """Launch the j-indexed backward for the operands' dtype
    (``csrc/decay_attention.cu`` on float32, ``csrc/decay_attention_bf16.cu``
    on bfloat16): (dB, dxdt, dcs_j), as :func:`decay_attention_bwd_plain`;
    dB is contiguous (BG, Q, N)."""
    dev, dims, empty = _cuda_args("decay_attention_bwd_j_cuda", Cm, Bm, cs, xdt, dy)
    dB = torch.empty(Bm.shape, device=dev, dtype=Bm.dtype)
    dxdt = torch.empty_like(xdt)
    dcs_j = torch.empty_like(cs)
    if empty:
        return dB.zero_(), dxdt.zero_(), dcs_j.zero_()
    fn = _entry("bwd_j", xdt.dtype)
    with torch.cuda.device(dev):
        err = fn(Cm.data_ptr(), Bm.data_ptr(), cs.data_ptr(), xdt.data_ptr(), dy.data_ptr(),
                 dB.data_ptr(), dxdt.data_ptr(), dcs_j.data_ptr(), *dims, _stream(dev))
    check(err, launch_name("bwd_j", xdt.dtype))
    _count("bwd_j", xdt.dtype, Cm, Bm, xdt, dy)
    return dB, dxdt, dcs_j
