"""Causal softmax attention, counterpart of ``tlie_tpu/ops/attention.py``::

    o[b,i,h] = Σ_{j≤i} softmax_j(scale · q[b,i,h] · k[b,j,h]) · v[b,j,h]

q, k, v and o are (B, L, H, D) with one head dim D for all three (the
kernels' and the reference's flash-eligibility rule, ``:38``), ``scale``
1/√D by default.  :class:`FlashAttentionFn` is the ``torch.autograd.Function``
around it (the ``custom_vjp`` of JAX's Pallas flash kernel): its forward
saves the per-row log-sum-exp lse (B, H, L) float32 as the residual; its
backward computes di = rowsum(o ⊙ do), then dK/dV, then dQ, as
``_flash_attention_bwd`` does.

Where the work runs follows the tensors:

* CUDA tensors go to the three kernels of ``csrc/flash_attention.cu``
  (:func:`flash_attention_fwd_cuda`, :func:`flash_attention_bwd_dkv_cuda`,
  :func:`flash_attention_bwd_dq_cuda`), which replace the three Pallas
  kernels that ``_pallas_flash_attention`` (``:49``) reaches; the (L, L)
  scores never reach device memory.  There is no fallback: a tensor they do
  not take raises.
* CPU tensors go to :func:`flash_attention_plain`,
  :func:`flash_attention_bwd_dkv_plain` and :func:`flash_attention_bwd_dq_plain`:
  the materialised form of ``_xla_causal_attention`` (``:20``), masked with
  −1e30 and normalised in float32, and its gradient written out from the
  saved lse.  They are also what the kernels are held against on the card.

``impl="xla"`` is :func:`xla_causal_attention`, the materialised form under
autograd, on any device: it is what ``MHA`` runs when a config sets
``use_flash: false`` or its head dims differ, a choice of the config and not
a fallback.  Under the ``sequence_parallel`` context of :mod:`.scan`,
:func:`causal_softmax_attention` runs
:func:`tlie_tpu_torch.parallel.ring.ring_causal_attention` on this rank's
time steps whatever ``impl`` says (``attention.py:85-97``).

Float32, and on the CPU also float64 (the plain version, for references).
q, k and v may be views with any batch, row and head strides (``MHA`` splits
them out of the ``Wqkv`` projection and the kernels read them in place);
their last dimension must be contiguous.  D ≤ 128.  Anything else raises, on
every device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._build import LAUNCHES, CudaLibrary, check
from ._grid import fold, unfold
from .scan import sp_shard

MAX_HEAD_DIM = 128  # the kernels hold two 64-wide column tiles of D
F32_UNIT = 2.0 ** -24

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
FLASH_ATTENTION = CudaLibrary("flash_attention", {
    "tlie_flash_attention_fwd_f32": (_P,) * 5 + (_I,) * 13 + (_F, _P),
    "tlie_flash_attention_bwd_dkv_f32": (_P,) * 8 + (_I,) * 13 + (_F, _P),
    "tlie_flash_attention_bwd_dq_f32": (_P,) * 7 + (_I,) * 13 + (_F, _P),
})
for _name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
    LAUNCHES.setdefault(_name, 0)


def causal_softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None,
                             impl: Optional[str] = None) -> torch.Tensor:
    """o (B, L, H, D), differentiable in q, k and v.  ``impl`` None or
    ``"flash"`` takes :class:`FlashAttentionFn` (the kernels on CUDA tensors),
    ``"xla"`` the materialised form; under an active ``sequence_parallel``
    context the ring over the group, whatever ``impl`` says."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    shard = sp_shard()
    if shard is not None:
        from ..parallel.ring import ring_causal_attention

        return ring_causal_attention(q, k, v, shard, scale=scale)
    if impl in (None, "flash"):
        _check_operands(q, k, v)
        return FlashAttentionFn.apply(q, k, v, float(scale))[0]
    if impl == "xla":
        return xla_causal_attention(q, k, v, scale)
    raise ValueError(f"Unknown attention impl {impl!r}")


def _check_operands(q, k, v, do=None) -> None:
    """The contract on every device (see the module docstring)."""
    named = [("q", q), ("k", k), ("v", v)] + ([("do", do)] if do is not None else [])
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    dtypes = (torch.float32,) if q.device.type == "cuda" else (torch.float32, torch.float64)
    for name, t in named:
        if t.dtype != q.dtype or t.dtype not in dtypes:
            raise TypeError(f"flash attention takes {' or '.join(map(str, dtypes))} operands of "
                            f"one dtype on {q.device.type}; {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError("flash attention: operands on different devices")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"flash attention takes q, k, v{', do' if do is not None else ''} of "
                             f"one shape (B, L, H, D); {name} is {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"flash attention: {name}'s last dimension must be contiguous")
    if not 0 < q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes a head dim of 1 to {MAX_HEAD_DIM}, "
                         f"not {q.shape[3]}")


def _on_cuda(t: torch.Tensor) -> bool:
    """The routing decision: the kernels for CUDA tensors, the plain
    versions for CPU tensors (``_check_operands`` refuses any other)."""
    return t.device.type == "cuda"


class FlashAttentionFn(torch.autograd.Function):
    """Autograd around the flash attention: the kernels for CUDA tensors,
    the plain versions for CPU tensors, forward and backward alike.
    ``apply(q, k, v, scale) -> (o, lse)``, lse not differentiable; saves q,
    k, v, o and lse.  The backward is :class:`FlashAttentionBwdFn`; both have
    a ``vmap`` rule (``ops/_grid.py``) that folds a stacked sweep's grid into
    B, so the grid takes one launch of each kernel."""

    @staticmethod
    def forward(q, k, v, scale):
        fwd = flash_attention_fwd_cuda if _on_cuda(q) else flash_attention_plain
        return fwd(q, k, v, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = FlashAttentionBwdFn.apply(q, k, v, do, lse, attention_di(o, do), ctx.scale)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale):
        G = info.batch_size
        q, k, v = (fold(t, d, G) for t, d in zip((q, k, v), in_dims))
        o, lse = FlashAttentionFn.apply(q, k, v, scale)
        return (unfold(o, G), unfold(lse, G)), (0, 0)


class FlashAttentionBwdFn(torch.autograd.Function):
    """The flash attention's backward as a Function of its own,
    ``apply(q, k, v, do, lse, di, scale) -> (dq, dk, dv)``: the dK/dV and
    dQ kernels (or plain versions)."""

    @staticmethod
    def forward(q, k, v, do, lse, di, scale):
        cuda = _on_cuda(q)
        bwd_dkv = flash_attention_bwd_dkv_cuda if cuda else flash_attention_bwd_dkv_plain
        bwd_dq = flash_attention_bwd_dq_cuda if cuda else flash_attention_bwd_dq_plain
        dk, dv = bwd_dkv(q, k, v, do, lse, di, scale)
        return bwd_dq(q, k, v, do, lse, di, scale), dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the flash attention's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, q, k, v, do, lse, di, scale):
        G = info.batch_size
        q, k, v = (fold(t, d, G) for t, d in zip((q, k, v), in_dims))
        do, lse, di = (fold(t, d, G).contiguous() for t, d in zip((do, lse, di), in_dims[3:]))
        out = FlashAttentionBwdFn.apply(q, k, v, do, lse, di, scale)
        return tuple(unfold(x, G) for x in out), (0, 0, 0)


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o ⊙ do) as (B, H, L), contiguous: the backward's row term,
    computed outside the kernels as the reference computes it in XLA."""
    return (o * do).sum(-1).transpose(1, 2).contiguous()


# -- plain versions -------------------------------------------------------------


def _causal(L: int, device) -> torch.Tensor:
    return torch.ones(L, L, dtype=torch.bool, device=device).tril()


def _masked_scores(q, k, scale) -> torch.Tensor:
    """(B, H, L, L) scores q·(k·scale), −1e30 above the diagonal, in at
    least float32: ``_xla_causal_attention``'s."""
    s = torch.einsum("bthd,bshd->bhts", q, k * scale)
    s = s.to(torch.promote_types(s.dtype, torch.float32))
    return s.masked_fill(~_causal(q.shape[1], q.device), -1e30)


def xla_causal_attention(q, k, v, scale) -> torch.Tensor:
    """``_xla_causal_attention``: the materialised softmax attention, o only,
    differentiable by autograd (``impl="xla"``)."""
    probs = torch.softmax(_masked_scores(q, k, scale), dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def flash_attention_plain(q, k, v, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, L, H, D) contiguous, lse (B, H, L)): the materialised form of
    the forward kernel."""
    s = _masked_scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", torch.exp(s - lse[..., None]).to(v.dtype), v)
    return o.contiguous(), lse


def _probs(q, k, lse, scale) -> torch.Tensor:
    """P = exp(scale·q·k − lse) on and below the diagonal, 0 above: the
    backward's recomputed probabilities.  The mask goes on before the exp,
    so a masked logit never reaches it."""
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale - lse[..., None]
    return torch.exp(s.masked_fill(~_causal(q.shape[1], q.device), float("-inf")))


def _dscores(q, k, v, do, lse, di, scale):
    """(P, dS) with dS = P ⊙ (dO·Vᵀ − di), materialised (B, H, L, L)."""
    p = _probs(q, k, lse, scale)
    dp = torch.einsum("bthd,bshd->bhts", do, v)
    return p, p * (dp - di[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, scale):
    """(dk, dv), as the dK/dV kernel: dv = Pᵀ·dO, dk = dSᵀ·Q·scale."""
    p, ds = _dscores(q, k, v, do, lse, di, scale)
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    dk = torch.einsum("bhts,bthd->bshd", ds, q) * scale
    return dk.contiguous(), dv.contiguous()


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, scale):
    """dq, as the dQ kernel: dq = dS·K·scale."""
    _, ds = _dscores(q, k, v, do, lse, di, scale)
    return (torch.einsum("bhts,bshd->bthd", ds, k) * scale).contiguous()


def term_scales(q, k, v, do, lse, scale):
    """Σ|terms| of every output element, the scale to which float32
    rounding of its sums is held: (o, dq, dk, dv) of the plain forward and
    backward with every product taken over magnitudes (P ≥ 0; |dS| ≤
    P·(|dO|·|V|ᵀ + Σ_d |o||dO|))."""
    p = _probs(q, k, lse, scale)
    aq, ak, av, ado = q.abs(), k.abs(), v.abs(), do.abs()
    o_abs = torch.einsum("bhts,bshd->bthd", p, av)
    o = torch.einsum("bhts,bshd->bthd", p, v)
    di_abs = (o.abs() * ado).sum(-1).transpose(1, 2)
    t = p * (torch.einsum("bthd,bshd->bhts", ado, av) + di_abs[..., None])
    dq = torch.einsum("bhts,bshd->bthd", t, ak) * scale
    dk = torch.einsum("bhts,bthd->bshd", t, aq) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, ado)
    return o_abs, dq, dk, dv


def logit_rtol(q, k, scale) -> float:
    """The relative error of every P a float32 logit may bring: a logit is a
    sum of D products, rounded to about √D·u·scale·max‖q_i‖·max‖k_j‖
    (Cauchy-Schwarz), and both it and lse enter P's exponent."""
    z = scale * q.norm(dim=-1).max().item() * k.norm(dim=-1).max().item()
    return 2.0 * math.sqrt(q.shape[-1]) * F32_UNIT * z


# -- the kernels ------------------------------------------------------------------


def _cuda_args(what, q, k, v, do=None):
    _check_operands(q, k, v, do)
    for t in (q, k, v) + ((do,) if do is not None else ()):
        if t.device.type != "cuda":
            raise ValueError(f"{what} takes CUDA tensors only")
    if do is not None and not do.is_contiguous():
        raise ValueError(f"{what} takes a contiguous do")
    B, L, H, D = q.shape
    dims = (B, L, H, D) + tuple(t.stride(i) for t in (q, k, v) for i in (0, 1, 2))
    return q.device, dims, q.numel() == 0


def _rows(t: torch.Tensor, B: int, H: int, L: int, name: str) -> None:
    if t.shape != (B, H, L) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 (B, H, L) = {(B, H, L)} tensor")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention_fwd_cuda(q, k, v, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward of ``csrc/flash_attention.cu``: (o, lse), as
    :func:`flash_attention_plain`; o is contiguous (B, L, H, D)."""
    dev, dims, empty = _cuda_args("flash_attention_fwd_cuda", q, k, v)
    B, L, H, D = q.shape
    o = torch.empty(q.shape, device=dev)
    lse = torch.empty(B, H, L, device=dev)
    if empty:
        return o, lse
    fn = FLASH_ATTENTION.fn("tlie_flash_attention_fwd_f32")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 *dims, float(scale), _stream(dev))
    check(err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, di, scale):
    """Launch the dK/dV backward of ``csrc/flash_attention.cu``: (dk, dv), as
    :func:`flash_attention_bwd_dkv_plain`, contiguous (B, L, H, D)."""
    dev, dims, empty = _cuda_args("flash_attention_bwd_dkv_cuda", q, k, v, do)
    B, L, H, _ = q.shape
    _rows(lse, B, H, L, "lse")
    _rows(di, B, H, L, "di")
    dk = torch.empty(q.shape, device=dev)
    dv = torch.empty(q.shape, device=dev)
    if empty:
        return dk, dv
    fn = FLASH_ATTENTION.fn("tlie_flash_attention_bwd_dkv_f32")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims, float(scale), _stream(dev))
    check(err, "flash_attention_bwd_dkv")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, di, scale) -> torch.Tensor:
    """Launch the dQ backward of ``csrc/flash_attention.cu``: dq, as
    :func:`flash_attention_bwd_dq_plain`, contiguous (B, L, H, D)."""
    dev, dims, empty = _cuda_args("flash_attention_bwd_dq_cuda", q, k, v, do)
    B, L, H, _ = q.shape
    _rows(lse, B, H, L, "lse")
    _rows(di, B, H, L, "di")
    dq = torch.empty(q.shape, device=dev)
    if empty:
        return dq
    fn = FLASH_ATTENTION.fn("tlie_flash_attention_bwd_dq_f32")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 di.data_ptr(), dq.data_ptr(), *dims, float(scale), _stream(dev))
    check(err, "flash_attention_bwd_dq")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq
