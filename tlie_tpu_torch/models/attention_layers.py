"""Multi-head attention mixers, counterparts of
``tlie_tpu/models/attention_layers.py``: ``MHA`` (``:73-150``), softmax or
linear, and ``MHNA`` (``:153-232``), norm attention.

``MHA``'s ``Wqkv`` projects to [q | k | v] (2·d_qk + d_model wide, the
reference's fused layout, which eigen-analysis reads back), an optional
depthwise causal conv with SiLU runs over all of it (``conv_type: full``) or
over [q | k] alone, and the heads are split as views of the projection.
Softmax attention upcasts them to float32 and goes through
:func:`tlie_tpu_torch.ops.attention.causal_softmax_attention` (on the card:
the three flash kernels, which read q, k and v through their strides).
Linear attention (``lin_att``, ``attention_fn: lin-attention``) takes the
elu+1 features of q and k and divides the numerator of one
:func:`tlie_tpu_torch.ops.linear_attention.chunked_linear_attention` by the
normaliser n_t = q_t·Σ_{s≤t} k_s it returns beside it.

``MHNA`` projects through ``Wvqkn`` to [v | q | k | n] (d_model + 2·d_qk +
num_heads wide), runs the conv over [v | q | k] (``full``) or [q | k],
takes ``approx_fn`` features of q and k, scales k by 1/√head_dim where
``scale_B`` is set, runs the chunked linear attention without a normaliser,
and multiplies its output by the learned decay exp(−norm_fn(n (+ offset)))
computed in float32; ``offset`` is a (num_heads,) parameter initialised by
:func:`init_offset` (``offset_init: uniform``) or linspace(4, 9) (``exp``).

In both, ``att_dropout`` acts on the context, then ``out_proj``.

``compute_dtype`` (``model.compute_dtype: bfloat16``) is flax's ``dtype=``
of ``tlie_tpu``'s mixers: ``Wqkv``, ``Wvqkn``, the conv and ``out_proj``
compute in bfloat16.  Softmax attention still runs in float32 on the upcast
q, k and v (``attention_layers.py:136-141``), so a bf16 transformer with
``use_flash`` and equal head dims reaches the float32 flash kernels; linear
attention takes bfloat16 elu+1 features, its chunked scores in bfloat16
and its normaliser in float32; norm attention takes bfloat16 q, k and v and
promotes n alone.  The
projections are ``nn.Linear``s with torch's default init, drawn from an
explicit ``torch.Generator`` (``tlie_tpu`` also draws the reference's torch
init: with flax's it plateaued on MQAR).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_softmax_attention
from ..ops.linear_attention import chunked_linear_attention
from .layers import DepthwiseCausalConv, Dropout, linear


def norm_fn_by_name(name: str):
    """The normaliser's function by its config name (``norm_fn_by_name``)."""
    fns = {"exp": torch.exp, "elu": F.elu, "softplus": F.softplus, "sigmoid": torch.sigmoid}
    if name not in fns:
        raise RuntimeError(f"normalization function {name} not implemented!")
    return fns[name]


def _elu_plus_one(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1


def approx_fn_by_name(name: str):
    """The feature map of q and k by its config name (``approx_fn_by_name``)."""
    if name == "none":
        return lambda x: x
    if name == "elu":
        return _elu_plus_one
    raise RuntimeError(f"approximation function {name} not implemented!")


def init_offset(size: int, a=0.02, b=0.1, lo=8.0, hi=14.0) -> np.ndarray:
    """Uniform-spread offset init (``init_offset``, ref
    models/norm_attention.py:17-24), copied as it is."""
    if size == 1:
        return np.array([(hi - lo) / 2], dtype=np.float32)
    x = np.log(np.expm1(np.linspace(a, b, size)))
    x = (x - x.min()) / (x.max() - x.min())
    return (x * abs(hi - lo) + lo).astype(np.float32)


def _offset_init(name: str):
    """``offset_init``'s initialiser: ``uniform`` or ``exp``, else it raises."""
    if name == "uniform":
        return init_offset
    if name == "exp":
        return lambda size: np.linspace(4.0, 9.0, size, dtype=np.float32)
    raise RuntimeError(f"Invalid init option {name}")


class MHA(nn.Module):
    """Causal multi-head self-attention, softmax or linear (``MHA``)."""

    def __init__(self, d_model: int, generator: torch.Generator, d_qk: Optional[int] = None,
                 num_heads: int = 1, dim_conv: int = 0, lin_att: bool = True,
                 dropout: float = 0.0, bias: bool = True, use_flash: bool = True,
                 conv_type: str = "full", compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin_att = lin_att
        self.d_model, self.d_qk = d_model, d_qk if d_qk is not None else d_model
        self.num_heads, self.conv_full = num_heads, conv_type == "full"
        self.head_dim = self.d_qk // num_heads
        self.v_dim = d_model // num_heads
        # the reference's choice (attention_layers.py:133-135): the flash path
        # when the config asks for it and the head dims agree
        self.impl = None if use_flash and self.head_dim == self.v_dim else "xla"
        g = generator
        self.Wqkv = linear(d_model, 2 * self.d_qk + d_model, g, bias=bias,
                           compute_dtype=compute_dtype)
        self.conv1d = None
        if dim_conv > 0:
            width = d_model + 2 * self.d_qk if self.conv_full else 2 * self.d_qk
            self.conv1d = DepthwiseCausalConv(width, dim_conv, g, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)
        self.out_proj = linear(d_model, d_model, g, compute_dtype=compute_dtype)

    def conv_input(self, qkv: torch.Tensor) -> torch.Tensor:
        """The part of the projection the conv reads: all of it, or [q | k]."""
        return qkv if self.conv_full else qkv[..., : 2 * self.d_qk]

    def after_conv(self, qkv: torch.Tensor, conv_out: torch.Tensor) -> torch.Tensor:
        """The projection with the conv's SiLU output in place of its input."""
        y = F.silu(conv_out)
        return y if self.conv_full else torch.cat([y, qkv[..., 2 * self.d_qk:]], dim=-1)

    def heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k, v of the full sequence x (B, L, d_model), as :meth:`split`
        gives them, after the conv where there is one."""
        qkv = self.Wqkv(x)
        if self.conv1d is not None:
            qkv = self.after_conv(qkv, self.conv1d(self.conv_input(qkv)))
        return self.split(qkv)

    def split(self, qkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k (…, H, head_dim) and v (…, H, v_dim), views of the
        projection [q | k | v]; for softmax attention in at least float32
        (the reference's upcast, ``promote_types(dtype, float32)``), for
        linear attention in the projection's dtype."""
        lead, H, d = qkv.shape[:-1], self.num_heads, self.d_qk
        if not self.lin_att:
            qkv = qkv.to(torch.promote_types(qkv.dtype, torch.float32))
        q = qkv[..., :d].reshape(*lead, H, self.head_dim)
        k = qkv[..., d: 2 * d].reshape(*lead, H, self.head_dim)
        v = qkv[..., 2 * d:].reshape(*lead, H, self.v_dim)
        return q, k, v

    @staticmethod
    def features(x: torch.Tensor) -> torch.Tensor:
        """Linear attention's feature map of q and k: elu(x) + 1."""
        return _elu_plus_one(x)

    def attend(self, q, k, v) -> torch.Tensor:
        """(B, L, H, v_dim) context of the full-sequence heads: softmax
        attention, or linear attention's numerator over its normaliser."""
        if self.lin_att:
            num, n = chunked_linear_attention(self.features(q), self.features(k), v, scale=1.0,
                                              return_normalizer=True)
            return num / n[..., None]
        return causal_softmax_attention(q, k, v, scale=1.0 / math.sqrt(self.head_dim),
                                        impl=self.impl)

    def project(self, context: torch.Tensor) -> torch.Tensor:
        """Dropout on the context, heads merged, ``out_proj``."""
        context = self.drop(context)
        return self.out_proj(context.reshape(*context.shape[:-2], self.d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(self.attend(*self.heads(x)))


class MHNA(nn.Module):
    """Multi-head norm attention: linear attention times a learned
    normaliser decay (``MHNA``)."""

    def __init__(self, d_model: int, generator: torch.Generator, d_qk: Optional[int] = None,
                 num_heads: int = 1, norm_fn: str = "exp", approx_fn: str = "none",
                 scale_B: bool = False, offset: bool = False, offset_init: str = "uniform",
                 dim_conv: int = 0, dropout: float = 0.0, bias: bool = True,
                 conv_type: str = "full", compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model, self.d_qk = d_model, d_qk if d_qk is not None else d_model
        self.num_heads, self.conv_full = num_heads, conv_type == "full"
        self.head_dim = self.d_qk // num_heads
        self.v_dim = d_model // num_heads
        self.norm_fn, self.approx_fn = norm_fn_by_name(norm_fn), approx_fn_by_name(approx_fn)
        self.scale = 1.0 / math.sqrt(self.head_dim) if scale_B else 1.0
        g = generator
        self.Wvqkn = linear(d_model, d_model + 2 * self.d_qk + num_heads, g, bias=bias,
                            compute_dtype=compute_dtype)
        self.conv1d = None
        if dim_conv > 0:
            width = d_model + 2 * self.d_qk if self.conv_full else 2 * self.d_qk
            self.conv1d = DepthwiseCausalConv(width, dim_conv, g, compute_dtype=compute_dtype)
        if offset:
            self.offset = nn.Parameter(torch.from_numpy(_offset_init(offset_init)(num_heads)))
        else:
            self.register_parameter("offset", None)
        self.drop = Dropout(dropout)
        self.out_proj = linear(d_model, d_model, g, compute_dtype=compute_dtype)

    def project_in(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``Wvqkn(x)`` split into [v | q | k] and the normaliser's
        projection n (…, H) in at least float32."""
        vqkn = self.Wvqkn(x)
        width = self.d_model + 2 * self.d_qk
        n = vqkn[..., width:]
        return vqkn[..., :width], n.to(torch.promote_types(n.dtype, torch.float32))

    def conv_input(self, vqk: torch.Tensor) -> torch.Tensor:
        """The part of [v | q | k] the conv reads: all of it, or [q | k]."""
        return vqk if self.conv_full else vqk[..., self.d_model:]

    def after_conv(self, vqk: torch.Tensor, conv_out: torch.Tensor) -> torch.Tensor:
        """[v | q | k] with the conv's SiLU output in place of its input."""
        y = F.silu(conv_out)
        return y if self.conv_full else torch.cat([vqk[..., : self.d_model], y], dim=-1)

    def split(self, vqk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The ``approx_fn`` features of q and k (…, H, head_dim), k scaled
        where ``scale_B`` is set, and v (…, H, v_dim)."""
        lead, H, d, dm = vqk.shape[:-1], self.num_heads, self.d_qk, self.d_model
        v = vqk[..., :dm].reshape(*lead, H, self.v_dim)
        q = self.approx_fn(vqk[..., dm: dm + d].reshape(*lead, H, self.head_dim))
        k = self.approx_fn(vqk[..., dm + d:].reshape(*lead, H, self.head_dim))
        return q, k * self.scale, v

    def heads(self, x: torch.Tensor):
        """q, k, v and n of the full sequence x (B, L, d_model), after the
        conv where there is one."""
        vqk, n = self.project_in(x)
        if self.conv1d is not None:
            vqk = self.after_conv(vqk, self.conv1d(self.conv_input(vqk)))
        return (*self.split(vqk), n)

    def decay(self, n: torch.Tensor) -> torch.Tensor:
        """The learned normaliser decay exp(−norm_fn(n (+ offset)))."""
        if self.offset is not None:
            n = n + self.offset
        return torch.exp(-self.norm_fn(n))

    def attend(self, q, k, v, n) -> torch.Tensor:
        """(B, L, H, v_dim): the chunked linear attention of the features
        (k already scaled) times the decay."""
        out = chunked_linear_attention(q, k, v, scale=1.0)
        return self.decay(n).to(out.dtype)[..., None] * out

    def project(self, context: torch.Tensor) -> torch.Tensor:
        """Dropout on the context, heads merged, ``out_proj``."""
        context = self.drop(context)
        return self.out_proj(context.reshape(*context.shape[:-2], self.d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(self.attend(*self.heads(x)))
