"""Multi-head softmax attention, counterpart of the softmax branch of
``tlie_tpu/models/attention_layers.py::MHA`` (``:73-150``).

``Wqkv`` projects to [q | k | v] (2·d_qk + d_model wide, the reference's
fused layout, which eigen-analysis reads back), an optional depthwise causal
conv with SiLU runs over all of it (``conv_type: full``) or over [q | k]
alone, the heads are split as views of the projection, upcast to float32,
and :func:`tlie_tpu_torch.ops.attention.causal_softmax_attention` takes them
(on the card: the three flash kernels, which read q, k and v through their
strides).  ``att_dropout`` acts on the context, then ``out_proj``.  The
projections are ``nn.Linear``s with torch's default init, drawn from an
explicit ``torch.Generator``.

Linear attention (``lin_att``, ``attention_fn: lin-attention``) is not
ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_softmax_attention
from .layers import DepthwiseCausalConv, Dropout, linear


class MHA(nn.Module):
    """Causal multi-head softmax self-attention (``MHA`` with
    ``lin_att=False``)."""

    def __init__(self, d_model: int, generator: torch.Generator, d_qk: Optional[int] = None,
                 num_heads: int = 1, dim_conv: int = 0, lin_att: bool = True,
                 dropout: float = 0.0, bias: bool = True, use_flash: bool = True,
                 conv_type: str = "full"):
        super().__init__()
        if lin_att:
            raise NotImplementedError("linear attention (attention_fn: lin-attention) is not "
                                      "ported yet")
        self.d_model, self.d_qk = d_model, d_qk if d_qk is not None else d_model
        self.num_heads, self.conv_full = num_heads, conv_type == "full"
        self.head_dim = self.d_qk // num_heads
        self.v_dim = d_model // num_heads
        # the reference's choice (attention_layers.py:133-135): the flash path
        # when the config asks for it and the head dims agree
        self.impl = None if use_flash and self.head_dim == self.v_dim else "xla"
        g = generator
        self.Wqkv = linear(d_model, 2 * self.d_qk + d_model, g, bias=bias)
        self.conv1d = None
        if dim_conv > 0:
            width = d_model + 2 * self.d_qk if self.conv_full else 2 * self.d_qk
            self.conv1d = DepthwiseCausalConv(width, dim_conv, g)
        self.drop = Dropout(dropout)
        self.out_proj = linear(d_model, d_model, g)

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
        """q, k (…, H, head_dim) and v (…, H, v_dim) in at least float32
        (the reference's upcast, ``promote_types(dtype, float32)``), views of
        the projection [q | k | v]."""
        lead, H, d = qkv.shape[:-1], self.num_heads, self.d_qk
        qkv = qkv.to(torch.promote_types(qkv.dtype, torch.float32))
        q = qkv[..., :d].reshape(*lead, H, self.head_dim)
        k = qkv[..., d: 2 * d].reshape(*lead, H, self.head_dim)
        v = qkv[..., 2 * d:].reshape(*lead, H, self.v_dim)
        return q, k, v

    def attend(self, q, k, v) -> torch.Tensor:
        """(B, L, H, v_dim) context of the full-sequence heads."""
        return causal_softmax_attention(q, k, v, scale=1.0 / math.sqrt(self.head_dim),
                                        impl=self.impl)

    def project(self, context: torch.Tensor) -> torch.Tensor:
        """Dropout on the context, heads merged, ``out_proj``."""
        context = self.drop(context)
        return self.out_proj(context.reshape(*context.shape[:-2], self.d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(self.attend(*self.heads(x)))
