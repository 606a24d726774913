"""The Mamba-2 / SSD family, counterpart of ``tlie_tpu/models/mamba2.py``
(``SSD``, ``MambaBlock``, ``Mamba``).

``SSD`` is the fused ``in_proj`` → [x, B, C, dt], dt = softplus(dt +
dt_bias), the depthwise causal conv and SiLU on xBC, the chunked scan
(:func:`tlie_tpu_torch.ops.ssd.ssd_chunked_scan`, whose intra-chunk arm runs
the hand-written decay-attention kernels on the card) with the D skip, and
``out_proj``.  Parameter names are the reference's torch names
(``blocks.{i}.mamba.in_proj.weight``, ``blocks.{i}.glu.linear.weight``,
``blocks.{i}.norm.weight``, ...).

Weights are drawn from an explicit ``torch.Generator`` with the reference's
distributions; JAX's draws cannot be reproduced.

``model.compute_dtype: bfloat16`` follows ``tlie_tpu``'s mixed precision
(``Mamba`` passes ``dtype=bfloat16`` to the modules below): the token
embedding, ``in_proj``, the conv, ``out_proj``, the GLU's projection and the
decoder compute in bfloat16 on casts of their float32 parameters, and so do
the activations between them, the residual stream included (flax's
promotion keeps bf16 + bf16 in bf16); the LayerNorms compute in float32 and
return float32, dt = softplus(dt + dt_bias) and the decay math stay float32,
and the chunked scan takes bfloat16 operands (:mod:`tlie_tpu_torch.ops.ssd`).
The logits are bfloat16; the loss reduces them in float32.

Not ported yet, and refused: ``version: mamba1`` and ``pseudoLTI: true``
(the pseudo-LTI ``SSD_LTI``), dropout (every Mamba-2 config sets 0), the
dense input encoder (``token_embedding: false``), the pooled and dual heads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ssd import ssd_chunked_scan
from .layers import GLU, DepthwiseCausalConv, TokenEmbeddings, linear


# the SSD's init ranges, which no config changes: dt log-uniform on
# [DT_MIN, DT_MAX] (at least DT_INIT_FLOOR), A = exp(A_log) uniform on A_INIT
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4
A_INIT = (1.0, 16.0)


def _dt_bias_init(nheads: int, generator: torch.Generator) -> torch.Tensor:
    """Inverse softplus of a log-uniform dt sample on [DT_MIN, DT_MAX]."""
    u = torch.rand(nheads, generator=generator)
    dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
    dt = torch.clamp(dt, min=DT_INIT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


class SSD(nn.Module):
    """Selective state-space duality core (``SSD``)."""

    def __init__(self, d_model: int, generator: torch.Generator, d_state: int = 64,
                 d_conv: int = 4, expand: int = 1, headdim: int = 32, ngroups: int = 1,
                 dt_limit=(0.0, float("inf")), learnable_init_states: bool = False,
                 chunk_size: Optional[int] = None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_inner = expand * d_model
        self.nheads = self.d_inner // headdim
        self.headdim, self.ngroups, self.d_state = headdim, ngroups, d_state
        self.dt_limit, self.chunk_size = tuple(dt_limit), chunk_size
        conv_dim = self.d_inner + 2 * ngroups * d_state
        g = generator
        # draw order follows the flax module; in_proj and out_proj have no bias
        self.in_proj = linear(d_model, conv_dim + self.nheads, g, bias=False,
                              compute_dtype=compute_dtype)
        self.dt_bias = nn.Parameter(_dt_bias_init(self.nheads, g))
        lo, hi = A_INIT
        self.A_log = nn.Parameter(torch.log(lo + (hi - lo) * torch.rand(self.nheads, generator=g)))
        self.D = nn.Parameter(torch.ones(self.nheads))
        self.conv1d = DepthwiseCausalConv(conv_dim, d_conv, g, compute_dtype=compute_dtype)
        self.init_states = (nn.Parameter(torch.zeros(self.nheads, headdim, d_state))
                            if learnable_init_states else None)
        self.out_proj = linear(self.d_inner, d_model, g, bias=False, compute_dtype=compute_dtype)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        d_inner, gn = self.d_inner, self.ngroups * self.d_state
        xbcdt = self.in_proj(u)
        conv_dim = d_inner + 2 * gn
        xBC, dt = xbcdt[..., :conv_dim], xbcdt[..., conv_dim:]
        dt = F.softplus(dt + self.dt_bias)  # (B, L, nheads); float32 beside a bf16 xbcdt
        xBC = F.silu(self.conv1d(xBC))
        x = xBC[..., :d_inner]
        B_mat = xBC[..., d_inner : d_inner + gn]
        C_mat = xBC[..., d_inner + gn :]
        bsz, L = x.shape[0], x.shape[1]
        initial_states = None
        if self.init_states is not None:
            initial_states = self.init_states.expand((bsz,) + self.init_states.shape)
        y = ssd_chunked_scan(
            x.reshape(bsz, L, self.nheads, self.headdim), dt, -torch.exp(self.A_log),
            B_mat.reshape(bsz, L, self.ngroups, self.d_state),
            C_mat.reshape(bsz, L, self.ngroups, self.d_state),
            chunk_size=self.chunk_size, D=self.D, initial_states=initial_states,
            dt_limit=self.dt_limit,
        )
        return self.out_proj(y.reshape(bsz, L, d_inner))


class MambaBlock(nn.Module):
    """Residual block: [norm] → mamba → GELU → [GLU] → residual → [norm]
    (``MambaBlock``), with flax's LayerNorm (eps 1e-5, biased variance, the
    same as ``nn.LayerNorm``) and the exact erf GELU."""

    def __init__(self, cfg: Dict[str, Any], generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg["version"] != "mamba2":
            if cfg["version"] == "mamba1":
                raise NotImplementedError("version: mamba1 is not ported yet")
            raise RuntimeError(f"Non supported version {cfg['version']}")
        if cfg.get("pseudoLTI", False):
            raise NotImplementedError("pseudoLTI (SSD_LTI) is not ported yet")
        if cfg["norm"] != "layer":
            raise RuntimeError("only layer norm is supported for Mamba blocks")
        if cfg["dropout"] != 0.0:
            raise NotImplementedError("dropout in Mamba blocks is not ported yet")
        hidden = cfg["hidden_dim"]
        self.prenorm = cfg["prenorm"]
        self.mamba = SSD(
            hidden, generator, d_state=cfg["state_dim"], d_conv=cfg["conv_dim"],
            expand=cfg["expansion"], headdim=hidden // cfg["num_heads"],
            ngroups=cfg.get("ngroups", 1), chunk_size=cfg.get("chunk_size"),
            dt_limit=tuple(cfg.get("dt_limit", (0.0, float("inf")))),
            learnable_init_states=cfg.get("learnable_init_states", False),
            compute_dtype=compute_dtype,
        )
        self.glu = GLU(hidden, generator, compute_dtype) if cfg["glu"] else None
        self.norm = nn.LayerNorm(hidden, eps=1e-5)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        """flax's LayerNorm: statistics and output at least float32."""
        return self.norm(x.to(torch.promote_types(x.dtype, torch.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        if self.prenorm:
            x = self._norm(x)
        x = F.gelu(self.mamba(x))
        if self.glu is not None:
            x = self.glu(x)
        x = x + skip
        if not self.prenorm:
            x = self._norm(x)
        return x


class Mamba(nn.Module):
    """Embedding → N × MambaBlock → per-position decoder (``Mamba`` with
    ``pooling: none``); returns logits."""

    def __init__(self, cfg: Dict[str, Any], generator: torch.Generator):
        super().__init__()
        if cfg.get("pooling", "none") != "none" or cfg.get("dual", False):
            raise NotImplementedError("pooled and dual Mamba heads are not ported yet")
        if not cfg.get("token_embedding", False):
            raise NotImplementedError("the dense input encoder (token_embedding: false) "
                                      "is not ported yet")
        hidden = cfg["hidden_dim"]
        dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None
        self.encoder = TokenEmbeddings(hidden, cfg["vocab_size"], generator, compute_dtype=dtype)
        self.blocks = nn.ModuleList(MambaBlock(cfg, generator, dtype)
                                    for _ in range(cfg["num_layers"]))
        self.decoder = linear(hidden, cfg["output_dim"], generator, compute_dtype=dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone features before the decoder (``features``)."""
        x = self.encoder(x)
        for block in self.blocks:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.features(x))
