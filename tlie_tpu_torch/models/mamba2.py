"""The Mamba-2 / SSD family, counterpart of ``tlie_tpu/models/mamba2.py``
(``SSD``, ``SSD_LTI``, ``Mamba1``, ``MambaBlock``, ``Mamba``).

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

``SSD_LTI`` (``pseudoLTI: true``) is the paper's pseudo-LTI ablation on the
same chunked scan: the step is β ≡ 1, the decay −softplus(A) with A drawn
per head on U(−8, −2), and the input-dependent step is folded into B.

``Mamba`` takes tokens through the token embedding (``token_embedding:
true``) or float features through the dense encoder (``token_embedding:
false``, CIFAR's pixels), and pools over time (``pooling: mean``, ``max``
or ``last``) before the decoder for a classifier.  A padded batch,
``(tokens, lengths)`` (ListOps, IMDB), runs as its tokens: the lengths are
dropped and the pool takes the padding too.

``Mamba1`` (``version: mamba1``) is the selective-scan layer: ``in_proj`` →
[x, z], the depthwise causal conv and SiLU on x, ``x_proj`` → [dt, B, C],
the float32 ``dt_proj``, and the diagonal recurrence over the (d_inner,
d_state) lattice through :func:`tlie_tpu_torch.ops.scan.diag_linear_scan`
(on the card, the scan's forward and backward kernels with a decay that
varies in time), then y·SiLU(z) and ``out_proj``.  Under ``compute_dtype:
bfloat16`` it rounds where ``tlie_tpu``'s ``Mamba1`` does
(``models/mamba2.py:296-356``):
``in_proj``, the conv (and the SiLU on its bfloat16 output), ``x_proj`` and
``out_proj`` compute in bfloat16; ``dt_proj`` runs in float32 on the widened
dt rank, then softplus; the decay, the input Δ·B·x (x and B widened), the
scan, the C contraction, D·x and SiLU(z) stay float32; y is rounded to
bfloat16 before ``out_proj``.  The parameters stay float32.

With ``dual: true`` (AAN retrieval) a batch of pairs, tokens (B, 2, L), is
folded into (2B, L) documents before the encoder, and the decoder's 2B
pooled rows go through ``MATCH(output_dim, output_dim)`` as B pairs
(``match.{encoder,middle,decoder}``: 2·classes → classes → classes // 2 →
classes, as in ``tlie_tpu``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv_tail
from ..ops.scan import diag_linear_scan, sp_shard
from ..ops.ssd import ssd_chunked_scan
from .layers import (
    GLU, MATCH, DepthwiseCausalConv, Dropout, LayerNorm, TokenEmbeddings, at_least_float32,
    compute_dtype_of, fold_pairs, linear, uniform_,
)


# the SSD's init ranges, which no config changes: dt log-uniform on
# [DT_MIN, DT_MAX] (at least DT_INIT_FLOOR), A = exp(A_log) uniform on A_INIT
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4
A_INIT = (1.0, 16.0)


def _dt_bias_init(nheads: int, generator: torch.Generator) -> torch.Tensor:
    """Inverse softplus of a log-uniform dt sample on [DT_MIN, DT_MAX], one
    per head (SSD) or per channel (Mamba-1's ``dt_proj.bias``)."""
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

    def forward(self, u: torch.Tensor, return_state: bool = False):
        """``return_state`` (a prompt's prefill) also returns the decode
        state after the last step: (the conv's tail, h (B, H, P, N))."""
        d_inner, gn = self.d_inner, self.ngroups * self.d_state
        xbcdt = self.in_proj(u)
        conv_dim = d_inner + 2 * gn
        xBC, dt = xbcdt[..., :conv_dim], xbcdt[..., conv_dim:]
        dt = F.softplus(dt + self.dt_bias)  # (B, L, nheads); float32 beside a bf16 xbcdt
        tail = conv_tail(xBC, self.conv1d.weight.shape[-1]) if return_state else None
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
            dt_limit=self.dt_limit, return_final_state=return_state,
        )
        if return_state:
            y, h = y
            return self.out_proj(y.reshape(bsz, L, d_inner)), (tail, h)
        return self.out_proj(y.reshape(bsz, L, d_inner))


class SSD_LTI(nn.Module):
    """Pseudo-LTI SSD core (``SSD_LTI``).  ``in_proj`` gives [x, B, C, dt]
    with dt ngroups wide, not nheads (d_inner + 2·ngroups·N + ngroups), so
    dt = softplus(dt + dt_bias) broadcasts each group's step over its heads,
    which differ only by their bias; dt, each head's repeated N·ngroups /
    nheads times, multiplies B; the scan runs on the step β ≡ 1 with the
    decay −softplus(A), A ~ U(−8, −2) per head (not −exp(A_log)); and
    ``dt_limit`` clamps β, not dt."""

    def __init__(self, d_model: int, generator: torch.Generator, d_state: int = 64,
                 d_conv: int = 4, expand: int = 1, headdim: int = 32, ngroups: int = 1,
                 dt_limit=(0.0, float("inf")), learnable_init_states: bool = False,
                 chunk_size: Optional[int] = None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_inner = expand * d_model
        self.nheads = self.d_inner // headdim
        self.headdim, self.ngroups, self.d_state = headdim, ngroups, d_state
        self.dt_limit, self.chunk_size = tuple(dt_limit), chunk_size
        if (d_state * ngroups) % self.nheads:
            raise ValueError(f"SSD_LTI needs nheads ({self.nheads}) to divide "
                             f"d_state·ngroups ({d_state * ngroups})")
        self.khead_dim = d_state * ngroups // self.nheads
        conv_dim = self.d_inner + 2 * ngroups * d_state
        g = generator
        # draw order follows the flax module; in_proj and out_proj have no bias
        self.in_proj = linear(d_model, conv_dim + ngroups, g, bias=False,
                              compute_dtype=compute_dtype)
        self.dt_bias = nn.Parameter(_dt_bias_init(self.nheads, g))
        self.A = nn.Parameter(-8.0 + 6.0 * torch.rand(self.nheads, generator=g))
        self.D = nn.Parameter(torch.ones(self.nheads))
        self.conv1d = DepthwiseCausalConv(conv_dim, d_conv, g, compute_dtype=compute_dtype)
        self.init_states = (nn.Parameter(torch.zeros(self.nheads, headdim, d_state))
                            if learnable_init_states else None)
        self.out_proj = linear(self.d_inner, d_model, g, bias=False, compute_dtype=compute_dtype)

    def forward(self, u: torch.Tensor, return_state: bool = False):
        """``return_state`` as in :meth:`SSD.forward`."""
        d_inner, gn = self.d_inner, self.ngroups * self.d_state
        xbcdt = self.in_proj(u)
        conv_dim = d_inner + 2 * gn
        xBC, dt = xbcdt[..., :conv_dim], xbcdt[..., conv_dim:]
        dt = F.softplus(dt + self.dt_bias)  # (B, L, ngroups) + (nheads,) -> (B, L, nheads)
        tail = conv_tail(xBC, self.conv1d.weight.shape[-1]) if return_state else None
        xBC = F.silu(self.conv1d(xBC))
        x = xBC[..., :d_inner]
        B_mat = xBC[..., d_inner : d_inner + gn]
        C_mat = xBC[..., d_inner + gn :]
        bsz, L = x.shape[0], x.shape[1]
        # the input-dependent step rides on B; the scan's step is β ≡ 1
        B_mat = (torch.repeat_interleave(dt, self.khead_dim, dim=-1) * B_mat).to(x.dtype)
        beta = torch.ones(bsz, L, self.nheads, device=x.device)
        initial_states = None
        if self.init_states is not None:
            initial_states = self.init_states.expand((bsz,) + self.init_states.shape)
        y = ssd_chunked_scan(
            x.reshape(bsz, L, self.nheads, self.headdim), beta, -F.softplus(self.A),
            B_mat.reshape(bsz, L, self.ngroups, self.d_state),
            C_mat.reshape(bsz, L, self.ngroups, self.d_state),
            chunk_size=self.chunk_size, D=self.D, initial_states=initial_states,
            dt_limit=self.dt_limit, return_final_state=return_state,
        )
        if return_state:
            y, h = y
            return self.out_proj(y.reshape(bsz, L, d_inner)), (tail, h)
        return self.out_proj(y.reshape(bsz, L, d_inner))


class Mamba1(nn.Module):
    """Mamba-1 selective-scan layer (``Mamba1``): the recurrence
    h_t[d, n] = exp(Δ_t[d]·A[d, n])·h_{t−1}[d, n] + Δ_t[d]·B_t[n]·x_t[d],
    diagonal over the (d_inner, d_state) lattice, with A = −exp(A_log)
    varying over the state axis.  ``dt_proj``'s weight is U(±dt_rank^−½) and
    its bias the inverse softplus of a log-uniform Δ; ``A_log`` = log(1..N)
    for every channel, ``D`` = 1.  The decay a and the input bx are built at
    (B, L, d_inner, N) and scanned as their contiguous (B, L, d_inner·N)
    view, time at −2, which the scan's kernels read as a full decay; no
    transposed copy.  ``compute_dtype`` as in the module docstring."""

    def __init__(self, d_model: int, generator: torch.Generator, d_state: int = 16,
                 d_conv: int = 4, expand: int = 2, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_inner, self.d_state = expand * d_model, d_state
        self.dt_rank = -(-d_model // 16)  # ceil(d_model / 16), as mamba_ssm
        self.compute_dtype = compute_dtype
        d_inner, r, g, dt = self.d_inner, self.dt_rank, generator, compute_dtype
        # draw order follows the flax module; in_proj, x_proj and out_proj have no bias
        self.in_proj = linear(d_model, 2 * d_inner, g, bias=False, compute_dtype=dt)
        self.conv1d = (DepthwiseCausalConv(d_inner, d_conv, g, compute_dtype=dt)
                       if d_conv > 0 else None)
        self.x_proj = linear(d_inner, r + 2 * d_state, g, bias=False, compute_dtype=dt)
        self.dt_proj = nn.Linear(r, d_inner)
        uniform_(self.dt_proj.weight, r ** -0.5, g)
        with torch.no_grad():
            self.dt_proj.bias.copy_(_dt_bias_init(d_inner, g))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, d_state + 1, dtype=torch.float32))
                                  .expand(d_inner, d_state).clone())
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = linear(d_inner, d_model, g, bias=False, compute_dtype=dt)

    def forward(self, u: torch.Tensor, return_state: bool = False):
        """``return_state`` (a prompt's prefill) also returns the decode
        state after the last step: (the conv's tail, h (B, d_inner, N))."""
        x, z = self.in_proj(u).chunk(2, dim=-1)
        tail = None
        if return_state:
            tail = conv_tail(x, 0 if self.conv1d is None else self.conv1d.weight.shape[-1])
        if self.conv1d is not None:
            x = F.silu(self.conv1d(x))
        x_db = self.x_proj(x)
        r, n = self.dt_rank, self.d_state
        # the decay math in float32 at least, whatever the compute dtype (x_db,
        # x and z are bfloat16 under bf16 compute)
        x_db, x, z = at_least_float32(x_db), at_least_float32(x), at_least_float32(z)
        B_mat, C_mat = x_db[..., r: r + n], x_db[..., r + n:]
        dt = F.softplus(self.dt_proj(x_db[..., :r]))  # (B, L, d_inner)
        a = torch.exp(dt[..., None] * (-torch.exp(self.A_log)))  # (B, L, d_inner, N)
        bx = (dt * x)[..., None] * B_mat[..., None, :]
        bsz, L = a.shape[0], a.shape[1]
        h = diag_linear_scan(a.reshape(bsz, L, -1), bx.reshape(bsz, L, -1))
        y = torch.einsum("bldn,bln->bld", h.view(a.shape), C_mat) + self.D * x
        y = y * F.silu(z)
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        out = self.out_proj(y)
        if return_state:
            return out, (tail, h.view(a.shape)[:, -1].contiguous())
        return out


class MambaBlock(nn.Module):
    """Residual block: [norm] → mamba (``SSD`` or ``Mamba1``) → GELU →
    dropout → [GLU] → dropout → residual → [norm] (``MambaBlock``), with
    flax's LayerNorm (eps 1e-5, biased variance, the same as
    ``nn.LayerNorm``) and the exact erf GELU."""

    def __init__(self, cfg: Dict[str, Any], generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        version = cfg["version"]
        if version not in ("mamba1", "mamba2"):
            raise RuntimeError(f"Non supported version {version}")
        if cfg["norm"] != "layer":
            raise RuntimeError("only layer norm is supported for Mamba blocks")
        hidden = cfg["hidden_dim"]
        self.prenorm = cfg["prenorm"]
        if version == "mamba1":
            # only d_model, d_state, d_conv, expand and the dtype reach the
            # layer, as in tlie_tpu
            self.mamba = Mamba1(hidden, generator, d_state=cfg["state_dim"],
                                d_conv=cfg["conv_dim"], expand=cfg["expansion"],
                                compute_dtype=compute_dtype)
        else:
            self.mamba = (SSD_LTI if cfg.get("pseudoLTI", False) else SSD)(
                hidden, generator, d_state=cfg["state_dim"], d_conv=cfg["conv_dim"],
                expand=cfg["expansion"], headdim=hidden // cfg["num_heads"],
                ngroups=cfg.get("ngroups", 1), chunk_size=cfg.get("chunk_size"),
                dt_limit=tuple(cfg.get("dt_limit", (0.0, float("inf")))),
                learnable_init_states=cfg.get("learnable_init_states", False),
                compute_dtype=compute_dtype,
            )
        self.glu = GLU(hidden, generator, compute_dtype) if cfg["glu"] else None
        self.norm = LayerNorm(hidden, eps=1e-5)
        # one module applied twice, after the GELU and after the GLU (or
        # twice in a row without it): two independent masks, as in tlie_tpu
        self.drop = Dropout(cfg["dropout"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        if self.prenorm:
            x = self.norm(x)
        x = self.drop(F.gelu(self.mamba(x)))
        if self.glu is not None:
            x = self.glu(x)
        x = self.drop(x) + skip
        if not self.prenorm:
            x = self.norm(x)
        return x


class Mamba(nn.Module):
    """Encoder → N × MambaBlock → [pooling over time] → decoder (``Mamba``);
    returns logits.  The encoder is the token embedding (``token_embedding:
    true``) or a dense ``input_dim`` → ``hidden_dim`` layer with torch's
    default init (``encoder.weight``, ``encoder.bias``).  ``pooling: mean``,
    ``max`` or ``last`` reduces the time axis before the decoder, with no
    mask: a padded batch (ListOps, IMDB) is pooled over its padding too, as
    in ``tlie_tpu``; any other value keeps a decoder on every position."""

    def __init__(self, cfg: Dict[str, Any], generator: torch.Generator):
        super().__init__()
        hidden = cfg["hidden_dim"]
        dtype = compute_dtype_of(cfg)
        self.pooling = cfg.get("pooling", "none")
        if cfg.get("token_embedding", False):
            self.encoder = TokenEmbeddings(hidden, cfg["vocab_size"], generator,
                                           compute_dtype=dtype)
        else:
            self.encoder = linear(cfg["input_dim"], hidden, generator, compute_dtype=dtype)
        self.blocks = nn.ModuleList(MambaBlock(cfg, generator, dtype)
                                    for _ in range(cfg["num_layers"]))
        self.decoder = linear(hidden, cfg["output_dim"], generator, compute_dtype=dtype)
        self.dual = bool(cfg.get("dual", False))
        if self.dual:
            self.match = MATCH(cfg["output_dim"], cfg["output_dim"], cfg["output_dim"], generator)

    def features(self, x) -> torch.Tensor:
        """Backbone features before the decoder (``features``); a padded
        batch, ``(tokens, lengths)``, runs as its tokens alone, the lengths
        dropped as ``tlie_tpu`` and the reference drop them, and a dual
        model's pairs are folded into the batch."""
        if isinstance(x, tuple):
            x, _ = x
        if self.dual:
            x = fold_pairs(x)
        x = self.encoder(x)
        for block in self.blocks:
            x = block(x)
        return x

    def forward(self, x) -> torch.Tensor:
        x = self.features(x)
        shard = sp_shard()
        if shard is not None and self.pooling in ("mean", "max", "last"):
            # the pool over the group's time steps (parallel/sp.py::sp_pool)
            from ..parallel.sp import sp_pool

            x = sp_pool(x, self.pooling, shard)
        elif self.pooling == "mean":
            x = x.mean(dim=-2)
        elif self.pooling == "max":
            x = x.amax(dim=-2)
        elif self.pooling == "last":
            x = x[..., -1, :]
        x = self.decoder(x)
        return self.match(x) if self.dual else x
