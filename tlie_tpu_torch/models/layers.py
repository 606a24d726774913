"""Shared blocks of the Mamba and transformer families, counterparts of
``tlie_tpu/models/layers.py``: the torch default initialisers drawn from an
explicit ``torch.Generator``, ``GLU``, ``TokenEmbeddings`` (with the
transformer's position table), ``DepthwiseCausalConv`` and the element-wise
``Dropout``.

Module and parameter names are the reference's torch names, so a port
``state_dict`` maps onto the flax tree through
``tlie_tpu/analysis/compat.py::torch_state_dict_to_flax`` and through
:mod:`tlie_tpu_torch.compat`.

``compute_dtype`` (``Linear``, ``TokenEmbeddings``, ``DepthwiseCausalConv``)
is flax's ``dtype=`` of the same module: None computes in the parameters'
dtype; ``torch.bfloat16`` casts the input and the parameters to bfloat16 and
computes there, while the parameters stay float32 (``model.compute_dtype:
bfloat16``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import depthwise_causal_conv1d


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    """t ~ U(−bound, bound) from ``generator``, in place."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def torch_linear_init(lin: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """torch ``nn.Linear``'s default init (``torch_linear_init``): weight
    and bias U(±1/√fan_in), drawn from ``generator``."""
    k = 1.0 / math.sqrt(lin.in_features)
    uniform_(lin.weight, k, generator)
    if lin.bias is not None:
        uniform_(lin.bias, k, generator)
    return lin


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` where one is set (flax
    ``Dense(dtype=...)``): x, the weight and the bias cast to it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def linear(d_in: int, d_out: int, generator: torch.Generator, bias: bool = True,
           compute_dtype: Optional[torch.dtype] = None) -> Linear:
    lin = torch_linear_init(Linear(d_in, d_out, bias=bias), generator)
    lin.compute_dtype = compute_dtype
    return lin


def torch_embed_init(emb: nn.Embedding, generator: torch.Generator) -> nn.Embedding:
    """torch ``nn.Embedding``'s default init, N(0, 1) (``torch_embed_init``)."""
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0, generator=generator)
    return emb


class GLU(nn.Module):
    """x ↦ a · σ(b) from one width-2d projection ``linear`` (``GLU``)."""

    def __init__(self, d: int, generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d = d
        self.linear = linear(d, 2 * d, generator, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.linear(x)
        return out[..., : self.d] * torch.sigmoid(out[..., self.d :])


class TokenEmbeddings(nn.Module):
    """Learnable token embeddings plus, where ``max_position_embeddings`` >
    0, learnable position embeddings (``TokenEmbeddings``), both N(0, 1).
    The Mamba family passes 0, so it has no position table.  A position past
    the table raises (``F.embedding``'s ``IndexError``); the reference's
    gather fills NaN there."""

    def __init__(self, embed_dim: int, vocab_size: int, generator: torch.Generator,
                 max_position_embeddings: int = 0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.word_embeddings = torch_embed_init(nn.Embedding(vocab_size, embed_dim), generator)
        self.position_embeddings = (
            torch_embed_init(nn.Embedding(max_position_embeddings, embed_dim), generator)
            if max_position_embeddings > 0 else None)
        self.compute_dtype = compute_dtype

    def _embed(self, table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the table, cast to ``compute_dtype`` first as flax's
        ``Embed(dtype=...)`` casts its table."""
        if self.compute_dtype is None:
            return table(ids)
        return F.embedding(ids, table.weight.to(self.compute_dtype))

    def forward(self, input_ids: torch.Tensor, position_ids=None) -> torch.Tensor:
        emb = self._embed(self.word_embeddings, input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)
            emb = emb + self._embed(self.position_embeddings, position_ids)
        return emb


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training mode an element-wise keep mask,
    the kept values scaled by 1/(1-rate); the identity in evaluation.  Masks
    come from ``generator`` (the device's default generator when None),
    which ``build_models`` sets to the model's dropout generator."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate, self.generator = rate, generator

    def mask_shape(self, x: torch.Tensor) -> torch.Size:
        return x.shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        if self.generator is None:
            # out of place, so that under torch.func.vmap(randomness="different")
            # each point of a stacked grid draws its own mask
            mask = torch.bernoulli(torch.full(self.mask_shape(x), keep, device=x.device,
                                              dtype=x.dtype))
        else:
            mask = torch.empty(self.mask_shape(x), device=x.device, dtype=x.dtype)
            mask.bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class DepthwiseCausalConv(nn.Module):
    """Depthwise causal conv parameters around
    :func:`tlie_tpu_torch.ops.conv.depthwise_causal_conv1d`, in
    ``nn.Conv1d(groups=C)``'s layout: ``weight`` (C, 1, K), ``bias`` (C,),
    both U(±1/√K) as torch's default."""

    def __init__(self, dim: int, kernel_size: int, generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = 1.0 / math.sqrt(kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(dim, 1, kernel_size), k, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(dim), k, generator))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return depthwise_causal_conv1d(x, self.weight, self.bias)
        return depthwise_causal_conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt))
