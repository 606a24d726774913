"""Shared blocks of the Mamba family, counterparts of
``tlie_tpu/models/layers.py``: the torch default initialisers drawn from an
explicit ``torch.Generator``, ``GLU``, ``TokenEmbeddings`` and
``DepthwiseCausalConv``.

Module and parameter names are the reference's torch names, so a port
``state_dict`` maps onto the flax tree through
``tlie_tpu/analysis/compat.py::torch_state_dict_to_flax`` and through
:mod:`tlie_tpu_torch.compat`.
"""

from __future__ import annotations

import math

import torch
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


def linear(d_in: int, d_out: int, generator: torch.Generator, bias: bool = True) -> nn.Linear:
    return torch_linear_init(nn.Linear(d_in, d_out, bias=bias), generator)


def torch_embed_init(emb: nn.Embedding, generator: torch.Generator) -> nn.Embedding:
    """torch ``nn.Embedding``'s default init, N(0, 1) (``torch_embed_init``)."""
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0, generator=generator)
    return emb


class GLU(nn.Module):
    """x ↦ a · σ(b) from one width-2d projection ``linear`` (``GLU``)."""

    def __init__(self, d: int, generator: torch.Generator):
        super().__init__()
        self.d = d
        self.linear = linear(d, 2 * d, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.linear(x)
        return out[..., : self.d] * torch.sigmoid(out[..., self.d :])


class TokenEmbeddings(nn.Module):
    """Learnable token embeddings (``TokenEmbeddings``).  The Mamba family
    passes ``max_position_embeddings`` 0, so there is no position table."""

    def __init__(self, embed_dim: int, vocab_size: int, generator: torch.Generator):
        super().__init__()
        self.word_embeddings = torch_embed_init(nn.Embedding(vocab_size, embed_dim), generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings(input_ids)


class DepthwiseCausalConv(nn.Module):
    """Depthwise causal conv parameters around
    :func:`tlie_tpu_torch.ops.conv.depthwise_causal_conv1d`, in
    ``nn.Conv1d(groups=C)``'s layout: ``weight`` (C, 1, K), ``bias`` (C,),
    both U(±1/√K) as torch's default."""

    def __init__(self, dim: int, kernel_size: int, generator: torch.Generator):
        super().__init__()
        k = 1.0 / math.sqrt(kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(dim, 1, kernel_size), k, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(dim), k, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_causal_conv1d(x, self.weight, self.bias)
