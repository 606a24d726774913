"""SSM sequence backbone, counterpart of ``tlie_tpu/models/backbone.py``:
Dense encoder → N × (SSM → GLU-variant activation → residual, with the norm
before or after) → Dense decoder → log-softmax (or logits).

Module names follow the flax tree (``encoder.encoder``,
``encoder.layers.{i}.{seq,out1,out2,normalize}``, ``decoder``) so that
:mod:`tlie_tpu_torch.compat` maps one onto the other.

Training mode is the module's ``.training`` flag, as flax's ``training``
field: dropout draws one mask per (example, feature), shared across time,
and BatchNorm normalises with the batch's statistics and updates its running
ones as flax does (momentum 0.99, the biased E[x²]−E[x]² variance).  In
evaluation dropout is the identity and BatchNorm uses the running statistics.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import lecun_normal_

ACTIVATIONS = ("full_glu", "half_glu1", "half_glu2", "gelu")


def _gelu(x):
    # flax's nn.gelu is the tanh approximation, not torch's default erf form
    return F.gelu(x, approximate="tanh")


def dense(d_in: int, d_out: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``nn.Dense``: lecun-normal weight,
    zero bias."""
    lin = nn.Linear(d_in, d_out)
    lecun_normal_(lin.weight, d_in, generator)
    nn.init.zeros_(lin.bias)
    return lin


class DenseEmbed(nn.Module):
    """Dense layer with a gather for integer tokens, counterpart of
    ``DenseEmbed``: ``weight`` keeps flax's (in_features, features) kernel
    layout, so a token's embedding is its row plus the bias."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.weight, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_floating_point(x):
            return F.embedding(x, self.weight) + self.bias
        return x @ self.weight + self.bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (feature) axis with its defaults:
    momentum 0.99, eps 1e-5, ``use_fast_variance``.

    In training mode the statistics are the batch's, over every axis but the
    last, with the biased variance E[x²]−E[x]² (clipped at 0), and the
    running statistics become ``0.99·running + 0.01·batch``.
    ``torch.nn.BatchNorm1d`` differs in both (momentum 0.1, an unbiased
    running variance), so it is not used."""

    momentum, eps = 0.99, 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class BroadcastDropout(nn.Module):
    """flax ``nn.Dropout(rate, broadcast_dims=[-2])``: in training mode one
    keep mask per (example, feature), shared across time (axis -2), with the
    kept values scaled by 1/(1-rate).  Masks come from ``generator`` (the
    device's default generator when None)."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate, self.generator = rate, generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        shape = x.shape[:-2] + (1, x.shape[-1])
        mask = torch.empty(shape, device=x.device, dtype=x.dtype)
        mask.bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class SequenceLayer(nn.Module):
    """One residual block around an SSM core (``SequenceLayer``)."""

    def __init__(self, ssm: Callable[[], nn.Module], d_model: int, generator: torch.Generator,
                 activation: str = "full_glu", prenorm: bool = True, norm: str = "layer",
                 dropout: float = 0.0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise NotImplementedError(f"Activation: {activation} not implemented")
        self.activation, self.prenorm = activation, prenorm
        self.seq = ssm()
        self.drop = BroadcastDropout(dropout)
        if activation == "full_glu":
            self.out1 = dense(d_model, d_model, generator)
        if activation in ("full_glu", "half_glu1", "half_glu2"):
            self.out2 = dense(d_model, d_model, generator)
        # flax LayerNorm's eps is 1e-6
        self.normalize = BatchNorm(d_model) if norm == "batch" else nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        if self.prenorm:
            x = self.normalize(x)
        x = self.seq(x)
        x = glu_activation(self, x)
        x = skip + x
        if not self.prenorm:
            x = self.normalize(x)
        return x


def glu_activation(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The activation variants of ``SequenceLayer`` with their dropouts, in
    flax's order; ``layer`` holds ``out1``/``out2`` and ``drop``."""
    act, drop = layer.activation, layer.drop
    if act == "full_glu":
        x = drop(_gelu(x))
        return drop(layer.out1(x) * torch.sigmoid(layer.out2(x)))
    if act == "half_glu1":
        x = drop(_gelu(x))
        return drop(x * torch.sigmoid(layer.out2(x)))
    if act == "half_glu2":
        return drop(x * torch.sigmoid(layer.out2(drop(_gelu(x)))))
    return drop(_gelu(x))


class StackedEncoderModel(nn.Module):
    """Dense encoder + stack of SequenceLayers (``StackedEncoderModel``)."""

    def __init__(self, ssm, d_model: int, n_layers: int, d_input: int,
                 generator: torch.Generator, activation: str = "full_glu",
                 prenorm: bool = True, norm: str = "layer", dropout: float = 0.0):
        super().__init__()
        self.encoder = DenseEmbed(d_input, d_model, generator)
        self.layers = nn.ModuleList(
            SequenceLayer(ssm, d_model, generator, activation, prenorm, norm, dropout)
            for _ in range(n_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder(x)
        for layer in self.layers:
            x = layer(x)
        return x


class ClassificationModel(nn.Module):
    """Backbone + per-position Dense decoder (``pooling: none``) +
    log-softmax, or logits when ``logits_output`` is set
    (``ClassificationModel``).  ``.train()`` is flax's ``training=True``."""

    def __init__(self, ssm, d_output: int, d_model: int, n_layers: int, d_input: int,
                 generator: torch.Generator, activation: str = "full_glu",
                 pooling: str = "none", prenorm: bool = True, norm: str = "layer",
                 logits_output: bool = False, dropout: float = 0.0):
        super().__init__()
        if pooling != "none":
            raise NotImplementedError(f"pooling {pooling!r} is not ported yet")
        self.logits_output = logits_output
        self.encoder = StackedEncoderModel(
            ssm, d_model, n_layers, d_input, generator, activation, prenorm, norm, dropout
        )
        self.decoder = dense(d_model, d_output, generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone features before the decoder (``features``), which the
        sparse decoder head gathers from."""
        return self.encoder(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.decoder(self.encoder(x))
        if self.logits_output:
            return x
        return F.log_softmax(x, dim=-1)
