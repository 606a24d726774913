"""SSM sequence backbone, counterpart of ``tlie_tpu/models/backbone.py`` for
evaluation: Dense encoder → N × (SSM → GLU-variant activation → residual,
with the norm before or after) → Dense decoder → log-softmax (or logits).

Module names follow the flax tree (``encoder.encoder``,
``encoder.layers.{i}.{seq,out1,out2,normalize}``, ``decoder``) so that
:func:`tlie_tpu_torch.compat.params_from_jax` maps one onto the other.

This slice evaluates and serves: dropout is the identity and BatchNorm
normalises with its running statistics.  A module in training mode raises.
"""

from __future__ import annotations

from typing import Callable

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


class BatchNormEval(nn.BatchNorm1d):
    """flax ``BatchNorm`` in eval mode over the last (feature) axis, with its
    running statistics and eps 1e-5."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(
            x.reshape(-1, x.shape[-1]), self.running_mean, self.running_var,
            self.weight, self.bias, training=False, eps=self.eps,
        )
        return y.reshape(x.shape)


class SequenceLayer(nn.Module):
    """One residual block around an SSM core (``SequenceLayer``)."""

    def __init__(self, ssm: Callable[[], nn.Module], d_model: int, generator: torch.Generator,
                 activation: str = "full_glu", prenorm: bool = True, norm: str = "layer"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise NotImplementedError(f"Activation: {activation} not implemented")
        self.activation, self.prenorm = activation, prenorm
        self.seq = ssm()
        if activation == "full_glu":
            self.out1 = dense(d_model, d_model, generator)
        if activation in ("full_glu", "half_glu1", "half_glu2"):
            self.out2 = dense(d_model, d_model, generator)
        # flax LayerNorm's eps is 1e-6
        self.normalize = BatchNormEval(d_model) if norm == "batch" else nn.LayerNorm(d_model, eps=1e-6)

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
    """The activation variants of ``SequenceLayer`` (dropout is the identity
    in evaluation); ``layer`` holds ``out1``/``out2``."""
    act = layer.activation
    if act == "full_glu":
        x = _gelu(x)
        return layer.out1(x) * torch.sigmoid(layer.out2(x))
    if act == "half_glu1":
        x = _gelu(x)
        return x * torch.sigmoid(layer.out2(x))
    if act == "half_glu2":
        return x * torch.sigmoid(layer.out2(_gelu(x)))
    return _gelu(x)


class StackedEncoderModel(nn.Module):
    """Dense encoder + stack of SequenceLayers (``StackedEncoderModel``)."""

    def __init__(self, ssm, d_model: int, n_layers: int, d_input: int,
                 generator: torch.Generator, activation: str = "full_glu",
                 prenorm: bool = True, norm: str = "layer"):
        super().__init__()
        self.encoder = DenseEmbed(d_input, d_model, generator)
        self.layers = nn.ModuleList(
            SequenceLayer(ssm, d_model, generator, activation, prenorm, norm)
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
    (``ClassificationModel``)."""

    def __init__(self, ssm, d_output: int, d_model: int, n_layers: int, d_input: int,
                 generator: torch.Generator, activation: str = "full_glu",
                 pooling: str = "none", prenorm: bool = True, norm: str = "layer",
                 logits_output: bool = False):
        super().__init__()
        if pooling != "none":
            raise NotImplementedError(f"pooling {pooling!r} is not ported yet")
        self.logits_output = logits_output
        self.encoder = StackedEncoderModel(
            ssm, d_model, n_layers, d_input, generator, activation, prenorm, norm
        )
        self.decoder = dense(d_model, d_output, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training mode is not ported yet: call .eval() (dropout and "
                "BatchNorm statistics updates come with the training slice)"
            )
        x = self.decoder(self.encoder(x))
        if self.logits_output:
            return x
        return F.log_softmax(x, dim=-1)
