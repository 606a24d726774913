"""SSM sequence backbone, counterpart of ``tlie_tpu/models/backbone.py``:
Dense encoder → N × (SSM → GLU-variant activation → residual, with the norm
before or after) → pooling over time (``mean``, ``last`` or ``none``) →
Dense decoder → log-softmax (or logits).  A padded model
(``padded=True``, ListOps) takes ``(inputs, lengths)`` and its mean pool
covers each sequence's valid prefix only (:func:`masked_meanpool`); every
other layer sees the padding as it sees any token, as in ``tlie_tpu``: a
training-mode BatchNorm takes its statistics over every position.

Module names follow the flax tree (``encoder.encoder``,
``encoder.layers.{i}.{seq,out1,out2,normalize}``, ``decoder``) so that
:mod:`tlie_tpu_torch.compat` maps one onto the other.

Training mode is the module's ``.training`` flag, as flax's ``training``
field: dropout draws one mask per (example, feature), shared across time,
and BatchNorm normalises with the batch's statistics and updates its running
ones as flax does (momentum 0.99, the biased E[x²]−E[x]² variance).  In
evaluation dropout is the identity and BatchNorm uses the running statistics.

``compute_dtype`` (``model.compute_dtype: bfloat16``) is flax's ``dtype=``
of ``tlie_tpu``'s backbone (``backbone.py:25-57``, ``:60-120``,
``:194-212``): the encoder, the GLU variants' ``out1``/``out2`` and the
decoder compute in bfloat16 on casts of their float32 parameters; the SSM
core always receives float32; the norms take their statistics and give
their output in float32, as flax's norms do on float32 parameters; the
residual sum keeps the dtype PyTorch promotes it to, as XLA keeps it.  So in
a pre-norm stack with a full GLU the residual stream stays bfloat16 from the
encoder onwards, while a post-norm stack's BatchNorm turns the bfloat16 sum
into float32 again.  The parameters stay float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.scan import sp_shard
from .initializers import lecun_normal_
from .layers import Dropout, LayerNorm, Linear, at_least_float32

ACTIVATIONS = ("full_glu", "half_glu1", "half_glu2", "gelu")


def _gelu(x):
    # flax's nn.gelu is the tanh approximation, not torch's default erf form
    return F.gelu(x, approximate="tanh")


def dense(d_in: int, d_out: int, generator: torch.Generator,
          compute_dtype: Optional[torch.dtype] = None) -> Linear:
    """A :class:`~tlie_tpu_torch.models.layers.Linear` initialised as flax's
    ``nn.Dense``: lecun-normal weight, zero bias, computing in
    ``compute_dtype`` where one is set."""
    lin = Linear(d_in, d_out)
    lecun_normal_(lin.weight, d_in, generator)
    nn.init.zeros_(lin.bias)
    lin.compute_dtype = compute_dtype
    return lin


class DenseEmbed(nn.Module):
    """Dense layer with a gather for integer tokens, counterpart of
    ``DenseEmbed``: ``weight`` keeps flax's (in_features, features) kernel
    layout, so a token's embedding is its row plus the bias.  With
    ``compute_dtype`` the kernel and the bias are cast first (and a float
    input too), so a token's row and the bias are bfloat16."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.weight, in_features, generator)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            w, b = w.to(self.compute_dtype), b.to(self.compute_dtype)
        if not torch.is_floating_point(x):
            return F.embedding(x, w) + b
        return x.to(w.dtype) @ w + b


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (feature) axis with its defaults:
    momentum 0.99, eps 1e-5, ``use_fast_variance``.

    In training mode the statistics are the batch's, over every axis but the
    last, with the biased variance E[x²]−E[x]² (clipped at 0), and the
    running statistics become ``0.99·running + 0.01·batch``.  A bfloat16
    input is widened to float32 first: the statistics, their running
    averages and the output are float32, as flax's are.
    ``torch.nn.BatchNorm1d`` differs in both (momentum 0.1, an unbiased
    running variance), so it is not used.

    Under the data- or sequence-parallel route (``shard``, set by the
    training loop on its train model) the statistics are the global batch's,
    as the sharded flax ``BatchNorm`` takes them: the sums of x and x² and
    the count of positions (rows, or the rank's L/n steps of every row) are
    all-reduced over the group, with autograd through the all-reduce,
    so every rank's running statistics stay equal."""

    momentum, eps = 0.99, 1e-5
    shard = None

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_float32(x)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.shard is None:
                mean = x.mean(dims)
                var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            else:
                # the global batch's statistics: the sums and the count over
                # the group, differentiable through the all-reduce
                c = x.shape[-1]
                n = x.new_full((1,), x.numel() // c)
                sums = self.shard.sum_with_grad(torch.cat([x.sum(dims), (x * x).sum(dims), n]))
                mean = sums[:c] / sums[-1]
                var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class BroadcastDropout(Dropout):
    """flax ``nn.Dropout(rate, broadcast_dims=[-2])``: in training mode one
    keep mask per (example, feature), shared across time (axis -2), with the
    kept values scaled by 1/(1-rate)."""

    time_shared = True

    def mask_shape(self, x: torch.Tensor) -> torch.Size:
        return x.shape[:-2] + (1, x.shape[-1])


class SequenceLayer(nn.Module):
    """One residual block around an SSM core (``SequenceLayer``)."""

    def __init__(self, ssm: Callable[[], nn.Module], d_model: int, generator: torch.Generator,
                 activation: str = "full_glu", prenorm: bool = True, norm: str = "layer",
                 dropout: float = 0.0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise NotImplementedError(f"Activation: {activation} not implemented")
        self.activation, self.prenorm = activation, prenorm
        self.seq = ssm()
        self.drop = BroadcastDropout(dropout)
        if activation == "full_glu":
            self.out1 = dense(d_model, d_model, generator, compute_dtype)
        if activation in ("full_glu", "half_glu1", "half_glu2"):
            self.out2 = dense(d_model, d_model, generator, compute_dtype)
        # flax LayerNorm's eps is 1e-6
        self.normalize = BatchNorm(d_model) if norm == "batch" else LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        if self.prenorm:
            x = self.normalize(x)
        # the SSM core always computes in float32 (a bfloat16 input reaches
        # here on a post-norm stack, straight from the encoder)
        x = self.seq(at_least_float32(x))
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
                 prenorm: bool = True, norm: str = "layer", dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = DenseEmbed(d_input, d_model, generator, compute_dtype)
        self.layers = nn.ModuleList(
            SequenceLayer(ssm, d_model, generator, activation, prenorm, norm, dropout,
                          compute_dtype)
            for _ in range(n_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder(x)
        for layer in self.layers:
            x = layer(x)
        return x


def masked_meanpool(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean over the valid prefix of the time axis (``masked_meanpool``):
    x (B, L, d), lengths (B,) float32 → (B, d), the masked sum divided by
    the lengths."""
    mask = torch.arange(x.shape[-2], device=x.device)[None, :] < lengths[:, None]
    return (mask[..., None] * x).sum(-2) / lengths[:, None]


class ClassificationModel(nn.Module):
    """Backbone + pooling + Dense decoder + log-softmax, or logits when
    ``logits_output`` is set (``ClassificationModel``).  With ``padded`` the
    input is ``(inputs, lengths)``, which ``pooling: last`` refuses when
    called, as flax's module does.
    ``.train()`` is flax's ``training=True``.  With ``compute_dtype`` the
    logits are bfloat16 (the decoder's dtype); the loss reduces them in
    float32."""

    def __init__(self, ssm, d_output: int, d_model: int, n_layers: int, d_input: int,
                 generator: torch.Generator, activation: str = "full_glu",
                 pooling: str = "none", prenorm: bool = True, norm: str = "layer",
                 logits_output: bool = False, dropout: float = 0.0, padded: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if pooling not in ("mean", "last", "none"):
            raise NotImplementedError("pooling must be in ['mean', 'last', 'none']")
        self.pooling, self.padded, self.logits_output = pooling, padded, logits_output
        self.encoder = StackedEncoderModel(
            ssm, d_model, n_layers, d_input, generator, activation, prenorm, norm, dropout,
            compute_dtype
        )
        self.decoder = dense(d_model, d_output, generator, compute_dtype)

    def features(self, x) -> torch.Tensor:
        """Backbone features before pooling and the decoder (``features``),
        which the sparse decoder head gathers from."""
        if self.padded:
            x, _ = x
        return self.encoder(x)

    def forward(self, x) -> torch.Tensor:
        if self.padded:
            x, lengths = x
        x = self.encoder(x)
        shard = sp_shard()
        if shard is not None and self.pooling in ("mean", "last"):
            # the pool over the group's time steps (parallel/sp.py::sp_pool)
            from ..parallel.sp import sp_pool

            if self.pooling == "last" and self.padded:
                raise NotImplementedError(
                    "pooling='last' with padded sequences is not supported")
            x = sp_pool(x, self.pooling, shard, lengths if self.padded else None)
        elif self.pooling == "mean":
            x = masked_meanpool(x, lengths) if self.padded else x.mean(-2)
        elif self.pooling == "last":
            if self.padded:
                raise NotImplementedError(
                    "pooling='last' with padded sequences is not supported")
            x = x[..., -1, :]
        x = self.decoder(x)
        if self.logits_output:
            return x
        return F.log_softmax(x, dim=-1)
