"""Shared blocks of the Mamba and transformer families, counterparts of
``tlie_tpu/models/layers.py``: the torch default initialisers drawn from an
explicit ``torch.Generator``, ``GLU``, ``MLP``, the transformer's
``LAMBDA`` (the transformer's ``hybrid`` mixer), ``ClassifierHead``, the
retrieval head ``MATCH`` and the pair fold of the
dual models (:func:`fold_pairs`), ``TokenEmbeddings`` (with the
transformer's position table), ``DepthwiseCausalConv`` and the
element-wise ``Dropout``.

Module and parameter names are the reference's torch names, so a port
``state_dict`` maps onto the flax tree through
``tlie_tpu/analysis/compat.py::torch_state_dict_to_flax`` and through
:mod:`tlie_tpu_torch.compat`.

``compute_dtype`` (``Linear``, ``GLU``, ``MLP``, ``LAMBDA``, ``TokenEmbeddings``,
``DepthwiseCausalConv``) is flax's ``dtype=`` of the same module: None
computes in the parameters' dtype; ``torch.bfloat16`` casts the input and
the parameters to bfloat16 and computes there, while the parameters stay
float32 (``model.compute_dtype: bfloat16``).  ``ClassifierHead`` and
``MATCH`` take none, as in ``tlie_tpu``: they compute in float32 on their
promoted input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import depthwise_causal_conv1d
from ..ops.scan import sp_shard


def compute_dtype_of(cfg) -> Optional[torch.dtype]:
    """flax's ``dtype=`` of a model config: bfloat16 for ``compute_dtype:
    bfloat16``, else None (the parameters' float32)."""
    return torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """x promoted to float32 or wider: what flax's norms compute on (and
    give back) beside float32 parameters."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` on float32 parameters: the input is widened to
    at least float32 first, so the statistics and the output are float32
    under a bfloat16 compute dtype too, where ``nn.LayerNorm`` would return
    a bfloat16 input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(at_least_float32(x))


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
    ``Dense(dtype=...)``): x, the weight and the bias cast to it.  The bias
    joins the product before its one rounding (one ``addmm``, the bias in
    the GEMM's epilogue on the card), where flax rounds the product and then
    adds the bias: the two differ by at most one rounding of the output,
    inside the bf16 tolerances the tests state."""

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


class MLP(nn.Module):
    """Dense(``mlp_dim``) → exact erf GELU → Dropout → Dense(d) → Dropout
    (``MLP``): ``encoder`` and ``decoder`` with torch's default init, the
    two Dropouts independent masks."""

    def __init__(self, d: int, mlp_dim: int, generator: torch.Generator, dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = linear(d, mlp_dim, generator, compute_dtype=compute_dtype)
        self.decoder = linear(mlp_dim, d, generator, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.decoder(self.drop(F.gelu(self.encoder(x)))))


class LAMBDA(nn.Module):
    """A learned convex combination of a GLU and an MLP sharing one encoder
    (``LAMBDA``, ``tlie_tpu/models/layers.py:81-106``): ``encoder`` (d → 2d,
    torch's default init) gives xz; the GLU half is xz[:d]·σ(xz[d:]), the
    MLP half ``decoder`` (2d → d) of dropout(GELU(xz)) (the exact erf GELU on
    all of xz); the output is dropout(a·glu + (1 − a)·mlp) with a = σ(α).
    ``alpha`` is a float32 parameter of shape (1,) set to logit(``init``):
    beside bfloat16 halves it promotes the mix to float32, as ``jnp``
    promotes it (a 0-d α would leave the mix in bfloat16).  The two
    dropouts draw independent masks."""

    def __init__(self, d: int, generator: torch.Generator, init: float = 0.5,
                 dropout: float = 0.0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d = d
        self.encoder = linear(d, 2 * d, generator, compute_dtype=compute_dtype)
        self.alpha = nn.Parameter(torch.full((1,), -math.log(1.0 / init - 1.0)))
        self.decoder = linear(2 * d, d, generator, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xz = self.encoder(x)
        a = torch.sigmoid(self.alpha)
        glu = xz[..., : self.d] * torch.sigmoid(xz[..., self.d :])
        mlp = self.decoder(self.drop(F.gelu(xz)))
        return self.drop(a * glu + (1 - a) * mlp)


class ClassifierHead(nn.Module):
    """Pooling over time, then where ``mlp_dim`` ≠ 0 ``encoder`` (to
    ``mlp_dim``) → ReLU → ``decoder`` (to ``num_classes``) with torch's
    default init (``ClassifierHead``).  ``pooling`` is ``mean``, ``max``,
    ``sum`` or ``cls`` (the first position); any other value pools nothing.
    The pool takes no mask: a padded batch is pooled over its padding too,
    as in ``tlie_tpu`` and the reference.  Under the ``sequence_parallel``
    context the pool spans the group's time steps
    (:func:`tlie_tpu_torch.parallel.sp.sp_pool`)."""

    def __init__(self, d: int, mlp_dim: int, num_classes: int, pooling: str,
                 generator: torch.Generator):
        super().__init__()
        self.pooling = pooling
        self.encoder = self.decoder = None
        if mlp_dim != 0:
            self.encoder = linear(d, mlp_dim, generator)
            self.decoder = linear(mlp_dim, num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = sp_shard()
        if shard is not None and self.pooling in ("mean", "max", "sum", "cls"):
            from ..parallel.sp import sp_pool

            x = sp_pool(x, self.pooling, shard)
        elif self.pooling == "mean":
            x = x.mean(dim=-2)
        elif self.pooling == "max":
            x = x.amax(dim=-2)
        elif self.pooling == "sum":
            x = x.sum(dim=-2)
        elif self.pooling == "cls":
            x = x[..., 0, :]
        if self.encoder is None:
            return x
        return self.decoder(F.relu(self.encoder(x)))


def fold_pairs(x):
    """A retrieval batch of pairs, integer tokens (B, 2, L), as (2B, L): the
    first documents, then the second ones (the dual models' fold,
    ``tlie_tpu/models/transformer.py:189-193``); any other input as it
    is."""
    if torch.is_tensor(x) and x.dim() == 3 and not torch.is_floating_point(x):
        return torch.cat([x[:, 0], x[:, 1]], dim=0)
    return x


class MATCH(nn.Module):
    """The retrieval head (``MATCH``): the two halves of a folded batch's
    rows side by side, (B, 2d), then ``encoder`` (to ``mlp_dim``) → ReLU →
    ``middle`` (to ``mlp_dim // 2``) → ReLU → ``decoder`` (to
    ``output_dim``), torch's default init.  It computes in float32 at
    least, as flax's ``Dense`` promotes a bfloat16 input."""

    def __init__(self, d: int, mlp_dim: int, output_dim: int, generator: torch.Generator):
        super().__init__()
        self.encoder = linear(2 * d, mlp_dim, generator)
        self.middle = linear(mlp_dim, mlp_dim // 2, generator)
        self.decoder = linear(mlp_dim // 2, output_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = torch.chunk(x, 2, dim=0)
        x = torch.cat([x1, x2], dim=-1)
        x = x.to(torch.promote_types(x.dtype, self.encoder.weight.dtype))
        return self.decoder(F.relu(self.middle(F.relu(self.encoder(x)))))


class TokenEmbeddings(nn.Module):
    """Learnable token embeddings plus, where ``max_position_embeddings`` >
    0, learnable position embeddings (``TokenEmbeddings``), both N(0, 1).
    The Mamba family passes 0, so it has no position table.  A position past
    the table raises (``F.embedding``'s ``IndexError``); the reference's
    gather fills NaN there.  Float inputs raise flax ``Embed``'s
    ``ValueError``: the six CIFAR norm-attention YAMLs set ``embedding:
    true`` without the dataset's ``tokenize: true``, so their pixels reach
    the table as floats, and ``tlie_tpu`` raises there too.  Under the
    ``sequence_parallel`` context the default positions start at this
    rank's first time step."""

    def __init__(self, embed_dim: int, vocab_size: int, generator: torch.Generator,
                 max_position_embeddings: int = 0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.word_embeddings = torch_embed_init(nn.Embedding(vocab_size, embed_dim), generator)
        self.position_embeddings = (
            torch_embed_init(nn.Embedding(max_position_embeddings, embed_dim), generator)
            if max_position_embeddings > 0 else None)
        self.compute_dtype = compute_dtype

    def _embed(self, table: nn.Module, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the table, cast to ``compute_dtype`` first as flax's
        ``Embed(dtype=...)`` casts its table.  Under tensor parallelism the
        token table is this rank's rows
        (:class:`~tlie_tpu_torch.parallel.tp.VocabParallelEmbedding`), which
        takes the cast table in its own lookup."""
        if self.compute_dtype is None:
            return table(ids)
        weight = table.weight.to(self.compute_dtype)
        if getattr(table, "vocab_parallel", False):
            return table(ids, weight)
        return F.embedding(ids, weight)

    def forward(self, input_ids: torch.Tensor, position_ids=None) -> torch.Tensor:
        if input_ids.is_floating_point():
            raise ValueError("Input type must be an integer or unsigned integer.")
        emb = self._embed(self.word_embeddings, input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                L = input_ids.shape[-1]
                shard = sp_shard()
                start = 0 if shard is None else shard.rank * L
                position_ids = torch.arange(start, start + L, device=input_ids.device)
            emb = emb + self._embed(self.position_embeddings, position_ids)
        return emb


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training mode an element-wise keep mask,
    the kept values scaled by 1/(1-rate); the identity in evaluation.  Masks
    come from ``generator`` (the device's default generator when None),
    which ``build_models`` sets to the model's dropout generator.  Under the
    data-parallel route (``shard``) every rank draws the global batch's mask
    from the same generator state and keeps its own rows, so the masks are
    the one-process run's (a dual model's pair fold reorders the rows, so
    its masks are not).  Under the sequence-parallel route (a shard of time
    steps) every rank draws the whole sequence's mask and keeps its steps
    (axis 1, the time axis of every input a dropout takes); a mask shared
    across time (``time_shared``) is the same on every rank."""

    # the route's shard (tlie_tpu_torch.parallel.mesh.Shard), set by the
    # training loop on its train model: x then holds the shard's rows (or
    # time steps) of the global batch, and the mask is the global mask's part
    shard = None
    time_shared = False

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
        shape = self.mask_shape(x)
        if self.generator is None:
            # out of place, so that under torch.func.vmap(randomness="different")
            # each point of a stacked grid draws its own mask
            mask = torch.bernoulli(torch.full(shape, keep, device=x.device, dtype=x.dtype))
        else:
            part = self.shard is not None and not (self.shard.axis and self.time_shared)
            if part:  # the whole batch's mask, then this rank's part
                shape = self.shard.whole(shape)
            mask = torch.empty(shape, device=x.device, dtype=x.dtype)
            mask.bernoulli_(keep, generator=self.generator)
            if part:
                mask = self.shard.part(mask)
        return x * mask / keep


class DepthwiseCausalConv(nn.Module):
    """Depthwise causal conv parameters around
    :func:`tlie_tpu_torch.ops.conv.depthwise_causal_conv1d`, in
    ``nn.Conv1d(groups=C)``'s layout: ``weight`` (C, 1, K), ``bias`` (C,),
    both U(±1/√K) as torch's default.  Under the ``sequence_parallel``
    context x is this rank's time steps, and the convolution reads the K − 1
    steps before them from the ranks that hold them
    (:func:`tlie_tpu_torch.parallel.sp.sp_causal_conv`)."""

    def __init__(self, dim: int, kernel_size: int, generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = 1.0 / math.sqrt(kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(dim, 1, kernel_size), k, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(dim), k, generator))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        weight, bias = self.weight, self.bias
        if dt is not None:
            x, weight, bias = x.to(dt), weight.to(dt), bias.to(dt)
        shard = sp_shard()
        if shard is not None:
            from ..parallel.sp import sp_causal_conv

            return sp_causal_conv(x, lambda t: depthwise_causal_conv1d(t, weight, bias),
                                  weight.shape[-1] - 1, shard)
        return depthwise_causal_conv1d(x, weight, bias)
