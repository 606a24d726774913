"""Vocab tensor parallelism over processes, the port's counterpart of
``tlie_tpu/parallel/tp.py`` (ROADMAP Queue 1 item 17c).

``tlie_tpu`` splits the model-level vocabulary leaves (the token embedding
and the decoder head) over the ``model`` axis of a (data, model) mesh and
lets GSPMD insert the collectives.  The port runs one process a device in a
2-D layout of its process group (:func:`~.mesh.mesh_2d`): each rank holds
V/m rows of every split leaf (:func:`shard_vocab_parallel`), and the
collectives are written out here, each over the rank's model group:

- the embedding (:class:`VocabParallelEmbedding`): each rank looks up the
  tokens its rows hold, zeros elsewhere, and the model group sums them
  (the gather's psum); the backward reaches only the local rows;
- the decoder (:class:`VocabParallelLinear`): the features enter the model
  region through an identity whose backward sums dh over the model group
  (Megatron's f operator), so the replicated body's gradients are the whole
  head's on every model rank; each rank's logits are its V/m columns;
- the loss (:func:`vocab_parallel_cross_entropy`): the max, the sum of
  exp and the label's logit over the model group (the logsumexp's
  all-reduce); the backward is softmax − onehot on the local columns, with
  no collective;
- the accuracy (:func:`vocab_parallel_argmax`): the argmax over the shards,
  ties to the lowest global index as ``jnp.argmax``.

Partition rules are by parameter name, ``tlie_tpu``'s on the port's names
(:func:`vocab_partition_specs`): torch's ``Linear`` keeps (V, d), flax's
``Dense`` (d, V), so every split leaf splits along its dim 0.  A leaf the
model group's size does not divide raises ``ValueError``, as ``tlie_tpu``'s
placement does (every WikiText config's vocabulary, 50257, is odd).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Shard

# (name suffix, ndim) of the leaves split over the model group, along dim 0:
# word_embeddings (V, d), the decoder's weight (V, d) and bias (V,)
# (tlie_tpu/parallel/tp.py:35-39)
_VOCAB_RULES = ((("word_embeddings", "weight"), 2), (("decoder", "weight"), 2),
                (("decoder", "bias"), 1))
# the subtrees whose own small "decoder" stays replicated (tp.py:47)
_EXCLUDED_SEGMENTS = ("mixer", "match", "classifier", "attention", "glu_layer")


def _split_dim(name: str, ndim: int) -> Optional[int]:
    segs = name.split(".")
    # flax's layers_{i} / blocks_{i} are torch's layers.{i} / blocks.{i}
    if any(s in _EXCLUDED_SEGMENTS for s in segs) or any(
            a in ("layers", "blocks") and b.isdigit() for a, b in zip(segs, segs[1:])):
        return None
    for suffix, want in _VOCAB_RULES:
        if tuple(segs[-len(suffix):]) == suffix and ndim == want:
            return 0
    return None


def vocab_partition_specs(tree: Union[nn.Module, Mapping[str, torch.Tensor]]
                          ) -> Dict[str, Optional[int]]:
    """{name: the dim split over the model group, or None (replicated)} for
    every parameter of a model, or every entry of a state dict."""
    items = tree.named_parameters() if isinstance(tree, nn.Module) else tree.items()
    return {name: _split_dim(name, t.dim()) for name, t in items}


def _all_reduce(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """t summed over the shard's group (a new tensor); a 16-bit tensor is
    summed in float32 and rounded once."""
    out = t.to(torch.promote_types(t.dtype, torch.float32)).contiguous()
    if out is t:
        out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=shard.group)
    return out.to(t.dtype)


def _gather(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(world, *t.shape): every rank's t in rank order, one all-reduce of
    this rank's slot of a zero buffer (exact: each slot has one term)."""
    buf = t.new_zeros((shard.world, *t.shape))
    buf[shard.rank] = t
    dist.all_reduce(buf, group=shard.group)
    return buf


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each rank's columns of the head contribute their part of dh)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.shard), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward: the sum feeds
    the same replicated computation on every model rank, whose gradient is
    the same there."""

    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' last-axis columns joined in rank order; the backward takes
    this rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.n = shard, x.shape[-1]
        buf = _gather(x, shard)  # (world, ..., n)
        return buf.movedim(0, -2).reshape(*x.shape[:-1], shard.world * ctx.n)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.shard.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             shard: Shard) -> torch.Tensor:
    """The rows of the (V, d) table whose rows [rank·V/m, (rank+1)·V/m) this
    rank holds as ``weight``: each rank's rows of the tokens it holds, zeros
    for the others, summed over the model group."""
    n = weight.shape[0]
    local = ids - shard.rank * n
    inside = (local >= 0) & (local < n)
    out = F.embedding(local.clamp(0, n - 1), weight)
    return _ReduceFromModel.apply(out.masked_fill(~inside[..., None], 0), shard)


class VocabParallelEmbedding(nn.Module):
    """A token table's rows of this model rank (``weight``, (V/m, d)), in
    ``nn.Embedding``'s place; ``forward(ids, weight)`` takes the cast table
    a compute dtype gives it."""

    vocab_parallel = True

    def __init__(self, weight: torch.Tensor, shard: Shard):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.weight.vocab_shard = shard
        self.vocab_shard = shard

    def forward(self, ids: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        return vocab_parallel_embedding(ids, self.weight if weight is None else weight,
                                        self.vocab_shard)


class VocabParallelLinear(nn.Module):
    """A decoder's rows of this model rank (``weight`` (V/m, d), ``bias``
    (V/m,) or None), computing in ``compute_dtype`` where one is set, as
    :class:`~tlie_tpu_torch.models.layers.Linear`: x → x W_rᵀ + b_r, this
    rank's columns of the logits.  With ``gather_output`` the ranks'
    columns are joined (a dual model's ``MATCH`` reads the whole vector)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], shard: Shard,
                 compute_dtype: Optional[torch.dtype] = None, gather_output: bool = False):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        for p in self.parameters():
            p.vocab_shard = shard
        self.vocab_shard, self.compute_dtype = shard, compute_dtype
        self.gather_output = gather_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.vocab_shard)
        w, b, dt = self.weight, self.bias, self.compute_dtype
        if dt is not None:
            x, w, b = x.to(dt), w.to(dt), None if b is None else b.to(dt)
        y = F.linear(x, w, b)
        return _GatherFromModel.apply(y, self.vocab_shard) if self.gather_output else y


def shard_vocab_parallel(model: nn.Module, shard: Shard) -> nn.Module:
    """``model`` (built whole, from the config's generator) with its split
    leaves cut to this model rank's rows, in place: the model-level token
    table becomes a :class:`VocabParallelEmbedding` and the model-level
    decoder a :class:`VocabParallelLinear`.  ``model.logit_shard`` is the
    shard where the model's logits are this rank's columns (a per-position
    or pooled head), else None (no split decoder, or a dual model's, whose
    columns are joined for ``MATCH``).  Raises ``ValueError`` where the
    group's size does not divide a split leaf."""
    specs = vocab_partition_specs(model)
    split = [name for name, dim in specs.items() if dim is not None]
    for name in split:
        size = model.get_parameter(name).shape[0]
        if size % shard.world:
            raise ValueError(f"{name}: the global size of its dimension 0 should be divisible "
                             f"by {shard.world}, but it is equal to {size}")
    dual = bool(getattr(model, "dual", False))
    for path in dict.fromkeys(name.rsplit(".", 1)[0] for name in split):
        old = model.get_submodule(path)
        n = old.weight.shape[0] // shard.world
        rows = slice(shard.rank * n, (shard.rank + 1) * n)
        with torch.no_grad():
            weight = old.weight[rows].clone()
            if isinstance(old, nn.Embedding):
                new = VocabParallelEmbedding(weight, shard)
            else:
                bias = None if old.bias is None else old.bias[rows].clone()
                new = VocabParallelLinear(weight, bias, shard, getattr(old, "compute_dtype", None),
                                          gather_output=dual)
        parent, _, leaf = path.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, leaf, new)
    decoder = getattr(model, "decoder", None)
    model.logit_shard = (shard if isinstance(decoder, VocabParallelLinear)
                         and not decoder.gather_output else None)
    return model


class _VocabParallelNLL(torch.autograd.Function):
    """lse − logit[label] of each row of this rank's (M, V/m) logit
    columns, the lse over the model group's columns; a label outside this
    rank's columns (or negative: ignored) contributes nothing here.  Reduced
    in float32 or wider, 16-bit logits widened WIDE_ROWS rows at a time as
    ``training/steps.py::RowNLLWide`` widens them.  Backward: (softmax −
    onehot)·g on the local columns, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, shard):
        from ..training.steps import WIDE_ROWS

        M, n = logits.shape
        wide = torch.promote_types(logits.dtype, torch.float32)
        rows = WIDE_ROWS if logits.dtype != wide else max(M, 1)
        local = labels - shard.rank * n
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        # the global max (for exp's range), from every rank's row maxima
        top = _gather(logits.amax(-1).to(wide), shard).amax(0)
        sums = torch.cat([torch.exp(logits[r:r + rows].to(wide) - top[r:r + rows, None]).sum(-1)
                          for r in range(0, M, rows)]) if M else top.new_zeros(0)
        picked = torch.gather(logits, -1, idx[:, None])[:, 0].to(wide)
        both = _all_reduce(torch.stack([sums, torch.where(inside, picked, 0.0)]), shard)
        lse = top + torch.log(both[0])
        ctx.save_for_backward(logits, idx, inside, lse)
        ctx.rows = rows
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, idx, inside, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for r in range(0, logits.shape[0], ctx.rows):
            part = slice(r, r + ctx.rows)
            t = torch.exp(logits[part].to(lse.dtype) - lse[part, None]) * g[part, None]
            t.scatter_add_(-1, idx[part, None], torch.where(inside[part], -g[part], 0.0)[:, None])
            grad[part] = t
        return grad, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Per-position lse − logit[label] of split logits (..., V/m) with labels
    (...), over the model group; a negative label gives lse."""
    n = logits.shape[-1]
    nll = _VocabParallelNLL.apply(logits.reshape(-1, n), labels.reshape(-1), shard)
    return nll.reshape(labels.shape)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, shard: Shard,
                                 data: Optional[Shard] = None,
                                 ignore_idx: int = -100) -> torch.Tensor:
    """The masked mean CE of this model rank's logit columns (``shard``,
    the model group's), its count summed over the ``data`` group where one
    is given: ``training/steps.py::cross_entropy_loss`` on split logits."""
    from ..training.steps import cross_entropy_loss

    return cross_entropy_loss(logits, labels, ignore_idx, shard=data, vocab=shard)


@torch.no_grad()
def vocab_parallel_argmax(logits: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The global argmax over the last axis of split logits (..., V/m): each
    rank's largest value and its global index, gathered over the model
    group; the largest value wins, a tie the lowest global index, as
    ``jnp.argmax`` and ``torch.argmax`` take the first."""
    n = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    both = _gather(torch.stack([val.double(), (idx + shard.rank * n).double()]), shard)
    vals, gidx = both[:, 0], both[:, 1]
    first = (vals == vals.amax(0)).int().argmax(0)  # the first shard holding the max
    return torch.gather(gidx, 0, first[None])[0].long()


def vocab_parallel_metric(metric, shard: Shard):
    """The dataset's metric on split logits: the accuracies through
    :func:`vocab_parallel_argmax`, the perplexity from the split CE."""
    from ..data.base import argmax_accuracy, masked_accuracy, perplexity

    if metric is masked_accuracy:
        def split_metric(logits, labels, ignore_idx=-100):
            mask = labels != ignore_idx
            correct = (mask & (vocab_parallel_argmax(logits, shard) == labels)).sum()
            return correct / mask.sum().clamp_min(1)
    elif metric is argmax_accuracy:
        def split_metric(logits, labels):
            return (vocab_parallel_argmax(logits, shard) == labels).float().mean()
    elif metric is perplexity:
        def split_metric(logits, labels, ignore_idx=-100):
            return torch.exp(vocab_parallel_cross_entropy(logits, labels, shard,
                                                          ignore_idx=ignore_idx))
    else:
        raise NotImplementedError(f"no vocab-parallel form of the metric {metric!r}")
    return split_metric


def _split_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters()
            if getattr(p, "vocab_shard", None) is not None}


def _optimizer_params(optimizer: torch.optim.Optimizer):
    # the order of a state dict's parameter indices
    return [p for g in optimizer.param_groups for p in g["params"]]


def _map_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any], fn):
    """``state`` (an optimiser state dict) with ``fn`` applied to every
    per-parameter tensor of a split parameter (its moments, and the
    accumulator of ``train.param_group``'s group), as a new dict."""
    params = _optimizer_params(optimizer)
    split = {i for i, p in enumerate(params) if getattr(p, "vocab_shard", None) is not None}
    out = dict(state)
    out["state"] = {i: {k: fn(v) if i in split and torch.is_tensor(v) and v.dim() > 0 else v
                        for k, v in st.items()} for i, st in state["state"].items()}
    groups, offset = [], 0
    for group in state["param_groups"]:
        group = dict(group)
        if "acc" in group:
            group["acc"] = [fn(a) if offset + k in split else a for k, a in enumerate(group["acc"])]
        offset += len(group["params"])
        groups.append(group)
    out["param_groups"] = groups
    return out


@torch.no_grad()
def gather_vocab_parallel(model: nn.Module, shard: Shard,
                          optimizer: Optional[torch.optim.Optimizer] = None
                          ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]]]:
    """(the model's state dict, the optimiser's or None) in the one-process
    layout: every split leaf, and its moments, joined over the model group
    (a collective: every rank of the group calls it)."""
    split = _split_params(model)

    def join(t):
        return _gather(t.detach(), shard).reshape(shard.world * t.shape[0], *t.shape[1:])

    state = {k: join(v) if k in split else v.detach() for k, v in model.state_dict().items()}
    opt = None if optimizer is None else _map_optimizer_state(
        optimizer, optimizer.state_dict(), join)
    return state, opt


def slice_vocab_parallel(model: nn.Module, shard: Shard, state: Mapping[str, torch.Tensor],
                         optimizer: Optional[torch.optim.Optimizer] = None,
                         optimizer_state: Optional[Dict[str, Any]] = None):
    """The inverse of :func:`gather_vocab_parallel`: (the state dict, the
    optimiser state dict or None) of this model rank, cut from the
    one-process layout's."""
    split = _split_params(model)

    def cut(t):
        n = t.shape[0] // shard.world
        return t[shard.rank * n:(shard.rank + 1) * n].clone()

    local = {k: cut(v) if k in split else v for k, v in state.items()}
    opt = None if optimizer_state is None else _map_optimizer_state(
        optimizer, optimizer_state, cut)
    return local, opt
