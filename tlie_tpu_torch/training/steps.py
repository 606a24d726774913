"""One training step and the per-batch pieces around it, counterparts of
``tlie_tpu/training/steps.py`` (``cross_entropy_loss``, ``compute_accuracy``,
``prep_batch``, ``train_step``) and of the sparse and fused decoder heads of
``tlie_tpu/training/scan_loop.py`` (:222-269).  A pooled classifier's
(B, classes) logits and (B,) labels go through the same masked CE, every
label valid: the mean CE over the batch."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.base import masked_accuracy as compute_accuracy
from ..ops.fused_xent import fused_softmax_xent
from ..parallel.tp import vocab_parallel_nll
from .state import clip_by_global_norm_, clipped_parameters, set_group_learning_rates

IGNORE_IDX = -100


# rows of bfloat16 logits widened to float32 at a time by RowNLLWide
WIDE_ROWS = 1024


class RowNLLWide(torch.autograd.Function):
    """lse − logit[label] of each row of bfloat16 (M, V) logits, reduced in
    float32 as ``tlie_tpu`` reduces them (``steps.py:41-44``, where XLA fuses
    the cast into the reduction): WIDE_ROWS rows are widened at a time, so no
    float32 copy of the whole logits cube is made or kept.  The backward
    recomputes softmax − onehot from the saved bfloat16 logits and the float32
    lse, in float32, and rounds it to bfloat16 once, as the cast's VJP does.
    ``apply`` returns (nll, lse), lse not differentiable; both passes are
    plain PyTorch, so a stacked sweep's ``vmap`` batches them as they are
    (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(logits, safe):
        lse = torch.cat([torch.logsumexp(logits[r:r + WIDE_ROWS].float(), -1)
                         for r in range(0, logits.shape[0], WIDE_ROWS)])
        picked = torch.gather(logits, -1, safe[:, None])[:, 0].float()
        return lse - picked, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, safe = inputs
        ctx.save_for_backward(logits, safe, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _dlse):
        logits, safe, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for r in range(0, logits.shape[0], WIDE_ROWS):
            rows = slice(r, r + WIDE_ROWS)
            t = torch.exp(logits[rows].float() - lse[rows, None]) * g[rows, None]
            t.scatter_add_(-1, safe[rows, None], -g[rows, None])
            grad[rows] = t
        return grad, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_idx: int = IGNORE_IDX, shard=None, vocab=None) -> torch.Tensor:
    """Mean CE over the positions whose label is not ``ignore_idx``:
    logsumexp minus the gathered logit, summed over valid positions and
    divided by their count (at least 1).  bfloat16 logits reduce in float32
    (:class:`RowNLLWide`).  With ``shard`` (the data- or sequence-parallel
    route's :class:`~tlie_tpu_torch.parallel.mesh.Shard`) the count is the
    global batch's, summed over the group: the loss is this rank's share of
    the global mean, and the shares sum to it.  Under the sequence-parallel
    route a pooled model's logits and labels (no time axis) are the whole
    batch's on every rank, so each rank's share is 1/n of the loss.  With
    ``vocab`` (tensor parallelism, the model group's shard) the logits are
    this rank's columns of the vocabulary and the logsumexp spans the model
    group (:func:`~tlie_tpu_torch.parallel.tp.vocab_parallel_nll`)."""
    safe = labels.clamp_min(0)
    mask = labels != ignore_idx
    if vocab is not None:
        ll = -vocab_parallel_nll(logits, torch.where(mask, labels, -1), vocab)
    elif logits.dtype == torch.bfloat16:
        nll = RowNLLWide.apply(logits.reshape(-1, logits.shape[-1]), safe.reshape(-1))[0]
        ll = -nll.reshape(labels.shape)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
        ll = picked - lse
    ll = torch.where(mask, ll, torch.zeros_like(ll))
    if shard is None:
        count = mask.sum()
    elif shard.axis and labels.dim() < 2:
        count = mask.sum() * shard.world
    else:
        count = shard.sum(mask.sum())
    return -ll.sum() / count.clamp_min(1)


def sparse_positions(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) positions of the valid (non-ignored) labels of each row, in
    index order, then leading invalid positions if a row has fewer than k.
    ``lax.top_k`` on the 0/1 mask breaks ties toward the lower index; a
    stable descending sort gives the same positions (``torch.topk`` promises
    no order among ties)."""
    valid = (labels != IGNORE_IDX).to(torch.int32)
    return torch.sort(valid, dim=1, descending=True, stable=True).indices[:, :k]


def head_logits(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                sparse_k: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, labels) of the decoder head.  With ``sparse_k`` the k valid
    positions of each row are gathered from the backbone features *before*
    the decoder matmul; ignored positions have zero gradient through the
    logits, so the loss and gradients are those of the dense head."""
    if sparse_k is None:
        return model(x), y
    return sparse_head(model, model.features(x), y, sparse_k)


def sparse_head(model: nn.Module, feats: torch.Tensor, y: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder on the features (B, L, d) at the k valid positions of
    each row of y (B, L), and the labels there."""
    pos = sparse_positions(y, k)
    feats = torch.gather(feats, 1, pos[..., None].expand(-1, -1, feats.shape[-1]))
    return model.decoder(feats), torch.gather(y, 1, pos)


def seq_head_logits(model: nn.Module, shard, x, y: torch.Tensor,
                    sparse_k: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`head_logits` of the whole batch (x, y) under the
    sequence-parallel route, for the eval, inside the ``sequence_parallel``
    context: this rank's time steps of x go through the model; a
    per-position head's outputs (the logits, or the features before the
    sparse head) are gathered over the group's steps, so every rank holds
    the whole batch's and the dataset's metric reads them as in one process;
    a pooled model's logits are the whole batch's already."""
    from ..parallel.sp import sp_inputs

    xs = sp_inputs(x, shard)
    if y.dim() < 2:
        return model(xs), y
    if sparse_k is None:
        return shard.gather_steps(model(xs)), y
    return sparse_head(model, shard.gather_steps(model.features(xs)), y, sparse_k)


def fused_head_loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                    shard=None) -> torch.Tensor:
    """The loss through the fused decoder + CE head (``_fused_loss``,
    ``scan_loop.py:252-269``): the backbone features on (B·L, d) rows,
    then ``fused_softmax_xent`` with the decoder's weight read in place
    (``weight.t()``, no copy) and its bias, or zeros where it has none.
    Where the decoder computes in bfloat16 (``model.compute_dtype:
    bfloat16``), the features, the weight and the bias are cast to it first,
    as ``_fused_loss`` casts them to ``fused_head_dtype``: the (V, D) weight
    is cast and then transposed, so the kernels read its bfloat16 rows in
    place, and the casts' backward widens the bfloat16 dW and db into the
    float32 parameters' gradients.  The features run in the model's own
    mode, so a training-mode BatchNorm updates its running statistics here
    as in the dense and sparse heads (the reference's fused head fails on
    BatchNorm models; this one does not).  ``shard`` as in
    :func:`cross_entropy_loss`."""
    feats = model.features(x)
    d = feats.shape[-1]
    dec = model.decoder
    dtype = getattr(dec, "compute_dtype", None) or torch.float32
    w = dec.weight.to(dtype).t()
    b = (dec.bias.to(dtype) if dec.bias is not None
         else torch.zeros(w.shape[1], device=w.device, dtype=dtype))
    return fused_softmax_xent(feats.reshape(-1, d).to(dtype), w, b, y.reshape(-1), shard)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, lrs: Dict[str, float],
               sparse_k: Optional[int] = None, fused_head: bool = False,
               clip_norm: Optional[float] = None, shard=None) -> torch.Tensor:
    """One optimisation step of ``model`` (in training mode) on the batch:
    the group learning rates are set, the gradients zeroed, the loss taken
    (its forward updates the BatchNorm running statistics, as flax's
    ``mutable=["batch_stats"]`` apply does), back-propagated, the
    ``regular`` group clipped to the global norm ``clip_norm`` where one is
    given (the Mamba and transformer families' optax chain), and the
    optimiser stepped.  The loss goes through the dense head, the sparse
    head (``sparse_k``) or the fused head (``fused_head``), which exclude
    each other.  Returns the loss, detached, on the device.

    ``shard`` (the data-parallel route's
    :class:`~tlie_tpu_torch.parallel.mesh.Shard`): x and y are this rank's
    rows of the global batch, the loss divides by the global valid count,
    and the gradients are summed over the group before the clip, so every
    rank takes the one-process step.  The returned loss is this rank's share
    of the global one.  A shard of time steps (the sequence-parallel route,
    called inside its context) takes x and per-position labels y at this
    rank's steps in the same way.  Under tensor parallelism ``shard`` is
    the data group's, and a model whose logits are split
    (``model.logit_shard``) takes the vocab-parallel CE; the clip adds the
    split leaves' squares over the model group."""
    if fused_head and sparse_k is not None:
        raise ValueError("the sparse head is mutually exclusive with the fused head")
    set_group_learning_rates(optimizer, lrs)
    optimizer.zero_grad(set_to_none=True)
    if fused_head:
        loss = fused_head_loss(model, x, y, shard)
    else:
        loss = cross_entropy_loss(*head_logits(model, x, y, sparse_k), shard=shard,
                                  vocab=getattr(model, "logit_shard", None))
    loss.backward()
    if shard is not None:
        shard.sum_grads(model.parameters())
    if clip_norm is not None:
        clip_by_global_norm_(clipped_parameters(optimizer), clip_norm)
    optimizer.step()
    return loss.detach()


def prep_batch(batch, seq_len: int, in_dim: int, lang_model: bool = False,
               device="cuda") -> Tuple[Any, torch.Tensor]:
    """Standardise a loader batch to (inputs, labels) tensors on ``device``.

    Inputs are right-padded to ``seq_len``.  Integer tokens pass through (the
    encoder gathers their rows); float inputs of width != ``in_dim`` are
    one-hot expanded, as in ``tlie_tpu``.  A classification batch with
    per-example lengths (``aux["lengths"]``, ListOps, IMDB) gives ``(inputs,
    lengths)`` as its inputs, the lengths in float32, for the SSM
    backbone's masked mean pool; the Mamba and transformer families take
    the pair and drop the lengths (``tlie_tpu/training/steps.py:80-96``).
    With ``lang_model`` the tokens come alone, as eval_eig's analysis
    batch does in ``tlie_tpu``.

    A retrieval batch of pairs, integer tokens (B, 2, L) (AAN), is not
    padded: its axis 1 is the pair, not time.  ``tlie_tpu``'s
    ``prep_batch`` pads that axis up to ``seq_len`` (``steps.py:82-85``),
    (B, 2, L) → (B, seq_len, L) tokens, B·seq_len·L at l_max 4000 where
    2·B·L are read; the dual models read only rows 0 and 1, so the logits
    are the same, and the port gives them without the padded copy."""
    if len(batch) == 2:
        inputs, targets = batch
        aux: Dict[str, Any] = {}
    else:
        inputs, targets, aux = batch
    inputs = torch.as_tensor(np.asarray(inputs), device=device)
    targets = torch.as_tensor(np.asarray(targets), device=device)
    lengths = aux.get("lengths") if isinstance(aux, dict) else None

    pairs = inputs.dim() == 3 and not torch.is_floating_point(inputs)
    num_pad = seq_len - inputs.shape[1]
    if num_pad > 0 and not pairs:
        pad = [0, 0] * (inputs.dim() - 2) + [0, num_pad]
        inputs = F.pad(inputs, pad)

    if inputs.dim() < 3 and inputs.shape[-1] != in_dim and torch.is_floating_point(inputs):
        inputs = F.one_hot(inputs.long(), in_dim).float()
    if lengths is not None and not lang_model and not np.isscalar(lengths):
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.float32, device=device)
        return (inputs, lengths), targets
    return inputs, targets
