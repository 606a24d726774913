"""The transformer family, counterpart of ``tlie_tpu/models/transformer.py``
(``TransformerBlock`` at ``:24``, ``Transformer`` at ``:138``) with softmax,
linear or norm attention (``attention_fn``: ``sm-attention``,
``lin-attention``, ``norm-attention``).

A block is ``x + drop(attention(norm(x)))`` then ``norm`` again and the
mixer; with ``mixer: none`` it returns ``norm(x + drop(attention(norm(x))))``
(no second residual), with ``mixer: glu`` ``x + glu(norm(x))``, with
``mixer: mlp`` ``x + mlp(norm(x))`` (``MLP``: ``mixer_dim`` wide, the
block's dropout after the GELU and after the second projection) and with
``mixer: hybrid`` ``x + lambda(norm(x))`` (``LAMBDA`` with α at σ⁻¹(0.2),
the block's dropout inside it; under bf16 compute its float32 α makes the
mixer's output, and so the residual stream after it, float32, as in
``tlie_tpu``).  With
``use_gate`` the block's *input* also goes through ``Wz`` (xavier-uniform of
gain 0.1, bias 1), and the block's output is multiplied by SiLU of it: the
mixer's output alone with ``mixer: none``, the residual sum otherwise.  Both
LayerNorms of a block are one module, ``layers.{i}.norm``, so they share
weights: the reference's quirk, kept.  The model is token (+ position)
embeddings, or with ``embedding: false`` a dense ``input_dim`` →
``hidden_dim`` encoder (``encoder.{weight,bias}``, torch's default init, in
the compute dtype, no position table) of float features (B, L,
``input_dim``), then element-wise dropout, the blocks and a final LayerNorm, then a
bias-free per-position decoder, or with ``classifier: true`` the
``ClassifierHead`` (``pooling`` over time, no mask, then ``mixer_dim`` →
ReLU → classes); it returns logits.  A padded batch, ``(tokens,
lengths)``, runs as its tokens alone: the lengths are dropped, as
``tlie_tpu`` and the reference drop them.  With ``dual: true`` (AAN
retrieval, which needs ``classifier: true``) a batch of pairs, tokens (B,
2, L), is folded into (2B, L) documents before the encoder, and the
classifier's 2B rows go through ``MATCH(mixer_dim, output_dim)`` as B
pairs.  Parameter names are the
reference's torch names (``encoder.word_embeddings``,
``encoder.position_embeddings``, ``layers.{i}.attention.{Wqkv,out_proj}``,
for norm attention ``layers.{i}.attention.{Wvqkn,offset}``,
``layers.{i}.Wz``, ``layers.{i}.norm``,
``layers.{i}.mixer.{linear,encoder,decoder,alpha}``, ``norm``, ``decoder`` or
``classifier.{encoder,decoder}``, ``match.{encoder,middle,decoder}``).

Weights are drawn from an explicit ``torch.Generator`` with the reference's
distributions.  ``model.compute_dtype: bfloat16`` is flax's ``dtype=`` of
``tlie_tpu``'s transformer (``transformer.py:40-105``, ``:150-173``): the
token embeddings, ``Wz``, the mixers (:mod:`.attention_layers`), the MLP
and GLU mixers and the bias-free decoder compute in bfloat16 on casts of
their float32 parameters; the block's LayerNorm and the final one compute
in float32 and give float32, as flax's do (``:115-135``); the classifier
head and ``MATCH`` take no dtype and compute in float32.  The residual
stream keeps the dtype PyTorch promotes it to: bfloat16 from the encoder
onwards where the mixer adds its output back.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention_layers import MHA, MHNA
from .layers import (
    GLU, LAMBDA, MATCH, MLP, ClassifierHead, Dropout, LayerNorm, Linear, TokenEmbeddings,
    compute_dtype_of, fold_pairs, linear, uniform_,
)


class TransformerBlock(nn.Module):
    """One pre-norm attention block (``TransformerBlock``), with flax's
    LayerNorm (eps 1e-5, biased variance, the same as ``nn.LayerNorm``; its
    statistics and output in at least float32)."""

    def __init__(self, hidden_dim: int, cfg: Dict[str, Any], generator: torch.Generator):
        super().__init__()
        attention_fn = cfg["attention_fn"]
        dtype = compute_dtype_of(cfg)
        common = dict(d_qk=cfg["state_dim"], num_heads=cfg["num_heads"],
                      dropout=cfg.get("att_dropout", 0.0), conv_type=cfg.get("conv_type", "full"),
                      compute_dtype=dtype)
        if attention_fn in ("sm-attention", "lin-attention"):
            self.attention = MHA(hidden_dim, generator, dim_conv=cfg.get("dim_conv", 0),
                                 lin_att=attention_fn == "lin-attention",
                                 use_flash=cfg.get("use_flash", False), **common)
        elif attention_fn == "norm-attention":
            self.attention = MHNA(hidden_dim, generator, norm_fn=cfg["norm_fn"],
                                  approx_fn=cfg["approx_fn"], scale_B=cfg["scale_B"],
                                  offset=cfg["offset"], offset_init=cfg["offset_init"],
                                  dim_conv=cfg["dim_conv"], **common)
        else:
            raise RuntimeError(f"attention_fn {attention_fn} not implemented")
        self.Wz = None
        if cfg.get("use_gate", False):
            # xavier_uniform_(gain=0.1), bias 1.0: tlie_tpu's
            # variance_scaling(0.01, "fan_avg", "uniform")
            self.Wz = Linear(hidden_dim, hidden_dim)
            self.Wz.compute_dtype = dtype
            uniform_(self.Wz.weight, 0.1 * math.sqrt(6.0 / (2 * hidden_dim)), generator)
            with torch.no_grad():
                self.Wz.bias.fill_(1.0)
        mixer = cfg["mixer"]
        if mixer == "hybrid":
            self.mixer = LAMBDA(hidden_dim, generator, init=0.2, dropout=cfg["dropout"],
                                compute_dtype=dtype)
        elif mixer == "mlp":
            self.mixer = MLP(hidden_dim, cfg["mixer_dim"], generator, cfg["dropout"], dtype)
        elif mixer == "glu":
            self.mixer = GLU(hidden_dim, generator, dtype)
        elif mixer == "none":
            self.mixer = None
        else:
            raise RuntimeError(f"{mixer} mixer not implemented yet!")
        if cfg["norm"] != "layer":
            raise RuntimeError(f"{cfg['norm']} norm not implemented yet!")
        self.norm = LayerNorm(hidden_dim, eps=1e-5)
        self.drop = Dropout(cfg["dropout"])

    def mix(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The second half of the block on the residual stream x: norm, the
        mixer, and the residual unless the mixer is ``none``; times SiLU(z)
        where the block has its gate (z = Wz of the block's input)."""
        y = self.norm(x)
        if self.mixer is not None:
            y = x + self.mixer(y)
        return y if z is None else y * F.silu(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = None if self.Wz is None else self.Wz(x)
        x = x + self.drop(self.attention(self.norm(x)))
        return self.mix(x, z)


class Transformer(nn.Module):
    """Embeddings → dropout → N × TransformerBlock → LayerNorm → the
    per-position decoder, or the classifier head with ``classifier: true``
    (then ``MATCH`` over the pairs with ``dual: true``) (``Transformer``);
    returns logits."""

    def __init__(self, cfg: Dict[str, Any], generator: torch.Generator):
        super().__init__()
        hidden = cfg["hidden_dim"]
        dtype = compute_dtype_of(cfg)
        if cfg.get("embedding", False):
            self.encoder = TokenEmbeddings(hidden, cfg["vocab_size"], generator,
                                           cfg.get("max_pos_embed", 0), compute_dtype=dtype)
        else:
            self.encoder = linear(cfg["input_dim"], hidden, generator, compute_dtype=dtype)
        self.layers = nn.ModuleList(
            TransformerBlock(hidden, cfg, generator) for _ in range(cfg["num_layers"]))
        if cfg.get("classifier", False):
            self.classifier = ClassifierHead(hidden, cfg["mixer_dim"], cfg["output_dim"],
                                             cfg["pooling"], generator)
        else:
            self.decoder = linear(hidden, cfg["output_dim"], generator, bias=False,
                                  compute_dtype=dtype)
        self.dual = bool(cfg.get("dual", False))
        if self.dual and hasattr(self, "classifier"):  # flax makes it only where it is used
            self.match = MATCH(cfg["output_dim"], cfg["mixer_dim"], cfg["output_dim"], generator)
        if cfg["norm"] != "layer":
            raise RuntimeError(f"{cfg['norm']} norm not implemented yet!")
        self.norm = LayerNorm(hidden, eps=1e-5)
        self.drop = Dropout(cfg["dropout"])

    def features(self, x) -> torch.Tensor:
        """Backbone features before the head (``features``); a padded batch's
        lengths are dropped, and a dual model's pairs folded into the
        batch."""
        if isinstance(x, tuple):
            x, _ = x
        if self.dual:
            x = fold_pairs(x)
        x = self.drop(self.encoder(x))
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)

    def forward(self, x) -> torch.Tensor:
        if not hasattr(self, "classifier"):
            return self.decoder(self.features(x))
        x = self.classifier(self.features(x))
        return self.match(x) if self.dual else x
