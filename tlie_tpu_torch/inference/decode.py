"""Autoregressive serving for the LRU and the softmax transformer,
counterpart of ``tlie_tpu/inference/decode.py::Decoder`` (families ``lru``
and ``attention`` with ``sm-attention``).

The decode state of an LRU layer is the complex diagonal state h (B, N),
kept as a (re, im) pair; ``prefill`` runs the prompt through the
full-sequence path (on the card, the diagonal-scan kernel) and keeps the
last state, and ``step`` advances one token in O(1).  The decode state of a
transformer layer is its float32 KV cache, k (B, max_len, H, head_dim) and v
(B, max_len, H, v_dim), behind the conv's trailing K−1 inputs where the
layer has a conv; ``prefill`` runs the prompt through the full-sequence
attention (on the card, the flash forward kernel) and writes its k and v
into the cache, and ``step`` attends one token over the cache up to its
position, writing its k and v in place (the port updates the cache where
JAX returns a new one).  A position past the position table
(``max_pos_embed``) raises ``ValueError``: the reference's gather fills NaN
there.  ``stepwise_logits`` is the teacher-forced step path, the parity
surface against the full forward.

The decoder serves an eval-mode copy of the model it is given (embeddings,
norms, mixers, head): the weights as they were when it was built, as
``tlie_tpu``'s decoder serves the params tree it was handed.  The caller's
module is left as it was, in its own mode.  Only the sequence core differs
between the full-sequence and the one-token paths.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..models.backbone import glu_activation
from ..models.registry import build_models


class Decoder:
    """Per-token decoder for LRU and softmax-transformer weights.

    >>> dec = Decoder(model_cfg, state_dict)            # on the card
    >>> out = dec.generate(prompt_tokens, n_new=16)     # greedy

    ``params`` is a port ``state_dict`` (as ``compat.params_from_jax`` gives
    it) or a built model, which is copied, not changed."""

    def __init__(self, model_cfg: Dict[str, Any], params: Union[Mapping[str, torch.Tensor], nn.Module],
                 *, device="cuda"):
        cfg = dict(model_cfg)
        if cfg.get("classifier", False) or cfg.get("dual", False):
            raise ValueError("decode targets per-position LM heads "
                             "(classifier/dual models have no AR semantics)")
        if cfg["layer"] == "lru":
            if cfg.get("pooling", "none") != "none":
                raise ValueError("decode requires pooling: none")
            self.family, self.vocab, self.max_pos = "lru", cfg["input_dim"], 0
        elif cfg["layer"] == "transformer":
            if not cfg.get("embedding", False):
                raise ValueError("transformer decode requires a token encoder")
            if cfg["attention_fn"] != "sm-attention":
                raise NotImplementedError(f"decoding {cfg['attention_fn']} is not ported yet")
            self.family, self.vocab = "attention", cfg["vocab_size"]
            self.max_pos = cfg.get("max_pos_embed", 0)
        else:
            raise NotImplementedError(f"decoding {cfg['layer']!r} is not ported yet")
        self.cfg = cfg
        if isinstance(params, nn.Module):
            self.model = copy.deepcopy(params).eval()
        else:
            _, self.model, _ = build_models(cfg, generator=torch.Generator(), device=device)
            self.model.load_state_dict(params)
        self.device = next(self.model.parameters()).device
        if self.family == "lru":
            self._prep_ssm()

    # -- per-layer recurrence constants (computed once) --------------------

    @torch.no_grad()
    def _prep_ssm(self):
        self._ssm_consts = []
        for layer in self.model.encoder.layers:
            seq = layer.seq
            self._ssm_consts.append(dict(
                lam=seq.lam(), bn=seq.input_matrix(), c=(seq.C_re, seq.C_im), d=seq.D,
            ))

    def init_cache(self, bsz: int, max_len: Optional[int] = None):
        """Zero decode state: per LRU layer (h_re, h_im); per transformer
        layer ([conv tail,] k cache, v cache) for ``max_len`` positions."""
        if self.family == "lru":
            n = self.cfg["state_dim"]
            z = lambda: torch.zeros(bsz, n, device=self.device)  # noqa: E731
            return tuple((z(), z()) for _ in self.model.encoder.layers)
        if max_len is None:
            raise ValueError("the transformer's KV cache needs max_len")
        self._check_positions(max_len)
        layers = []
        for layer in self.model.layers:
            mha = layer.attention
            c = (torch.zeros(bsz, max_len, mha.num_heads, mha.head_dim, device=self.device),
                 torch.zeros(bsz, max_len, mha.num_heads, mha.v_dim, device=self.device))
            if mha.conv1d is not None:
                width, _, K = mha.conv1d.weight.shape
                c = (torch.zeros(bsz, K - 1, width, device=self.device),) + c
            layers.append(c)
        return tuple(layers)

    def _check_positions(self, n: int) -> None:
        """Positions 0 .. n−1 must lie in the position table."""
        if self.max_pos > 0 and n > self.max_pos:
            raise ValueError(f"{n} positions exceed max_pos_embed {self.max_pos}: the prompt "
                             f"and the new tokens must fit the position table")

    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids as an int64 tensor on the decoder's device; ids outside
        [0, vocab) raise instead of gathering garbage."""
        t = torch.as_tensor(tokens, device=self.device).long()
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= self.vocab):
            raise ValueError(
                f"token ids must lie in [0, {self.vocab}), got "
                f"[{int(t.min())}, {int(t.max())}]"
            )
        return t

    # -- one-token step ------------------------------------------------------

    @torch.no_grad()
    def step(self, cache, tok: torch.Tensor, pos: Optional[int] = None):
        """(cache, tokens (B,), pos) → (cache, logits (B, V)).  The LRU's
        state carries no position; the transformer's step needs ``pos``."""
        if self.family == "attention":
            return self._tf_step(cache, tok, pos)
        x = self.model.encoder.encoder(tok)
        new = []
        for layer, consts, c in zip(self.model.encoder.layers, self._ssm_consts, cache):
            skip = x
            if layer.prenorm:
                x = layer.normalize(x)
            x, c = self._ssm_core_step(consts, c, x)
            new.append(c)
            x = skip + glu_activation(layer, x)
            if not layer.prenorm:
                x = layer.normalize(x)
        return tuple(new), self.model.decoder(x)

    @staticmethod
    def _ssm_core_step(consts, c, u):
        lam_re, lam_im = consts["lam"]
        br, bi = consts["bn"]
        hr, hi = c
        bur, bui = u @ br.T, u @ bi.T
        nr = lam_re * hr - lam_im * hi + bur
        ni = lam_re * hi + lam_im * hr + bui
        cr, ci = consts["c"]
        y = nr @ cr.T - ni @ ci.T
        return y + consts["d"] * u, (nr, ni)

    def _tf_step(self, cache, tok, pos):
        """``_tf_step``: the embeddings at ``pos``, each block's one-token
        attention over its cache, the final norm and the decoder."""
        if pos is None:
            raise ValueError("the transformer's step needs the token's position")
        self._check_positions(pos + 1)
        if pos >= cache[0][-1].shape[1]:
            raise ValueError(f"position {pos} is past the KV cache of {cache[0][-1].shape[1]}")
        x = self.model.encoder(tok, torch.tensor(pos, device=self.device))
        new = []
        for layer, c in zip(self.model.layers, cache):
            a, c = self._mha_step(layer.attention, c, layer.norm(x), pos)
            new.append(c)
            x = layer.mix(x + a)
        return tuple(new), self.model.decoder(self.model.norm(x))

    @staticmethod
    def _mha_step(mha, c, x, pos):
        """``_mha_step``: one token's q attends over the cached k, v of
        positions 0 .. pos (its own k and v written at ``pos`` first)."""
        qkv = mha.Wqkv(x)
        if mha.conv1d is not None:
            pre = mha.conv_input(qkv)
            window = torch.cat([c[0], pre[:, None]], dim=1)  # (B, K, C)
            y = torch.einsum("bkc,ck->bc", window, mha.conv1d.weight[:, 0]) + mha.conv1d.bias
            qkv = mha.after_conv(qkv, y)
            c = (window[:, 1:],) + c[1:]
        q, k, v = mha.split(qkv)  # (B, H, D)
        kc, vc = c[-2], c[-1]
        kc[:, pos], vc[:, pos] = k, v
        scores = torch.einsum("bhd,blhd->bhl", q, kc[:, : pos + 1]) / math.sqrt(mha.head_dim)
        ctx = torch.einsum("bhl,blhd->bhd", torch.softmax(scores, dim=-1), vc[:, : pos + 1])
        return mha.project(ctx), c

    # -- full-sequence prefill -----------------------------------------------

    @torch.no_grad()
    def prefill(self, prompt, max_len: Optional[int] = None):
        """Run the prompt (B, L0) through the full-sequence path and build the
        decode cache from it (for the transformer, a KV cache of ``max_len``
        positions, L0 by default).  Returns (cache, logits at the last prompt
        position)."""
        prompt = self._tokens(prompt)
        if self.family == "attention":
            return self._tf_prefill(prompt, prompt.shape[1] if max_len is None else max_len)
        x = self.model.encoder.encoder(prompt)  # (B, L, d)
        cache = []
        for layer in self.model.encoder.layers:
            skip = x
            if layer.prenorm:
                x = layer.normalize(x)
            h = layer.seq.scan(x)  # the diagonal-scan kernel on the card
            cache.append((h[0][:, -1].contiguous(), h[1][:, -1].contiguous()))
            x = skip + glu_activation(layer, layer.seq.readout(h, x))
            if not layer.prenorm:
                x = layer.normalize(x)
        return tuple(cache), self.model.decoder(x[:, -1])

    def _tf_prefill(self, prompt, max_len: int):
        """``_tf_prefill``: the blocks over the whole prompt, each attention
        through ``causal_softmax_attention`` (the flash forward kernel on the
        card), its k and v written into the first L0 rows of the cache."""
        bsz, L = prompt.shape
        if max_len < L:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({L})")
        cache = list(self.init_cache(bsz, max_len))
        x = self.model.encoder(prompt)
        for i, layer in enumerate(self.model.layers):
            mha = layer.attention
            qkv = mha.Wqkv(layer.norm(x))
            c = cache[i]
            if mha.conv1d is not None:
                pre = mha.conv_input(qkv)
                K = mha.conv1d.weight.shape[-1]
                tail = pre[:, max(L - (K - 1), 0):]
                c[0][:, K - 1 - tail.shape[1]:] = tail  # front-padded for short prompts
                qkv = mha.after_conv(qkv, mha.conv1d(pre))
            q, k, v = mha.split(qkv)
            c[-2][:, :L], c[-1][:, :L] = k, v
            x = layer.mix(x + mha.project(mha.attend(q, k, v)))
        return tuple(cache), self.model.decoder(self.model.norm(x[:, -1]))

    # -- teacher-forced scan and generation ----------------------------------

    @torch.no_grad()
    def stepwise_logits(self, tokens) -> torch.Tensor:
        """tokens (B, L) → per-position logits (B, L, V) via the step path."""
        tokens = self._tokens(tokens)
        B, L = tokens.shape
        cache = self.init_cache(B, L)
        out = []
        for t in range(L):
            cache, logits = self.step(cache, tokens[:, t], t)
            out.append(logits)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def generate(self, prompt, n_new: int, temperature: float = 0.0) -> torch.Tensor:
        """Greedy generation: prompt (B, L0) → (B, L0 + n_new).  For the
        transformer L0 + n_new must fit ``max_pos_embed``.  Sampling
        (temperature, top-k, top-p) is not ported yet."""
        if temperature != 0.0:
            raise NotImplementedError("sampled generation is not ported yet; use temperature 0")
        prompt = self._tokens(prompt)
        L0 = prompt.shape[1]
        cache, logits = self.prefill(prompt, L0 + n_new)
        toks = []
        for i in range(n_new):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            if i + 1 < n_new:  # the last token needs no further step
                cache, logits = self.step(cache, tok, L0 + i)
        return torch.cat([prompt] + [t[:, None] for t in toks], dim=1)
