"""Autoregressive serving for the SSM families (LRU, S5, S4) and the
transformers (softmax, linear and norm attention), counterpart of
``tlie_tpu/inference/decode.py::Decoder`` (families ``lru``, ``s5``, ``s4``
and ``attention``).

The decode state of an LRU or S5 layer is the complex diagonal state h (B,
N), or (B, P), kept as a (re, im) pair; ``prefill`` runs the prompt through
the full-sequence path (on the card, the diagonal-scan kernel) and keeps
the last state, and ``step`` advances one token in O(1) with the layer's
discretised constants (S5: Λ̄, B̄ and the ×2 of conj-sym).  A bidirectional
S5 has no causal decode and raises ``ValueError``.  The decode state of an
S4 layer is the complex state x (B, H, N) of each channel's dense DPLR
recurrence (Ā, B̄, C̄ from ``discrete_dplr`` at ``l_max = seq_len``); its
CNN mode exposes no state, so ``prefill`` runs the prompt through ``step``
one token at a time.  The decode state of a
transformer layer sits behind the conv's trailing K−1 inputs where the layer
has a conv:
- softmax attention: its float32 KV cache, k (B, max_len, H, head_dim) and v
  (B, max_len, H, v_dim); ``prefill`` runs the prompt through the
  full-sequence attention (on the card, the flash forward kernel) and writes
  its k and v into the cache, and ``step`` attends one token over the cache
  up to its position, writing its k and v in place (the port updates the
  cache where JAX returns a new one);
- linear attention: the float32 running state S = Σ k vᵀ (B, H, head_dim,
  v_dim) of the elu+1 features and the key sum Σ k (B, H, head_dim), the
  normaliser's; ``step`` adds one token to both and reads them with its q;
- norm attention: S alone (k scaled where ``scale_B`` is set), read with q
  and multiplied by the token's learned decay.
``prefill`` builds S (and the key sum) from the whole prompt beside the
chunked full-sequence attention.  A position past the position table
(``max_pos_embed``) raises ``ValueError``: the reference's gather fills NaN
there.  The linear and norm states do not grow with the position, so
without a position table (the MQAR norm attention has none) nothing bounds
it.  ``stepwise_logits`` is the teacher-forced step path, the parity surface
against the full forward.

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

from ..models.attention_layers import MHNA
from ..models.backbone import glu_activation
from ..models.registry import build_models
from ..models.s4 import S4

SSM_FAMILIES = ("lru", "s5", "s4")


class Decoder:
    """Per-token decoder for LRU, S5, S4 and transformer weights.

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
        if cfg["layer"] in SSM_FAMILIES:
            if cfg.get("pooling", "none") != "none":
                raise ValueError("decode requires pooling: none")
            if cfg["layer"] == "s5" and cfg.get("bidirectional", False):
                raise ValueError("bidirectional S5 cannot decode causally")
            self.family, self.vocab, self.max_pos = cfg["layer"], cfg["input_dim"], 0
        elif cfg["layer"] == "transformer":
            if not cfg.get("embedding", False):
                raise ValueError("transformer decode requires a token encoder")
            if cfg["attention_fn"] not in ("sm-attention", "lin-attention", "norm-attention"):
                raise RuntimeError(f"attention_fn {cfg['attention_fn']} not implemented")
            if cfg.get("use_gate", False):  # only classifiers set it
                raise NotImplementedError("decoding a gated (use_gate) transformer is not "
                                          "ported yet")
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
        if self.family in SSM_FAMILIES:
            self._prep_ssm()

    # -- per-layer recurrence constants (computed once) --------------------

    @torch.no_grad()
    def _prep_ssm(self):
        """Each layer's step constants: the LRU's λ, γ-normalised B, C, D;
        S5's Λ̄, B̄, C̃, D and the readout's 2 (conj-sym) or 1; S4's (Ā, B̄,
        C̄) and D."""
        self._ssm_consts = []
        for layer in self.model.encoder.layers:
            seq = layer.seq
            if self.family == "lru":
                consts = dict(lam=seq.lam(), bn=seq.input_matrix(), c=(seq.C_re, seq.C_im),
                              d=seq.D, mult=1.0)
            elif self.family == "s5":
                lam_bar, b_bar = seq.discretized()
                consts = dict(lam=(lam_bar.real, lam_bar.imag), bn=(b_bar.real, b_bar.imag),
                              c=seq.c_tilde(), d=seq.D, mult=2.0 if seq.conj_sym else 1.0)
            else:
                consts = dict(dplr=seq.recurrence(), d=seq.D[0])
            self._ssm_consts.append(consts)

    def init_cache(self, bsz: int, max_len: Optional[int] = None):
        """Zero decode state: per LRU or S5 layer (h_re, h_im), per S4 layer
        the complex (bsz, H, N) state; per transformer
        layer ([conv tail,] k cache, v cache) for ``max_len`` positions
        (softmax), ([conv tail,] S, key sum) (linear) or ([conv tail,] S)
        (norm attention).  ``max_len``, which the softmax cache needs, is
        checked against the position table."""
        if self.family == "s4":
            return tuple(torch.zeros(bsz, seq.d_model, seq.d_state, dtype=torch.complex64,
                                     device=self.device)
                         for seq in (layer.seq for layer in self.model.encoder.layers))
        if self.family in SSM_FAMILIES:
            def z(consts):
                return torch.zeros(bsz, consts["lam"][0].shape[0], device=self.device)
            return tuple((z(c), z(c)) for c in self._ssm_consts)
        if max_len is None and self.cfg["attention_fn"] == "sm-attention":
            raise ValueError("the transformer's KV cache needs max_len")
        if max_len is not None:
            self._check_positions(max_len)
        layers = []
        for layer in self.model.layers:
            att = layer.attention
            H, hd, vd = att.num_heads, att.head_dim, att.v_dim
            if isinstance(att, MHNA):
                c = (torch.zeros(bsz, H, hd, vd, device=self.device),)
            elif att.lin_att:
                c = (torch.zeros(bsz, H, hd, vd, device=self.device),
                     torch.zeros(bsz, H, hd, device=self.device))
            else:
                c = (torch.zeros(bsz, max_len, H, hd, device=self.device),
                     torch.zeros(bsz, max_len, H, vd, device=self.device))
            if att.conv1d is not None:
                width, _, K = att.conv1d.weight.shape
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
        """(cache, tokens (B,), pos) → (cache, logits (B, V)).  The SSM
        families' state carries no position; the transformer's step needs
        ``pos``."""
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
        if "dplr" in consts:  # S4: the dense DPLR recurrence
            x, y = S4.rnn_step(consts["dplr"], c, u)
            return y + consts["d"] * u, x
        lam_re, lam_im = consts["lam"]
        br, bi = consts["bn"]
        hr, hi = c
        bur, bui = u @ br.T, u @ bi.T
        nr = lam_re * hr - lam_im * hi + bur
        ni = lam_re * hi + lam_im * hr + bui
        cr, ci = consts["c"]
        y = consts["mult"] * (nr @ cr.T - ni @ ci.T)
        return y + consts["d"] * u, (nr, ni)

    def _tf_step(self, cache, tok, pos):
        """``_tf_step``: the embeddings at ``pos``, each block's one-token
        attention over its state, the final norm and the decoder."""
        if pos is None:
            raise ValueError("the transformer's step needs the token's position")
        self._check_positions(pos + 1)
        x = self.model.encoder(tok, torch.tensor(pos, device=self.device))
        new = []
        for layer, c in zip(self.model.layers, cache):
            att = layer.attention
            xn = layer.norm(x)
            if isinstance(att, MHNA):
                a, c = self._mhna_step(att, c, xn)
            else:
                a, c = self._mha_step(att, c, xn, pos)
            new.append(c)
            x = layer.mix(x + a)
        return tuple(new), self.model.decoder(self.model.norm(x))

    @staticmethod
    def _conv_step(att, c, proj):
        """``_att_conv``: the conv's one-token output from its cached tail
        and this token's input (the part ``conv_input`` takes of [q | k | v]
        or [v | q | k]); returns (cache with the tail moved on, proj)."""
        if att.conv1d is None:
            return c, proj
        pre = att.conv_input(proj)
        window = torch.cat([c[0], pre[:, None]], dim=1)  # (B, K, C)
        y = torch.einsum("bkc,ck->bc", window, att.conv1d.weight[:, 0]) + att.conv1d.bias
        return (window[:, 1:],) + c[1:], att.after_conv(proj, y)

    def _mha_step(self, mha, c, x, pos):
        """``_mha_step``: softmax attention of one token's q over the cached
        k, v of positions 0 .. pos (its own k and v written at ``pos``
        first), or linear attention's one-token update of (S, key sum) and
        its read by q, numerator over normaliser."""
        c, qkv = self._conv_step(mha, c, mha.Wqkv(x))
        q, k, v = mha.split(qkv)  # (B, H, D)
        if mha.lin_att:
            q, k = mha.features(q), mha.features(k)
            S = c[-2] + k[..., :, None] * v[..., None, :]
            ksum = c[-1] + k
            num = torch.einsum("bhd,bhde->bhe", q, S)
            ctx = num / torch.einsum("bhd,bhd->bh", q, ksum)[..., None]
            return mha.project(ctx), c[:-2] + (S, ksum)
        kc, vc = c[-2], c[-1]
        if pos >= kc.shape[1]:
            raise ValueError(f"position {pos} is past the KV cache of {kc.shape[1]}")
        kc[:, pos], vc[:, pos] = k, v
        scores = torch.einsum("bhd,blhd->bhl", q, kc[:, : pos + 1]) / math.sqrt(mha.head_dim)
        ctx = torch.einsum("bhl,blhd->bhd", torch.softmax(scores, dim=-1), vc[:, : pos + 1])
        return mha.project(ctx), c

    def _mhna_step(self, mhna, c, x):
        """``_mhna_step``: one token added to S (k scaled where ``scale_B``
        is set), read by q, times the token's learned decay."""
        vqk, n = mhna.project_in(x)
        c, vqk = self._conv_step(mhna, c, vqk)
        q, k, v = mhna.split(vqk)
        S = c[-1] + k[..., :, None] * v[..., None, :]
        out = mhna.decay(n)[..., None] * torch.einsum("bhd,bhde->bhe", q, S)
        return mhna.project(out), c[:-1] + (S,)

    # -- full-sequence prefill -----------------------------------------------

    @torch.no_grad()
    def prefill(self, prompt, max_len: Optional[int] = None):
        """Run the prompt (B, L0) through the full-sequence path and build the
        decode cache from it (for the transformer, a KV cache of ``max_len``
        positions, L0 by default).  S4 runs the prompt through ``step``,
        one token at a time.  Returns (cache, logits at the last prompt
        position)."""
        prompt = self._tokens(prompt)
        if self.family == "attention":
            return self._tf_prefill(prompt, prompt.shape[1] if max_len is None else max_len)
        if self.family == "s4":
            cache = self.init_cache(prompt.shape[0])
            for t in range(prompt.shape[1]):
                cache, logits = self.step(cache, prompt[:, t])
            return cache, logits
        x = self.model.encoder.encoder(prompt)  # (B, L, d)
        cache = []
        for layer in self.model.encoder.layers:
            skip = x
            if layer.prenorm:
                x = layer.normalize(x)
            h = layer.seq.scan(x)  # the diagonal-scan kernel on the card (LRU, S5)
            cache.append((h[0][:, -1].contiguous(), h[1][:, -1].contiguous()))
            x = skip + glu_activation(layer, layer.seq.readout(h, x))
            if not layer.prenorm:
                x = layer.normalize(x)
        return tuple(cache), self.model.decoder(x[:, -1])

    def _tf_prefill(self, prompt, max_len: int):
        """``_tf_prefill``: the blocks over the whole prompt, each attention
        through its full-sequence path (softmax: ``causal_softmax_attention``,
        the flash forward kernel on the card; linear and norm: the chunked
        linear attention), the conv's tail kept, and the state built: the
        prompt's k and v in the first L0 rows of the KV cache, or S = Σ k vᵀ
        (and the key sum) over the prompt in float32."""
        bsz, L = prompt.shape
        if max_len < L:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({L})")
        cache = list(self.init_cache(bsz, max_len))
        x = self.model.encoder(prompt)
        for i, layer in enumerate(self.model.layers):
            att, c = layer.attention, cache[i]
            norm_att = isinstance(att, MHNA)
            xn = layer.norm(x)
            proj, n = att.project_in(xn) if norm_att else (att.Wqkv(xn), None)
            if att.conv1d is not None:
                pre = att.conv_input(proj)
                K = att.conv1d.weight.shape[-1]
                tail = pre[:, max(L - (K - 1), 0):]
                c[0][:, K - 1 - tail.shape[1]:] = tail  # front-padded for short prompts
                proj = att.after_conv(proj, att.conv1d(pre))
            q, k, v = att.split(proj)
            if norm_att:
                out = att.attend(q, k, v, n)
                c[-1].copy_(torch.einsum("blhd,blhe->bhde", k.float(), v.float()))
            elif att.lin_att:
                out = att.attend(q, k, v)
                kf = att.features(k).float()
                c[-2].copy_(torch.einsum("blhd,blhe->bhde", kf, v.float()))
                c[-1].copy_(kf.sum(dim=1))
            else:
                out = att.attend(q, k, v)
                c[-2][:, :L], c[-1][:, :L] = k, v
            x = layer.mix(x + att.project(out))
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
        """Greedy generation: prompt (B, L0) → (B, L0 + n_new).  For a
        transformer with a position table L0 + n_new must fit
        ``max_pos_embed``.  Sampling
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
