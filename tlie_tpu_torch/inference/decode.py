"""Autoregressive serving for the LRU, counterpart of
``tlie_tpu/inference/decode.py::Decoder`` (family ``lru``).

The decode state of each layer is the complex diagonal state h (B, N), kept
as a (re, im) pair.  ``prefill`` runs the prompt through the full-sequence
path (on the card, the diagonal-scan kernel) and keeps the last state;
``step`` then advances one token in O(1).  ``stepwise_logits`` is the
teacher-forced step path, the parity surface against the full forward.

The decoder serves an eval-mode copy of the model it is given (encoder
gather, norms, GLU, head): the weights as they were when it was built, as
``tlie_tpu``'s decoder serves the params tree it was handed.  The caller's
module is left as it was, in its own mode.  Only the SSM core differs
between the full-sequence and the one-token paths.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from ..models.backbone import ClassificationModel, glu_activation
from ..models.registry import build_models

Cache = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class Decoder:
    """Per-token decoder for LRU weights.

    >>> dec = Decoder(model_cfg, state_dict)            # on the card
    >>> out = dec.generate(prompt_tokens, n_new=16)     # greedy

    ``params`` is a port ``state_dict`` (as ``compat.params_from_jax`` gives
    it) or a built ``ClassificationModel``, which is copied, not changed."""

    def __init__(self, model_cfg: Dict[str, Any],
                 params: Union[Mapping[str, torch.Tensor], ClassificationModel],
                 *, device="cuda"):
        cfg = dict(model_cfg)
        if cfg.get("classifier", False) or cfg.get("dual", False):
            raise ValueError("decode targets per-position LM heads "
                             "(classifier/dual models have no AR semantics)")
        if cfg["layer"] != "lru":
            raise NotImplementedError(f"decoding {cfg['layer']!r} is not ported yet")
        if cfg.get("pooling", "none") != "none":
            raise ValueError("decode requires pooling: none")
        self.cfg = cfg
        if isinstance(params, nn.Module):
            self.model = copy.deepcopy(params).eval()
        else:
            _, self.model, _ = build_models(cfg, generator=torch.Generator(), device=device)
            self.model.load_state_dict(params)
        self.device = next(self.model.parameters()).device
        self.vocab = cfg["input_dim"]
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

    def init_cache(self, bsz: int) -> Cache:
        n = self.cfg["state_dim"]
        z = lambda: torch.zeros(bsz, n, device=self.device)  # noqa: E731
        return tuple((z(), z()) for _ in self.model.encoder.layers)

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
    def step(self, cache: Cache, tok: torch.Tensor):
        """(cache, tokens (B,)) → (cache, logits (B, V)).  The LRU's state
        carries no position."""
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

    # -- full-sequence prefill -----------------------------------------------

    @torch.no_grad()
    def prefill(self, prompt):
        """Run the prompt (B, L0) through the full-sequence path and build the
        decode cache from the last state.  Returns (cache, logits at the last
        prompt position)."""
        prompt = self._tokens(prompt)
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

    # -- teacher-forced scan and generation ----------------------------------

    @torch.no_grad()
    def stepwise_logits(self, tokens) -> torch.Tensor:
        """tokens (B, L) → per-position logits (B, L, V) via the step path."""
        tokens = self._tokens(tokens)
        B, L = tokens.shape
        cache = self.init_cache(B)
        out = []
        for t in range(L):
            cache, logits = self.step(cache, tokens[:, t])
            out.append(logits)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def generate(self, prompt, n_new: int, temperature: float = 0.0) -> torch.Tensor:
        """Greedy generation: prompt (B, L0) → (B, L0 + n_new).  Sampling
        (temperature, top-k, top-p) is not ported yet."""
        if temperature != 0.0:
            raise NotImplementedError("sampled generation is not ported yet; use temperature 0")
        prompt = self._tokens(prompt)
        cache, logits = self.prefill(prompt)
        toks = []
        for i in range(n_new):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            if i + 1 < n_new:  # the last token needs no further step
                cache, logits = self.step(cache, tok)
        return torch.cat([prompt] + [t[:, None] for t in toks], dim=1)
