"""Autoregressive serving for the SSM families (LRU, S5, S4), the
transformers (softmax, linear and norm attention, with or without the SiLU
gate) and the Mamba family (Mamba-2, its pseudo-LTI variant and Mamba-1),
counterpart of ``tlie_tpu/inference/decode.py::Decoder``.

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
- linear attention: the running state S = Σ k vᵀ (B, H, head_dim, v_dim) of
  the elu+1 features and the float32 key sum Σ k (B, H, head_dim), the
  normaliser's; ``step`` adds one token to both and reads them with its q;
- norm attention: S alone (k scaled where ``scale_B`` is set), read with q
  and multiplied by the token's learned decay.
``prefill`` builds S (and the key sum) from the whole prompt beside the
chunked full-sequence attention.  A gated block (``use_gate``) multiplies
its output by SiLU(Wz x) of its input.  The decode state of a Mamba block is
the conv's trailing K−1 inputs (float32) and the SSM state: Mamba-2's h (B,
H, N, P) (starting from the layer's ``init_states`` where it learns them),
Mamba-1's h (B, d_inner, N).  ``prefill`` runs the prompt through the
layer's full-sequence path and keeps the state after its last token:
Mamba-2's chunked scan (on the card, the decay-attention forward kernel
inside each chunk), Mamba-1's diagonal scan over its (B, L, d_inner·N) view
(on the card, the diagonal-scan kernel); ``step`` advances one token in
O(1).  A ``compute_dtype: bfloat16`` model of any family (the LRU, S5,
S4, the transformers, Mamba-2) is served as ``tlie_tpu`` serves it: float32
arithmetic on its float32 weights (flax keeps the parameters float32, and
``tlie_tpu``'s decoder multiplies them as stored, ``decode.py:54``), so a
Mamba-2's prefill runs the float32 decay attention, not the bfloat16 one,
and a bf16 LRU's logits are float32.

``state_dtype`` (``torch.float32`` by default) is the dtype the large decode
states are stored in: the Mamba-2 and Mamba-1 h and the linear and norm
attention's S.  Their update runs in float32 and is rounded on store, where
``tlie_tpu`` rounds it; conv tails, the key sum, the KV cache and the LRU,
S5 and S4 states stay float32.

A position past the position table (``max_pos_embed``) raises
``ValueError``: the reference's gather fills NaN there.  The linear and
norm states do not grow with the position, so without a position table (the
MQAR norm attention has none, and neither has any Mamba model, whatever its
config's ``max_pos_embed`` says) nothing bounds it.  ``stepwise_logits`` is
the teacher-forced step path, the parity surface against the full forward.
``generate`` is greedy at temperature 0 and otherwise samples from an
explicit ``torch.Generator``, with top-k and top-p.

``shard`` (a data :class:`~tlie_tpu_torch.parallel.mesh.Shard`, the
counterpart of ``tlie_tpu``'s 1-axis serving ``mesh=``, ``decode.py:128-152``,
``:720-729``) serves over the ranks of a process group: each rank decodes
its rows of the prompt batch with the whole (replicated) weights, a sampled
token is drawn from the global batch's probabilities, gathered, with the
one generator every rank holds in the same state, and each rank keeps its
rows; ``generate`` gathers the tokens, so every rank returns the one-process
decode's.  A shard of time steps or of the vocabulary raises, as
``tlie_tpu`` refuses a mesh of more than one axis.

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
import torch.nn.functional as F
from torch import nn

from ..models.attention_layers import MHNA
from ..models.backbone import glu_activation
from ..models.mamba2 import SSD_LTI, Mamba1
from ..models.registry import build_models
from ..models.s4 import S4
from ..ops.conv import conv_step, conv_tail
from ..training.checkpoint import restore_checkpoint

SSM_FAMILIES = ("lru", "s5", "s4")


class Decoder:
    """Per-token decoder for LRU, S5, S4, transformer and Mamba weights.

    >>> dec = Decoder(model_cfg, state_dict)            # on the card
    >>> out = dec.generate(prompt_tokens, n_new=16)     # greedy
    >>> out = dec.generate(prompt, 16, temperature=0.8, top_p=0.9,
    ...                    generator=torch.Generator("cuda").manual_seed(0))

    ``params`` is a port ``state_dict`` (as ``compat.params_from_jax`` gives
    it) or a built model, which is copied, not changed.  ``shard`` serves
    the batch over a process group's data ranks (see the module
    docstring)."""

    def __init__(self, model_cfg: Dict[str, Any], params: Union[Mapping[str, torch.Tensor], nn.Module],
                 *, device="cuda", state_dtype: torch.dtype = torch.float32, shard=None):
        if shard is not None and (shard.vocab or shard.axis != 0):
            raise ValueError("the serving shard must split the batch alone: a shard of the "
                             "vocabulary or of time steps is a layout of more than one axis")
        self.shard = shard
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
            self.family, self.vocab = "attention", cfg["vocab_size"]
            self.max_pos = cfg.get("max_pos_embed", 0)
        elif cfg["layer"] == "mamba":
            if cfg.get("pooling", "none") != "none":
                raise ValueError("decode requires pooling: none")
            if not cfg.get("token_embedding", False):
                raise ValueError("mamba decode requires token_embedding")
            # no position table: TokenEmbeddings gets 0 for the Mamba family
            self.family, self.vocab, self.max_pos = "mamba", cfg["vocab_size"], 0
        else:
            raise ValueError(f"unknown family {cfg['layer']}")
        self.cfg, self.state_dtype = cfg, state_dtype
        if cfg.get("compute_dtype", "float32") != "float32":
            # float32 arithmetic on the float32 weights, as tlie_tpu serves it
            # (its decoder multiplies the parameters as stored)
            if isinstance(params, nn.Module):
                device = next(params.parameters()).device
                params = params.state_dict()
            cfg = {k: v for k, v in cfg.items() if k != "compute_dtype"}
        if isinstance(params, nn.Module):
            self.model = copy.deepcopy(params).eval()
        else:
            _, self.model, _ = build_models(cfg, generator=torch.Generator(), device=device)
            self.model.load_state_dict(params)
        self.device = next(self.model.parameters()).device
        if self.family in SSM_FAMILIES:
            self._prep_ssm()

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "Decoder":
        """A decoder for a checkpoint file of the port
        (:func:`tlie_tpu_torch.training.save_checkpoint`'s ``{"model":
        state_dict, "config": {"model", ...}}``): the model built from
        ``config["model"]`` and loaded with the state dict, BatchNorm
        statistics included.  ``kwargs`` (``device``, ``state_dtype``,
        ``shard``) pass through."""
        ckpt = restore_checkpoint(path)
        return cls(ckpt["config"]["model"], ckpt["model"], **kwargs)

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

    @torch.no_grad()
    def init_cache(self, bsz: int, max_len: Optional[int] = None):
        """Zero decode state: per LRU or S5 layer (h_re, h_im), per S4 layer
        the complex (bsz, H, N) state; per Mamba block (conv tail, h) with
        h (bsz, H, N, P) (Mamba-2, the layer's ``init_states`` where it
        has them) or (bsz, d_inner, N) (Mamba-1); per transformer
        layer ([conv tail,] k cache, v cache) for ``max_len`` positions
        (softmax), ([conv tail,] S, key sum) (linear) or ([conv tail,] S)
        (norm attention).  ``max_len``, which the softmax cache needs, is
        checked against the position table."""
        if self.family == "mamba":
            return tuple(self._mamba_cache(block.mamba, bsz) for block in self.model.blocks)
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
                c = (self._zeros(bsz, H, hd, vd, dtype=self.state_dtype),)
            elif att.lin_att:
                c = (self._zeros(bsz, H, hd, vd, dtype=self.state_dtype),
                     self._zeros(bsz, H, hd))
            else:
                c = (self._zeros(bsz, max_len, H, hd), self._zeros(bsz, max_len, H, vd))
            if att.conv1d is not None:
                width, _, K = att.conv1d.weight.shape
                c = (self._zeros(bsz, K - 1, width),) + c
            layers.append(c)
        return tuple(layers)

    def _zeros(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(*shape, dtype=dtype, device=self.device)

    def _mamba_cache(self, core, bsz: int):
        """One Mamba block's zero (conv tail, h)."""
        K = 0 if core.conv1d is None else core.conv1d.weight.shape[-1]
        if isinstance(core, Mamba1):
            return (self._zeros(bsz, max(K - 1, 0), core.d_inner),
                    self._zeros(bsz, core.d_inner, core.d_state, dtype=self.state_dtype))
        conv_dim = core.d_inner + 2 * core.ngroups * core.d_state
        shape = (bsz, core.nheads, core.d_state, core.headdim)
        if core.init_states is None:
            h = self._zeros(*shape, dtype=self.state_dtype)
        else:  # (H, P, N) → (bsz, H, N, P)
            h = core.init_states.transpose(-1, -2).expand(shape).to(self.state_dtype).clone()
        return self._zeros(bsz, max(K - 1, 0), conv_dim), h

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
        """(cache, tokens (B,), pos) → (cache, logits (B, V)).  The SSM and
        Mamba families' state carries no position; the transformer's step
        needs ``pos``."""
        if self.family == "attention":
            return self._tf_step(cache, tok, pos)
        if self.family == "mamba":
            return self._mamba_step(cache, tok)
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

    # Mamba family (models/mamba2.py)

    @staticmethod
    def _mamba_block(block, x, core):
        """``MambaBlock`` around ``core`` (x → (y, state)): [LayerNorm] →
        core → exact GELU → [GLU] → residual → [LayerNorm]; (x, state)."""
        skip = x
        if block.prenorm:
            x = block.norm(x)
        y, c = core(x)
        x = F.gelu(y)
        if block.glu is not None:
            x = block.glu(x)
        x = x + skip
        if not block.prenorm:
            x = block.norm(x)
        return x, c

    def _mamba_step(self, cache, tok):
        """``_mamba_step``: the word embedding, each block's one-token core
        over its state, the decoder."""
        x = self.model.encoder(tok)
        new = []
        for block, c in zip(self.model.blocks, cache):
            core = block.mamba
            step = self._mamba1_core_step if isinstance(core, Mamba1) else self._ssd_core_step
            x, c = self._mamba_block(block, x, lambda u: step(core, c, u))
            new.append(c)
        return tuple(new), self.model.decoder(x)

    def _ssd_core_step(self, core, c, u):
        """``_ssd_core_step``: one token through ``in_proj``, the conv's
        step and SiLU, then h ← exp(dt·A)·h + dt·B xᵀ, y = C·h + D·x and
        ``out_proj``; h updated in float32, stored in ``state_dtype``.
        ``SSD_LTI``: dt is ngroups wide (the heads' biases broadcast it),
        repeated over each head's share of B and folded into it; the step is
        β = 1 clipped to ``dt_limit`` and the decay exp(β·(−softplus(A)))."""
        tail, h = c
        d_inner, G, N = core.d_inner, core.ngroups, core.d_state
        H, P = core.nheads, core.headdim
        conv_dim = d_inner + 2 * G * N
        xbcdt = core.in_proj(u)
        xBC = xbcdt[:, :conv_dim]
        dt = F.softplus(xbcdt[:, conv_dim:] + core.dt_bias)  # (B, H)
        tail, xBC = conv_step(tail, xBC, core.conv1d.weight, core.conv1d.bias)
        xBC = F.silu(xBC)
        x = xBC[:, :d_inner].reshape(-1, H, P)
        B_flat = xBC[:, d_inner: d_inner + G * N]
        Ch = torch.repeat_interleave(xBC[:, d_inner + G * N:].reshape(-1, G, N), H // G, dim=1)
        lo, hi = core.dt_limit
        limited = (lo, hi) != (0.0, float("inf"))
        if isinstance(core, SSD_LTI):
            dt_full = torch.repeat_interleave(dt, core.khead_dim, dim=-1)  # (B, G·N)
            Bh = torch.repeat_interleave((dt_full * B_flat).reshape(-1, G, N), H // G, dim=1)
            beta = min(max(1.0, lo), hi) if limited else 1.0
            decay = torch.exp(beta * -F.softplus(core.A))[None, :, None, None]
            upd = beta * Bh[..., :, None] * x[..., None, :]
        else:
            if limited:
                dt = torch.clamp(dt, lo, hi)
            Bh = torch.repeat_interleave(B_flat.reshape(-1, G, N), H // G, dim=1)
            decay = torch.exp(dt * -torch.exp(core.A_log))[..., None, None]
            upd = (dt[..., None, None] * Bh[..., :, None]) * x[..., None, :]
        hf = decay * h.to(upd.dtype) + upd  # (B, H, N, P)
        y = torch.einsum("bhn,bhnp->bhp", Ch, hf) + core.D[None, :, None] * x
        return core.out_proj(y.reshape(-1, d_inner)), (tail, hf.to(self.state_dtype))

    def _mamba1_core_step(self, core, c, u):
        """``_mamba1_core_step``: [x | z] from ``in_proj``, the conv's step
        and SiLU on x, ``x_proj`` → [dt, B, C], dt = softplus(``dt_proj``),
        h ← exp(dt·A)·h + dt·x·B over the (d_inner, N) lattice, y = h·C +
        D·x, then y·SiLU(z) through ``out_proj``."""
        tail, h = c
        x, z = core.in_proj(u).chunk(2, dim=-1)
        if core.conv1d is not None:
            tail, x = conv_step(tail, x, core.conv1d.weight, core.conv1d.bias)
            x = F.silu(x)
        x_db = core.x_proj(x)
        r, n = core.dt_rank, core.d_state
        dt = F.softplus(core.dt_proj(x_db[:, :r]))  # (B, d_inner)
        B_mat, C_mat = x_db[:, r: r + n], x_db[:, r + n:]
        a = torch.exp(dt[..., None] * -torch.exp(core.A_log))  # (B, d_inner, N)
        hf = a * h.to(a.dtype) + (dt * x)[..., None] * B_mat[:, None, :]
        y = torch.einsum("bdn,bn->bd", hf, C_mat) + core.D * x
        return core.out_proj(y * F.silu(z)), (tail, hf.to(self.state_dtype))

    # transformer family (models/transformer.py)

    def _tf_step(self, cache, tok, pos):
        """``_tf_step``: the embeddings at ``pos``, each block's one-token
        attention over its state (times SiLU(Wz x) of the block's input
        where it is gated), the final norm and the decoder."""
        if pos is None:
            raise ValueError("the transformer's step needs the token's position")
        self._check_positions(pos + 1)
        x = self.model.encoder(tok, torch.tensor(pos, device=self.device))
        new = []
        for layer, c in zip(self.model.layers, cache):
            att = layer.attention
            z = None if layer.Wz is None else layer.Wz(x)
            xn = layer.norm(x)
            if isinstance(att, MHNA):
                a, c = self._mhna_step(att, c, xn)
            else:
                a, c = self._mha_step(att, c, xn, pos)
            new.append(c)
            x = layer.mix(x + a, z)
        return tuple(new), self.model.decoder(self.model.norm(x))

    @staticmethod
    def _att_conv_step(att, c, proj):
        """``_att_conv``: the conv's one-token output from its cached tail
        and this token's input (the part ``conv_input`` takes of [q | k | v]
        or [v | q | k]); returns (cache with the tail moved on, proj)."""
        if att.conv1d is None:
            return c, proj
        tail, y = conv_step(c[0], att.conv_input(proj), att.conv1d.weight, att.conv1d.bias)
        return (tail,) + c[1:], att.after_conv(proj, y)

    def _mha_step(self, mha, c, x, pos):
        """``_mha_step``: softmax attention of one token's q over the cached
        k, v of positions 0 .. pos (its own k and v written at ``pos``
        first), or linear attention's one-token update of (S, key sum) and
        its read by q (of S before its rounding to ``state_dtype``),
        numerator over normaliser."""
        c, qkv = self._att_conv_step(mha, c, mha.Wqkv(x))
        q, k, v = mha.split(qkv)  # (B, H, D)
        if mha.lin_att:
            q, k = mha.features(q), mha.features(k)
            S = c[-2].to(k.dtype) + k[..., :, None] * v[..., None, :]
            ksum = c[-1] + k
            num = torch.einsum("bhd,bhde->bhe", q, S)
            ctx = num / torch.einsum("bhd,bhd->bh", q, ksum)[..., None]
            return mha.project(ctx), c[:-2] + (S.to(self.state_dtype), ksum)
        kc, vc = c[-2], c[-1]
        if pos >= kc.shape[1]:
            raise ValueError(f"position {pos} is past the KV cache of {kc.shape[1]}")
        kc[:, pos], vc[:, pos] = k, v
        scores = torch.einsum("bhd,blhd->bhl", q, kc[:, : pos + 1]) / math.sqrt(mha.head_dim)
        ctx = torch.einsum("bhl,blhd->bhd", torch.softmax(scores, dim=-1), vc[:, : pos + 1])
        return mha.project(ctx), c

    def _mhna_step(self, mhna, c, x):
        """``_mhna_step``: one token added to S (k scaled where ``scale_B``
        is set), read by q (before S's rounding to ``state_dtype``), times
        the token's learned decay."""
        vqk, n = mhna.project_in(x)
        c, vqk = self._att_conv_step(mhna, c, vqk)
        q, k, v = mhna.split(vqk)
        S = c[-1].to(k.dtype) + k[..., :, None] * v[..., None, :]
        out = mhna.decay(n)[..., None] * torch.einsum("bhd,bhde->bhe", q, S)
        return mhna.project(out), c[:-1] + (S.to(self.state_dtype),)

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
        if self.family == "mamba":
            return self._mamba_prefill(prompt)
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

    def _mamba_prefill(self, prompt):
        """``_mamba_prefill``: the blocks over the whole prompt, each core
        through its full-sequence path with ``return_state`` (Mamba-2 and
        SSD_LTI: the chunked scan from the layer's initial state, which on
        the card runs the decay-attention forward kernel; Mamba-1: the
        diagonal scan of its (B, L, d_inner·N) view, the scan's kernel),
        keeping the conv's tail and the state after the last token, h in
        the decode layout (B, H, N, P) for Mamba-2."""
        def core(block):
            def run(u):
                y, (tail, h) = block.mamba(u, return_state=True)
                if not isinstance(block.mamba, Mamba1):
                    h = h.transpose(-1, -2)  # (B, H, P, N) → (B, H, N, P)
                return y, (tail, h.to(self.state_dtype).contiguous())
            return run

        x = self.model.encoder(prompt)
        cache = []
        for block in self.model.blocks:
            x, c = self._mamba_block(block, x, core(block))
            cache.append(c)
        return tuple(cache), self.model.decoder(x[:, -1])

    def _tf_prefill(self, prompt, max_len: int):
        """``_tf_prefill``: the blocks over the whole prompt, each attention
        through its full-sequence path (softmax: ``causal_softmax_attention``,
        the flash forward kernel on the card; linear and norm: the chunked
        linear attention), the conv's tail kept, and the state built: the
        prompt's k and v in the first L0 rows of the KV cache, or S = Σ k vᵀ
        (and the key sum) over the prompt in float32, S stored in
        ``state_dtype``; a gated block's output times SiLU(Wz x)."""
        bsz, L = prompt.shape
        if max_len < L:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({L})")
        cache = list(self.init_cache(bsz, max_len))
        x = self.model.encoder(prompt)
        for i, layer in enumerate(self.model.layers):
            att, c = layer.attention, cache[i]
            norm_att = isinstance(att, MHNA)
            z = None if layer.Wz is None else layer.Wz(x)
            xn = layer.norm(x)
            proj, n = att.project_in(xn) if norm_att else (att.Wqkv(xn), None)
            if att.conv1d is not None:
                pre = att.conv_input(proj)
                c[0].copy_(conv_tail(pre, att.conv1d.weight.shape[-1]))
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
            x = layer.mix(x + att.project(out), z)
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

    @staticmethod
    def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
        """``_filter_logits``: -inf outside the ``top_k`` largest logits
        (where top_k > 0), then outside the nucleus (where 0 < top_p < 1):
        the smallest prefix of the sorted distribution whose mass reaches
        top_p, its first token always kept; ties at a threshold are kept."""
        if top_k > 0:
            kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if 0.0 < top_p < 1.0:
            sorted_l = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sorted_l, dim=-1)
            keep = torch.cumsum(probs, dim=-1) - probs < top_p
            thresh = torch.where(keep, sorted_l, torch.full_like(sorted_l, float("inf")))
            logits = logits.masked_fill(logits < thresh.amin(dim=-1, keepdim=True),
                                        float("-inf"))
        return logits

    @classmethod
    def sampling_logits(cls, logits: torch.Tensor, temperature: float, top_k: int = 0,
                        top_p: float = 0.0) -> torch.Tensor:
        """The logits a sampled token is drawn from: divided by the
        temperature first, then filtered (top-k, then top-p), so the
        nucleus is taken on the tempered distribution.  (``tlie_tpu``
        filters before dividing, which keeps another set whenever the
        temperature is not 1.)"""
        return cls._filter_logits(logits.float() / temperature, top_k, top_p)

    @classmethod
    def next_token(cls, logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 0.0, generator: Optional[torch.Generator] = None):
        """The next token of each row of ``logits`` (B, V): the argmax at
        temperature 0, else one draw from the softmax of
        :meth:`sampling_logits` with ``generator``."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(cls.sampling_logits(logits, temperature, top_k, top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.no_grad()
    def generate(self, prompt, n_new: int, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy (temperature 0) or sampled generation: prompt (B, L0) →
        (B, L0 + n_new).  Sampling draws each token from the softmax of the
        logits divided by ``temperature`` and then filtered: the ``top_k``
        largest (where top_k > 0), then the nucleus, the smallest set whose
        probability reaches ``top_p`` (where 0 < top_p < 1), taken on the
        tempered distribution, unlike ``tlie_tpu``, which takes it before
        dividing.  Sampling needs ``generator``, a ``torch.Generator`` on
        the decoder's device.  For a transformer with a position table L0 +
        n_new must fit ``max_pos_embed``.  With the decoder's ``shard`` every
        rank passes the whole prompt batch, which the shard's size must
        divide, and takes the whole output."""
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling requires a torch.Generator (generator=...)")
        prompt = self._tokens(prompt)
        shard = self.shard
        if shard is not None:
            if prompt.shape[0] % shard.world:
                raise ValueError(f"batch {prompt.shape[0]} not divisible by the serving "
                                 f"shard's {shard.world} ranks")
            prompt = shard.rows(prompt)
        L0 = prompt.shape[1]
        cache, logits = self.prefill(prompt, L0 + n_new)
        toks = []
        for i in range(n_new):
            if shard is not None and temperature > 0.0:
                # the global batch's draw from the one generator, this rank's rows
                probs = torch.softmax(self.sampling_logits(logits, temperature, top_k, top_p),
                                      dim=-1)
                tok = shard.rows(torch.multinomial(shard.gather_rows(probs), 1,
                                                   generator=generator)[:, 0])
            else:
                tok = self.next_token(logits, temperature, top_k, top_p, generator)
            toks.append(tok)
            if i + 1 < n_new:  # the last token needs no further step
                cache, logits = self.step(cache, tok, L0 + i)
        out = torch.cat([prompt] + [t[:, None] for t in toks], dim=1)
        return out if shard is None else shard.gather_rows(out)
