"""Pretrained-LM attention spectroscopy, counterpart of
``tlie_tpu/analysis/lm_spectra.py`` (the lm_eigvals notebook as a library):
hook the q/k projections of a torch causal LM, stream evaluation batches
through it, recompute the softmax-attention eigenvalue ratio η per (layer,
head), cache each batch's result resumably, and threshold-bin the
concatenation.

η is :func:`tlie_tpu_torch.analysis.extractors.eta_softmax_from_qk` in
float32 on the tensors' device: the hooks keep q and k on the model's
device, and each batch is moved there, so a model on the card is analysed
on the card.  The hooks take Llama-style ``self_attn.{q,k}_proj`` and GPT-2
style fused ``attn.c_attn`` layouts, with grouped-query attention's k heads
repeated to the q heads.

Unlike ``tlie_tpu``'s, :func:`lm_attention_spectra` has no default cache
directory: it writes only where the caller names one.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .binning import RADIUS_THRESHOLDS, threshold_analysis
from .extractors import eta_softmax_from_qk

_EIGS = re.compile(r"eigs_(\d+)\.npy$")


def eta_from_torch_qk(q, k) -> np.ndarray:
    """(B, L, H, D) q, k (torch tensors or numpy arrays) → η (B, L−1, H)
    numpy float32, computed in float32 on q's device."""
    q = torch.as_tensor(q).float()
    k = torch.as_tensor(k, device=q.device).float()
    with torch.no_grad():
        return eta_softmax_from_qk(q, k).cpu().numpy()


class QKHooks:
    """Forward hooks capturing each layer's q and k projections of a torch
    LM (``QKHooks``), kept on the model's device."""

    def __init__(self, model: nn.Module):
        self.cache: Dict[int, Dict[str, torch.Tensor]] = {}
        self.handles = []
        self.layers = self._find_layers(model)
        for i, layer in enumerate(self.layers):
            self._register(i, layer)

    @staticmethod
    def _find_layers(model: nn.Module) -> List[nn.Module]:
        for path in ("model.layers", "transformer.h", "gpt_neox.layers"):
            obj = model
            for attr in path.split("."):
                obj = getattr(obj, attr, None)
                if obj is None:
                    break
            if obj is not None:
                return list(obj)
        raise ValueError("Unrecognised LM layer layout")

    def _register(self, idx: int, layer: nn.Module) -> None:
        attn = getattr(layer, "self_attn", getattr(layer, "attn", None))
        if attn is None:
            raise ValueError(f"layer {idx}: no attention module found")

        def save(name):
            def hook(_mod, _inp, out):
                self.cache.setdefault(idx, {})[name] = out.detach().float()
            return hook

        if hasattr(attn, "q_proj"):  # Llama / OLMo style
            self.handles.append(attn.q_proj.register_forward_hook(save("q")))
            self.handles.append(attn.k_proj.register_forward_hook(save("k")))
        elif hasattr(attn, "c_attn"):  # GPT-2 fused qkv
            def split_hook(_mod, _inp, out):
                qkv = out.detach().float()
                d = qkv.shape[-1] // 3
                self.cache.setdefault(idx, {}).update(q=qkv[..., :d], k=qkv[..., d: 2 * d])
            self.handles.append(attn.c_attn.register_forward_hook(split_hook))
        else:
            raise ValueError(f"layer {idx}: unsupported attention projections")

    def pop_qk(self, num_heads: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer (q, k) split into heads, (B, L, H, head_dim) each, k's
        heads repeated where the model has fewer kv heads (GQA); clears the
        cache."""
        out = []
        for i in range(len(self.layers)):
            q, k = self.cache[i]["q"], self.cache[i]["k"]
            b, l, dq = q.shape
            dk = k.shape[-1]
            hk = max(1, num_heads * dk // dq)  # GQA: fewer kv heads
            q = q.reshape(b, l, num_heads, dq // num_heads)
            k = k.reshape(b, l, hk, dk // hk)
            if hk != num_heads:
                k = k.repeat_interleave(num_heads // hk, dim=2)
            out.append((q, k))
        self.cache.clear()
        return out

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _cached(cache_dir: str) -> List[Tuple[int, str]]:
    """(batch index, path) of the ``eigs_<i>.npy`` files in ``cache_dir``,
    in index order."""
    found = ((_EIGS.search(p), p) for p in glob.glob(os.path.join(cache_dir, "eigs_*.npy")))
    return sorted((int(m.group(1)), p) for m, p in found if m)


def lm_attention_spectra(model: nn.Module, batches: Iterable, num_heads: int, cache_dir: str,
                         max_batches: Optional[int] = None) -> np.ndarray:
    """Run ``batches`` of token ids (B, L) through a torch causal LM on its
    own device and save η per (layer, head) of batch i as
    ``cache_dir/eigs_<i>.npy``, (B, L−1, H, layers).  Resumable as
    ``tlie_tpu``'s: batches below one past the highest index already in the
    cache are skipped.  Returns, and saves as ``all_eigs.npy``, the
    concatenation of every cached batch."""
    os.makedirs(cache_dir, exist_ok=True)
    done = _cached(cache_dir)
    start = done[-1][0] + 1 if done else 0
    device = next(model.parameters()).device

    hooks = QKHooks(model)
    model.eval()
    try:
        for i, batch in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            if i < start:
                continue
            with torch.no_grad():
                model(torch.as_tensor(np.asarray(batch), device=device).long())
            etas = [eta_from_torch_qk(q, k)[..., None] for q, k in hooks.pop_qk(num_heads)]
            np.save(os.path.join(cache_dir, f"eigs_{i}.npy"), np.concatenate(etas, axis=-1))
    finally:
        hooks.remove()

    all_eigs = np.concatenate([np.load(p) for _, p in _cached(cache_dir)], axis=0)
    np.save(os.path.join(cache_dir, "all_eigs.npy"), all_eigs)
    return all_eigs


def bin_lm_spectra(all_eigs: np.ndarray) -> Dict[str, np.ndarray]:
    """Radius histogram per (layer, head) (``bin_lm_spectra``): the
    percentages over the positions, and their mean and std over the
    examples."""
    pct = threshold_analysis(all_eigs, RADIUS_THRESHOLDS)
    return {
        "percentage": pct,
        "percentage_mean": pct.mean(axis=1),
        "percentage_std": pct.std(axis=1),
    }
