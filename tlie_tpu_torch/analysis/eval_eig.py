"""Eigen-spectroscopy: per-layer spectra → binning → artifacts, counterpart
of ``tlie_tpu/analysis/eval_eig.py::eval_eig`` for the LRU, S5 and S4 (its
SSM branch, :384-433) and for Mamba-2 (and its pseudo-LTI variant), Mamba-1
and the softmax, linear and norm attention transformers (its
attention-family branch, :324-382).

For the SSM families the spectra depend on the parameters only, so no batch
runs through the model: the LRU's λ, S5's exp(ΛΔ), and the eigenvalues of
S4's discretised Ā at channel 1 and ``seq_len`` (``eval_eig.py:244-259``).
For Mamba-2, Mamba-1 and the transformer they come from a forward pass: one
analysis batch goes through the blocks, and layer i's spectrum is taken from
layer i's *own output* re-projected through its own projection — Mamba-2's
λ_t = exp(dt_t·A) through ``in_proj``, Mamba-1's exp(Δ_t·A) over its
(d_inner, N) lattice through ``in_proj``, the conv, ``x_proj`` and
``dt_proj``, the transformer's η_t of its normaliser through ``Wqkv``
(softmax, linear) or ``Wvqkn`` (norm attention's learned decay) — the
reference's layer-chain quirk
(``eval_eig.py:12-17``), kept for parity.  Both passes run in evaluation
mode.  A classifier's head (the transformer's ``ClassifierHead``, the
Mamba's pooled decoder) never enters the spectra: the collector runs the
encoder and the blocks only.  A padded split's analysis batch is its
tokens alone, as ``tlie_tpu``'s ``prep_batch(..., lang_model=True)``
leaves them (``eval_eig.py:326-328``).  A dual model's analysis batch is
its pairs (B, 2, L), folded into 2B documents as its forward folds them;
``tlie_tpu`` first pads the pair axis to ``seq_len`` and reads rows 0 and
1 alone, so both give the same spectra.

The init spectra come from the port's own seeded init (``torch.Generator``
seeded with ``args["seed"]``); JAX's draws cannot be reproduced, so they
match ``tlie_tpu``'s in distribution, not pointwise.  S5's Λ is the
deterministic HiPPO one, so its init spectrum differs from ``tlie_tpu``'s
only through the drawn Δ.  The trained spectra
come from the parameters handed in.

Nothing is written unless the caller names the directory:
``conf_args["save_path"]`` is required.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.layers import fold_pairs
from ..models.registry import build_models
from ..training.checkpoint import restore_checkpoint
from .artifacts import (
    artifact_name, save_artifacts, write_percentage_file, write_percentage_file_ssm,
)
from .binning import (
    PHASE_THRESHOLDS, RADIUS_THRESHOLDS, threshold_analysis, threshold_analysis_ssm,
)
from .extractors import (
    eig_att_linear, eig_att_norm, eig_att_softmax, eig_lru, eig_mamba1, eig_mamba2,
    eig_mamba2_lti, eig_s4, eig_s5,
)

_SEQ_KEY = re.compile(r"^encoder\.layers\.(\d+)\.seq\.(\w+)$")


def ssm_layer_params(state_dict: Mapping[str, torch.Tensor]) -> list:
    """Per-layer SSM parameter dicts, in layer order, from a port state_dict."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in state_dict.items():
        m = _SEQ_KEY.match(key)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = value
    return [layers[i] for i in sorted(layers)]


def extract_ssm_family(layer_list, model_config, eig_impl: str = "host") -> np.ndarray:
    """Per-layer complex spectra of the LRU, S5 or S4 → complex64 (N,
    layers), the dtype ``tlie_tpu``'s float32 (re, im) planes combine into
    under numpy 2.  S4's are the eigenvalues of channel 1's Ā at
    ``seq_len`` (``_extract_ssm_family``), by ``eig_impl``."""
    family = model_config["layer"]
    if family == "lru":
        eig = eig_lru
    elif family == "s5":
        eig = eig_s5
    elif family == "s4":
        def eig(lp):
            return eig_s4(lp, idx=1, seq_len=model_config["seq_len"], eig_impl=eig_impl)
    else:
        raise RuntimeError(f"unsupported ssm family {family}")
    cols = [eig(lp).cpu().numpy()[:, None] for lp in layer_list]
    return np.concatenate(cols, axis=-1)


@torch.no_grad()
def extract_attention_family(model: nn.Module, inputs: torch.Tensor,
                             model_config: Mapping[str, Any]) -> np.ndarray:
    """Per-layer spectra from the activations after each block
    (``_extract_attention_family``): Mamba-2's λ → float32 (B, L, nheads,
    layers), the pseudo-LTI ``SSD_LTI``'s (``pseudoLTI: true``)
    exp(−softplus(A)) broadcast to the same shape, Mamba-1's → (B, L,
    d_inner·N, layers); for the transformer,
    dispatched on ``attention_fn``, softmax, linear or norm attention's η →
    float32 (B, L−1, H, layers), norm
    attention's with the offset only where the config sets ``offset``.  An
    unknown ``attention_fn`` raises.  The encoder runs without its dropout
    and the final norm is not applied, as the reference's collector runs
    them.  A dual model's pairs (B, 2, L) are folded into the batch first,
    as its forward folds them (``tlie_tpu/analysis/eval_eig.py:117-126``):
    the spectra then have 2B per-document rows, the first documents first."""
    if getattr(model, "dual", False):
        inputs = fold_pairs(inputs)
    h = model.encoder(inputs)
    etas = []
    for block in model.blocks if hasattr(model, "blocks") else model.layers:
        h = block(h)
        if hasattr(block, "mamba") and model_config.get("version", "mamba2") == "mamba1":
            m = block.mamba
            eta = eig_mamba1(h, m.in_proj.weight, m.in_proj.bias, m.conv1d.weight,
                             m.conv1d.bias, m.x_proj.weight, m.dt_proj.weight, m.dt_proj.bias,
                             m.A_log, m.d_inner, m.dt_rank)
        elif hasattr(block, "mamba") and model_config.get("pseudoLTI", False):
            eta = eig_mamba2_lti(h, block.mamba.A)
        elif hasattr(block, "mamba"):
            m = block.mamba
            eta = eig_mamba2(h, m.in_proj.weight, m.in_proj.bias, m.dt_bias, m.A_log,
                             m.d_inner, m.ngroups, m.d_state)
        else:
            a, attention_fn = block.attention, model_config["attention_fn"]
            if attention_fn == "sm-attention":
                eta = eig_att_softmax(h, a.Wqkv.weight, a.Wqkv.bias, a.d_qk, a.num_heads)
            elif attention_fn == "lin-attention":
                eta = eig_att_linear(h, a.Wqkv.weight, a.Wqkv.bias, a.d_qk, a.num_heads)
            elif attention_fn == "norm-attention":
                offset = a.offset if model_config.get("offset", False) else None
                eta = eig_att_norm(h, a.Wvqkn.weight, a.Wvqkn.bias, a.d_qk, a.d_model,
                                   model_config["norm_fn"], offset=offset)
            else:
                raise RuntimeError(f"unsupported attention_fn {attention_fn}")
        etas.append(eta.cpu().numpy()[..., None])
    return np.concatenate(etas, axis=-1)


def _trained_state(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return params.state_dict()
    if isinstance(params, (str, os.PathLike)):
        return restore_checkpoint(os.fspath(params))["model"]
    return params


def eval_eig(args: Dict[str, Any], conf_args: Dict[str, Any], perf: float,
             params, *, device="cuda", batch=None):
    """Spectra pipeline for the LRU, S5, S4, Mamba-2 and the transformers.

    ``params`` is the trained model, its ``state_dict``, or the path of the
    port's checkpoint (``training.save_checkpoint``); ``batch`` is the
    analysis batch, integer tokens (B, L) or float features (B, L, d) such
    as CIFAR's pixels, that the Mamba and transformer families' spectra are
    taken on (``tlie_tpu`` takes the first batch of the
    unshuffled test split, of the analysis config's ``batch_size``); the SSM
    families need none.  ``conf_args["eig_impl"]`` picks S4's eigensolver
    ("host", the default, or "device").  The
    artifacts go to ``conf_args["save_path"]/<artifact name>-perf<perf>``.
    Returns (eig, eig_init, percentage, percentage_init, percentage_phase,
    percentage_phase_init) as ``tlie_tpu``'s ``eval_eig`` does."""
    if not conf_args.get("save_path"):
        raise ValueError("eval_eig needs conf_args['save_path']: it writes nowhere by default")
    model_config = dict(args["model"])
    model_config.pop("compute_dtype", None)
    seed = args["seed"]

    _, init_model, family = build_models(
        model_config, generator=torch.Generator().manual_seed(seed), device=device
    )
    out_dir = os.path.join(conf_args["save_path"], artifact_name(args, perf) + f"-perf{perf:0.3f}")
    if family in ("mamba", "transformer"):
        arrays = _attention_arrays(init_model, _trained_state(params), batch, model_config,
                                   device)
        os.makedirs(out_dir, exist_ok=True)
        write_percentage_file(
            os.path.join(out_dir, "percentage_file.txt"), RADIUS_THRESHOLDS,
            arrays["percentage"], arrays["percentage_init"],
            arrays["percentage_mean"], arrays["percentage_init_mean"],
            arrays["percentage_std"], arrays["percentage_init_std"],
        )
    else:
        arrays = _ssm_arrays(init_model, _trained_state(params), model_config,
                             conf_args.get("eig_impl", "host"))
        os.makedirs(out_dir, exist_ok=True)
        write_percentage_file_ssm(
            os.path.join(out_dir, "percentage_file.txt"),
            RADIUS_THRESHOLDS, PHASE_THRESHOLDS,
            arrays["percentage"], arrays["percentage_init"],
            arrays["percentage_phase"], arrays["percentage_phase_init"],
        )
    save_artifacts(out_dir, arrays, args)
    return (
        arrays["eig"], arrays["eig_init"],
        arrays["percentage"], arrays["percentage_init"],
        arrays["percentage_phase"], arrays["percentage_phase_init"],
    )


def _attention_arrays(init_model, trained, batch, model_config, device) -> Dict[str, Any]:
    """The attention-family branch (``eval_eig.py:324-382``): spectra of the
    init and the trained model on the analysis batch, radius and phase
    binned per (example, head, layer), with the batch mean and std.  The
    Mamba family bins |λ| and its angle; the transformers' η (softmax,
    linear, norm) is real and is binned as it is, its phase as 0·η (ref
    :668-674)."""
    if batch is None:
        raise ValueError(f"the {model_config['layer']} family's spectra need an analysis batch "
                         "(batch=...)")
    inputs = torch.as_tensor(np.asarray(batch), device=device)
    # tokens to the embedding as int64, features (CIFAR's pixels) to the
    # dense encoder as float32
    inputs = inputs.float() if torch.is_floating_point(inputs) else inputs.long()
    eig_init = extract_attention_family(init_model, inputs, model_config)
    _, model, _ = build_models(model_config, generator=torch.Generator(), device=device)
    model.load_state_dict(trained)
    eig = extract_attention_family(model, inputs, model_config)

    arrays: Dict[str, Any] = {}
    if model_config["layer"] == "mamba":
        rad_init, rad = np.abs(eig_init), np.abs(eig)
        ph_init = np.arctan2(np.zeros_like(eig_init), eig_init) * 180 / np.pi
        ph = np.arctan2(np.zeros_like(eig), eig) * 180 / np.pi
    else:
        rad_init, rad, ph_init, ph = eig_init, eig, 0 * eig_init, 0 * eig
    arrays["percentage_init"] = threshold_analysis(rad_init, RADIUS_THRESHOLDS)
    arrays["percentage"] = threshold_analysis(rad, RADIUS_THRESHOLDS)
    arrays["percentage_phase_init"] = threshold_analysis(ph_init, PHASE_THRESHOLDS)
    arrays["percentage_phase"] = threshold_analysis(ph, PHASE_THRESHOLDS)
    arrays["percentage_init_mean"] = np.mean(arrays["percentage_init"], axis=1)
    arrays["percentage_init_std"] = np.std(arrays["percentage_init"], axis=1)
    arrays["percentage_mean"] = np.mean(arrays["percentage"], axis=1)
    arrays["percentage_std"] = np.std(arrays["percentage"], axis=1)
    arrays["eig"], arrays["eig_init"] = eig, eig_init
    return arrays


def _ssm_arrays(init_model, trained, model_config, eig_impl: str = "host") -> Dict[str, Any]:
    """The SSM branch (``eval_eig.py:384-433``) for the LRU, S5 and S4."""
    eig_init = extract_ssm_family(ssm_layer_params(init_model.state_dict()), model_config,
                                  eig_impl)
    eig = extract_ssm_family(ssm_layer_params(trained), model_config, eig_impl)
    arrays: Dict[str, Any] = {}
    arrays["percentage_init"] = threshold_analysis_ssm(np.abs(eig_init), RADIUS_THRESHOLDS)
    arrays["percentage"] = threshold_analysis_ssm(np.abs(eig), RADIUS_THRESHOLDS)
    ph_init = np.arctan2(eig_init.imag, eig_init.real) * 180 / np.pi
    ph = np.arctan2(eig.imag, eig.real) * 180 / np.pi
    arrays["percentage_phase_init"] = threshold_analysis_ssm(ph_init, PHASE_THRESHOLDS)
    arrays["percentage_phase"] = threshold_analysis_ssm(ph, PHASE_THRESHOLDS)
    for key in ("percentage_init_mean", "percentage_init_std", "percentage_mean", "percentage_std"):
        arrays[key] = np.zeros(())
    arrays["eig"], arrays["eig_init"] = eig, eig_init
    return arrays
