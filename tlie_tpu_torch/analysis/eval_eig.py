"""Eigen-spectroscopy for the LRU: parameters → per-layer spectra → binning →
artifacts.  Counterpart of the SSM branch of
``tlie_tpu/analysis/eval_eig.py::eval_eig`` (:384-433).

For the SSM families the spectra depend on the parameters only, so no batch
runs through the model.  The init spectra come from the port's own seeded
init (``torch.Generator`` seeded with ``args["seed"]``); JAX's draws cannot be
reproduced, so they match ``tlie_tpu``'s in distribution, not pointwise.
The trained spectra come from the parameters handed in.

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

from ..models.registry import build_models
from ..training.checkpoint import restore_checkpoint
from .artifacts import artifact_name, save_artifacts, write_percentage_file_ssm
from .binning import PHASE_THRESHOLDS, RADIUS_THRESHOLDS, threshold_analysis_ssm
from .extractors import eig_lru

_SEQ_KEY = re.compile(r"^encoder\.layers\.(\d+)\.seq\.(\w+)$")


def ssm_layer_params(state_dict: Mapping[str, torch.Tensor]) -> list:
    """Per-layer SSM parameter dicts, in layer order, from a port state_dict."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in state_dict.items():
        m = _SEQ_KEY.match(key)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = value
    return [layers[i] for i in sorted(layers)]


def extract_ssm_family(layer_list, model_config) -> np.ndarray:
    """Per-layer complex spectra → complex64 (N, layers), the dtype
    ``tlie_tpu``'s float32 (re, im) planes combine into under numpy 2."""
    if model_config["layer"] != "lru":
        raise NotImplementedError(f"spectra of {model_config['layer']!r} are not ported yet")
    cols = [eig_lru(lp).cpu().numpy()[:, None] for lp in layer_list]
    return np.concatenate(cols, axis=-1)


def eval_eig(args: Dict[str, Any], conf_args: Dict[str, Any], perf: float,
             params, *, device="cuda"):
    """Spectra pipeline for the LRU.

    ``params`` is the trained model, its ``state_dict``, or the path of the
    port's checkpoint (``training.save_checkpoint``); the artifacts go to
    ``conf_args["save_path"]/<artifact name>-perf<perf>``.  Returns
    (eig, eig_init, percentage, percentage_init, percentage_phase,
    percentage_phase_init) as ``tlie_tpu``'s ``eval_eig`` does."""
    if not conf_args.get("save_path"):
        raise ValueError("eval_eig needs conf_args['save_path']: it writes nowhere by default")
    model_config = dict(args["model"])
    model_config.pop("compute_dtype", None)
    seed = args["seed"]

    _, init_model, _ = build_models(
        model_config, generator=torch.Generator().manual_seed(seed), device=device
    )
    eig_init = extract_ssm_family(ssm_layer_params(init_model.state_dict()), model_config)
    if isinstance(params, nn.Module):
        trained = params.state_dict()
    elif isinstance(params, (str, os.PathLike)):
        trained = restore_checkpoint(os.fspath(params))["model"]
    else:
        trained = params
    eig = extract_ssm_family(ssm_layer_params(trained), model_config)

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

    out_dir = os.path.join(conf_args["save_path"], artifact_name(args, perf) + f"-perf{perf:0.3f}")
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
