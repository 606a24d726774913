"""Eigenvalue extractors, counterpart of ``tlie_tpu/analysis/extractors.py``
for the LRU.  Spectra are native complex tensors (ROADMAP rule 5)."""

from __future__ import annotations

from typing import Mapping

import torch


def eig_lru(layer_params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """λ = exp(−exp(ν_log) + i·exp(θ_log)) (ref eval_eig.py:318-329), as
    complex64, computed in float32 like ``tlie_tpu``."""
    nu_log = torch.as_tensor(layer_params["nu_log"], dtype=torch.float32)
    theta_log = torch.as_tensor(layer_params["theta_log"], dtype=torch.float32)
    return torch.polar(torch.exp(-torch.exp(nu_log)), torch.exp(theta_log))
