"""Eigenvalue extractors, counterpart of ``tlie_tpu/analysis/extractors.py``
for the LRU and Mamba-2.  Complex spectra are native complex tensors
(ROADMAP rule 5)."""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F


def eig_lru(layer_params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """λ = exp(−exp(ν_log) + i·exp(θ_log)) (ref eval_eig.py:318-329), as
    complex64, computed in float32 like ``tlie_tpu``."""
    nu_log = torch.as_tensor(layer_params["nu_log"], dtype=torch.float32)
    theta_log = torch.as_tensor(layer_params["theta_log"], dtype=torch.float32)
    return torch.polar(torch.exp(-torch.exp(nu_log)), torch.exp(theta_log))


def eig_mamba2(x: torch.Tensor, in_proj_weight: torch.Tensor, in_proj_bias, dt_bias: torch.Tensor,
               A_log: torch.Tensor, d_inner: int, ngroups: int, d_state: int) -> torch.Tensor:
    """λ_t = exp(dt_t · A) for SSD (ref eval_eig.py:176-190): dt is the
    slice of ``in_proj(x)`` after d_inner + 2·ngroups·d_state, softplus'd
    with ``dt_bias``, and A = −exp(A_log).  ``in_proj_weight`` is the
    ``nn.Linear`` (out, in) weight; returns (B, L, nheads) float32."""
    proj = x @ in_proj_weight.t()
    if in_proj_bias is not None:
        proj = proj + in_proj_bias
    dt = F.softplus(proj[..., d_inner + 2 * ngroups * d_state:] + dt_bias)
    return torch.exp(dt * (-torch.exp(A_log)))
