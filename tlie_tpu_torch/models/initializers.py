"""LRU ring initialisers of ``tlie_tpu/models/initializers.py`` (:151-171),
drawing from an explicit ``torch.Generator``.

The draws cannot match JAX's from the same seed; what matches is the
distribution: |λ| uniform on the [r_min, r_max] ring, phase uniform on
[0, max_phase], γ = sqrt(1 − |λ|²).
"""

from __future__ import annotations

import math

import torch


def matrix_init(shape, generator: torch.Generator, normalization: float = 1.0):
    return torch.randn(shape, generator=generator) / normalization


def nu_log_init(shape, generator: torch.Generator, r_min: float = 0.0, r_max: float = 1.0):
    """log(-log |λ|) with |λ| uniform on the [r_min, r_max] ring."""
    u = torch.rand(shape, generator=generator)
    return torch.log(-0.5 * torch.log(u * (r_max**2 - r_min**2) + r_min**2))


def theta_log_init(shape, generator: torch.Generator, max_phase: float = 6.28):
    u = torch.rand(shape, generator=generator)
    return torch.log(max_phase * u)


def gamma_log_init(nu_log: torch.Tensor):
    """log γ with γ = sqrt(1 - |λ|²), from nu_log."""
    lam_abs2 = torch.exp(-2.0 * torch.exp(nu_log))  # |λ|² = exp(-2 e^{ν})
    return torch.log(torch.sqrt(1.0 - lam_abs2))


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal of variance 1/fan_in truncated at
    two standard deviations (rescaled so the truncation keeps the variance)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )
