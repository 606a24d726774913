"""Initialisers of ``tlie_tpu/models/initializers.py``: the LRU ring
(:151-171), the S5 and S4 timescales and projected B and C (:89-148),
drawing from an explicit ``torch.Generator``, and the HiPPO construction
(:26-88), a host numpy copy.

The random draws cannot match JAX's from the same seed; what matches is the
distribution: |λ| uniform on the [r_min, r_max] ring, phase uniform on
[0, max_phase], γ = sqrt(1 − |λ|²); log Δ uniform on [log dt_min, log
dt_max].  The HiPPO matrices, their Λ, P, B and V are deterministic and
match ``tlie_tpu``'s bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
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


# --------------------------------------------------------------------------
# HiPPO (host numpy, init-time constants): copies of
# tlie_tpu/models/initializers.py:26-88, framework-neutral
# --------------------------------------------------------------------------


def make_hippo(n: int) -> np.ndarray:
    """Negated HiPPO-LegS matrix, float32 throughout (the eigendecomposition's
    eigenvector phases depend on the exact input bits)."""
    p = np.sqrt(1 + 2 * np.arange(n, dtype=np.float32))
    a = np.tril(np.outer(p, p)) - np.diag(np.arange(n, dtype=np.float32))
    return -a


def make_nplr_hippo(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HiPPO plus the rank-1 term P and input vector B making it normal."""
    hippo = make_hippo(n)
    p = np.sqrt(np.arange(n, dtype=np.float32) + 0.5)
    b = np.sqrt(2 * np.arange(n, dtype=np.float32) + 1.0)
    return hippo, p, b


def make_dplr_hippo(n: int):
    """Diagonal-plus-low-rank decomposition of HiPPO-LegS: (Λ, P, B, V,
    B_orig), Λ, P, B and V complex64, B_orig float32, bit for bit those of
    ``tlie_tpu``."""
    a, p, b = make_nplr_hippo(n)
    s = a + np.outer(p, p)
    s_diag = np.diagonal(s)
    lambda_real = np.mean(s_diag) * np.ones_like(s_diag)
    # −i·S is Hermitian; complex64, as tlie_tpu's float32 pipeline
    lambda_imag, v = _host_eigh((s * -1j).astype(np.complex64))
    p_out = v.conj().T @ p
    b_out = v.conj().T @ b
    return lambda_real + 1j * lambda_imag, p_out, b_out, v, b


def _host_eigh(m: np.ndarray):
    """Eigendecomposition of the Hermitian ``m`` on the host as
    ``tlie_tpu``'s ``_host_eigh`` takes it (JAX's CPU ``eigh``): the input
    symmetrised as (m + mᴴ)/2, then LAPACK's divide-and-conquer ``heevd``
    through SciPy, which gives JAX's bits, eigenvector phases included.
    Without SciPy, numpy's ``eigh`` (the same spectrum, other phases)."""
    m = ((m + m.conj().T) / np.asarray(2, m.real.dtype)).astype(m.dtype)
    try:
        import scipy.linalg
    except ImportError:
        return np.linalg.eigh(m)
    w, v = scipy.linalg.eigh(m, driver="evd")
    # C order, as JAX returns it: the products with V round as tlie_tpu's
    return w, np.ascontiguousarray(v)


# --------------------------------------------------------------------------
# S5 / S4 initialisers (tlie_tpu/models/initializers.py:89-148), drawing
# from an explicit torch.Generator.  Complex values are stored with a
# trailing (re, im) axis, the checkpoint layout of both packages.
# --------------------------------------------------------------------------


def log_step_initializer(shape, generator: torch.Generator, dt_min: float = 0.001,
                         dt_max: float = 0.1) -> torch.Tensor:
    """Uniform in log-space between dt_min and dt_max."""
    u = torch.rand(shape, generator=generator)
    return u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)


def init_log_steps(p: int, generator: torch.Generator, dt_min: float, dt_max: float):
    """(P, 1) log-timescales, one row at a time as ``init_log_steps``."""
    return torch.stack([log_step_initializer((1,), generator, dt_min, dt_max)
                        for _ in range(p)])


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """A new tensor of ``shape`` drawn as :func:`lecun_normal_`."""
    return lecun_normal_(torch.empty(shape), fan_in, generator)


def init_vinv_b(shape, generator: torch.Generator, vinv_re: np.ndarray,
                vinv_im: np.ndarray) -> torch.Tensor:
    """B̃ = V⁻¹ B with a real lecun-normal B of ``shape`` (2P or P, H)
    (flax's fan-in: shape[-2]); returns (P, H, 2)."""
    b = lecun_normal(shape, shape[-2], generator)
    re = torch.from_numpy(vinv_re) @ b
    im = torch.from_numpy(vinv_im) @ b
    return torch.stack([re, im], dim=-1)


def trunc_standard_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """(H, P, 2) lecun-normal rows, each drawn as a (1, P, 2) array (fan-in
    P), one row at a time as ``trunc_standard_normal``."""
    h, p, _ = shape
    return torch.stack([lecun_normal((p, 2), p, generator) for _ in range(h)])


def init_cv(c: torch.Tensor, v_re: np.ndarray, v_im: np.ndarray) -> torch.Tensor:
    """C̃ = C V for a drawn C (H, 2P or P, 2) read as complex; returns (H, P, 2)."""
    c_re, c_im = c[..., 0], c[..., 1]
    vr, vi = torch.from_numpy(v_re), torch.from_numpy(v_im)
    return torch.stack([c_re @ vr - c_im @ vi, c_re @ vi + c_im @ vr], dim=-1)
