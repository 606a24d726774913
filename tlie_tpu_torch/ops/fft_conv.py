"""FFT causal convolution and the Cauchy-kernel reduction of S4's CNN mode,
counterpart of ``tlie_tpu/ops/fft_conv.py`` on ``torch.fft`` and native
complex tensors.

``tlie_tpu``'s S4 runs its transforms on a matmul DFT (``ops/fft.py``), a
TPU-only workaround that the port does not carry: the port calls the
library's FFT, and parity is held at the model's interface."""

from __future__ import annotations

import torch


def cauchy_dot(v: torch.Tensor, omega: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Σ_n v_n / (ω_l − λ_n) for every ω_l: (..., N), (L,), (..., N) →
    (..., L), as one (L, N) broadcast and reduction."""
    return (v[..., None, :] / (omega[:, None] - lam[..., None, :])).sum(dim=-1)


def causal_fft_conv(u: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Causal convolution of the real signal ``u`` with the real kernel
    ``K`` along the last axis (both length L, output length L), through
    real FFTs zero-padded to 2L."""
    L = u.shape[-1]
    n = 2 * L
    return torch.fft.irfft(torch.fft.rfft(u, n=n) * torch.fft.rfft(K, n=n), n=n)[..., :L]
