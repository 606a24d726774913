"""Linear Recurrent Unit (Orvieto et al. 2023), counterpart of
``tlie_tpu/models/lru.py::LRU`` with the same parameter names and shapes.

λ = exp(−exp(ν_log) + i·exp(θ_log)) on a ring [r_min, r_max], a γ-normalised
complex input projection, and a real readout::

    h_t = λ ⊙ h_{t-1} + γ ⊙ B u_t ;  y_t = Re[C h_t] + D ⊙ u_t

The recurrence runs through :func:`tlie_tpu_torch.ops.diag_linear_scan`: on
the card the hand-written diagonal-scan kernel, with λ shared across the
batch (read at batch stride 0, never materialised per example).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.scan import diag_linear_scan
from .initializers import gamma_log_init, matrix_init, nu_log_init, theta_log_init


class LRU(nn.Module):
    def __init__(self, d_hidden: int, d_model: int, generator: torch.Generator,
                 r_min: float = 0.0, r_max: float = 1.0, max_phase: float = 6.28):
        super().__init__()
        self.d_hidden, self.d_model = d_hidden, d_model
        g = generator
        # draw order follows the flax module's setup
        self.theta_log = nn.Parameter(theta_log_init((d_hidden,), g, max_phase))
        self.nu_log = nn.Parameter(nu_log_init((d_hidden,), g, r_min, r_max))
        self.gamma_log = nn.Parameter(gamma_log_init(self.nu_log.detach()))
        self.B_re = nn.Parameter(matrix_init((d_hidden, d_model), g, math.sqrt(2 * d_model)))
        self.B_im = nn.Parameter(matrix_init((d_hidden, d_model), g, math.sqrt(2 * d_model)))
        self.C_re = nn.Parameter(matrix_init((d_model, d_hidden), g, math.sqrt(d_hidden)))
        self.C_im = nn.Parameter(matrix_init((d_model, d_hidden), g, math.sqrt(d_hidden)))
        self.D = nn.Parameter(matrix_init((d_model,), g))

    def lam(self):
        """λ as a (re, im) pair of (N,) tensors."""
        mag = torch.exp(-torch.exp(self.nu_log))
        phase = torch.exp(self.theta_log)
        return mag * torch.cos(phase), mag * torch.sin(phase)

    def input_matrix(self):
        """γ-normalised B as a (re, im) pair of (N, d_model) tensors."""
        gamma = torch.exp(self.gamma_log)[:, None]
        return self.B_re * gamma, self.B_im * gamma

    def scan(self, u: torch.Tensor):
        """States h (..., L, N) as a (re, im) pair for input u (..., L, d_model)."""
        L = u.shape[-2]
        lam_re, lam_im = self.lam()
        bn_re, bn_im = self.input_matrix()
        bu = (u @ bn_re.T, u @ bn_im.T)  # (..., L, N) pair
        a = (lam_re.expand(L, self.d_hidden), lam_im.expand(L, self.d_hidden))
        return diag_linear_scan(a, bu)

    def readout(self, h, u: torch.Tensor) -> torch.Tensor:
        """y = Re[C h] + D ⊙ u."""
        return h[0] @ self.C_re.T - h[1] @ self.C_im.T + self.D * u

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u: (..., L, d_model) real → (..., L, d_model) real."""
        return self.readout(self.scan(u), u)
