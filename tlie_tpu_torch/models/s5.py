"""S5, a MIMO diagonal SSM with a block-diagonal HiPPO init, counterpart of
``tlie_tpu/models/s5.py::S5SSM`` with the same parameter names and shapes:
``Lambda_re``, ``Lambda_im`` (P,), ``B`` (P, H, 2), ``C`` (H, P, 2) (``C1``
and ``C2`` when bidirectional; (H, 2P or P, 2) with ``complex_normal``),
``D`` (H,) and ``log_step`` (P, 1), complex values with a trailing (re, im)
axis::

    Λ̄, B̄ = discretise(Λ, B̃, Δ) ;  x_t = Λ̄ ⊙ x_{t-1} + B̄ u_t ;
    y_t = (2 with conj_sym) · Re[C̃ x_t] + D ⊙ u_t

The discretisation (ZOH or bilinear) runs in native complex64.  The
recurrence runs through :func:`tlie_tpu_torch.ops.diag_linear_scan` with Λ̄
passed as its (P,) pair, read at batch and time stride 0: on the card the
hand-written diagonal-scan kernels, forward and backward, whose da comes
back summed to (P,) and carries the gradients of Λ and ``log_step``; a
bidirectional layer adds the reverse scan, concatenated on the channel
axis.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.scan import diag_linear_scan
from .initializers import (
    init_cv, init_log_steps, init_vinv_b, lecun_normal, make_dplr_hippo, trunc_standard_normal,
)

Pair = Tuple[torch.Tensor, torch.Tensor]


def discretize_zoh(lam: torch.Tensor, b_tilde: torch.Tensor, step: torch.Tensor):
    """Zero-order hold: Λ̄ = exp(ΛΔ), B̄ = Λ⁻¹(Λ̄ − 1) B̃ (complex tensors;
    Λ, Δ (P,), B̃ (P, H))."""
    lam_bar = torch.exp(lam * step)
    return lam_bar, ((lam_bar - 1) / lam)[:, None] * b_tilde


def discretize_bilinear(lam: torch.Tensor, b_tilde: torch.Tensor, step: torch.Tensor):
    """Tustin: Λ̄ = (1 − ΛΔ/2)⁻¹(1 + ΛΔ/2), B̄ = (1 − ΛΔ/2)⁻¹ Δ B̃."""
    bl = 1 / (1 - lam * (step / 2))
    return bl * (1 + lam * (step / 2)), (bl * step)[:, None] * b_tilde


DISCRETIZATIONS = {"zoh": discretize_zoh, "bilinear": discretize_bilinear}


def _planes(z: torch.Tensor) -> Pair:
    return z.real.contiguous(), z.imag.contiguous()


class S5SSM(nn.Module):
    """(..., L, H) real → (..., L, H) real."""

    def __init__(self, Lambda_re_init: np.ndarray, Lambda_im_init: np.ndarray,
                 V_re: np.ndarray, V_im: np.ndarray, Vinv_re: np.ndarray, Vinv_im: np.ndarray,
                 H: int, P: int, C_init: str, discretization: str, dt_min: float,
                 dt_max: float, generator: torch.Generator, conj_sym: bool = True,
                 clip_eigs: bool = False, bidirectional: bool = False):
        super().__init__()
        if discretization not in DISCRETIZATIONS:
            raise NotImplementedError(f"Discretization method {discretization} not implemented")
        self.H, self.P, self.C_init = H, P, C_init
        self.discretization, self.conj_sym = discretization, conj_sym
        self.clip_eigs, self.bidirectional = clip_eigs, bidirectional
        g = generator
        local_p = 2 * P if conj_sym else P
        # draw order follows the flax module's setup
        self.Lambda_re = nn.Parameter(torch.from_numpy(np.array(Lambda_re_init)))
        self.Lambda_im = nn.Parameter(torch.from_numpy(np.array(Lambda_im_init)))
        self.B = nn.Parameter(init_vinv_b((local_p, H), g, Vinv_re, Vinv_im))
        if C_init == "complex_normal":
            shape = (H, 2 * P if bidirectional else P, 2)
            self.C = nn.Parameter(torch.randn(shape, generator=g) * 0.5**0.5)
        elif C_init in ("trunc_standard_normal", "lecun_normal"):
            def draw():
                if C_init == "trunc_standard_normal":
                    c = trunc_standard_normal((H, local_p, 2), g)
                else:  # flax's fan-in of an (H, local_p, 2) array: local_p · H
                    c = lecun_normal((H, local_p, 2), local_p * H, g)
                return nn.Parameter(init_cv(c, V_re, V_im))
            if bidirectional:
                self.C1, self.C2 = draw(), draw()
            else:
                self.C = draw()
        else:
            raise NotImplementedError(f"C_init method {C_init} not implemented")
        self.D = nn.Parameter(torch.randn(H, generator=g))
        self.log_step = nn.Parameter(init_log_steps(P, g, dt_min, dt_max))

    def discretized(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Λ̄ (P,), B̄ (P, H)) as complex64 tensors."""
        lam_re = self.Lambda_re.clamp(max=-1e-4) if self.clip_eigs else self.Lambda_re
        lam = torch.complex(lam_re, self.Lambda_im)
        b_tilde = torch.complex(self.B[..., 0], self.B[..., 1])
        step = torch.exp(self.log_step[:, 0])
        return DISCRETIZATIONS[self.discretization](lam, b_tilde, step)

    def c_tilde(self) -> Pair:
        """C̃ as a (re, im) pair of (H, P or 2P) tensors."""
        if self.bidirectional and self.C_init != "complex_normal":
            c = torch.cat([self.C1, self.C2], dim=1)
        else:
            c = self.C
        return c[..., 0], c[..., 1]

    def readout(self, xs: Pair, u: torch.Tensor) -> torch.Tensor:
        cr, ci = self.c_tilde()
        ys = xs[0] @ cr.T - xs[1] @ ci.T
        if self.conj_sym:
            ys = 2 * ys
        return ys + self.D * u

    def scan(self, u: torch.Tensor) -> Pair:
        """States x (..., L, P), or (..., L, 2P) when bidirectional, as a
        (re, im) pair for input u (..., L, H)."""
        lam_bar, b_bar = self.discretized()
        br, bi = _planes(b_bar)
        bu = (u @ br.T, u @ bi.T)  # (..., L, P) pair
        a = _planes(lam_bar)  # the (P,) pair: stride 0 over batch and time
        xs = diag_linear_scan(a, bu)
        if self.bidirectional:
            xs2 = diag_linear_scan(a, bu, reverse=True)
            xs = (torch.cat([xs[0], xs2[0]], dim=-1), torch.cat([xs[1], xs2[1]], dim=-1))
        return xs

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return self.readout(self.scan(u), u)


def _blockdiag(m: np.ndarray, reps: int) -> np.ndarray:
    rows, cols = m.shape
    out = np.zeros((rows * reps, cols * reps), dtype=m.dtype)
    for i in range(reps):
        out[i * rows:(i + 1) * rows, i * cols:(i + 1) * cols] = m
    return out


def init_S5(d_state: int, d_model: int, generator: torch.Generator, **cfg):
    """Registry factory (``init_S5``): the block-diagonal HiPPO init with
    optional conjugate-symmetry halving, computed on the host in numpy.
    Returns a constructor of :class:`S5SSM` drawing from ``generator``."""
    blocks = cfg.get("num_blocks", 8)
    conj_sym = cfg.get("conj_sym", True)
    block_size = int(d_state / blocks)
    lam, _, _, v, _ = make_dplr_hippo(block_size)
    if conj_sym:
        block_size //= 2
        d_state //= 2
    lam = lam[:block_size]
    v = v[:, :block_size]
    v_full = _blockdiag(v, blocks)
    vinv_full = _blockdiag(v.conj().T, blocks)
    lam_full = np.tile(lam, blocks)

    def f32(x):
        return np.ascontiguousarray(x.astype(np.float32))

    return partial(
        S5SSM,
        lam_full.real.astype(np.float32), lam_full.imag.astype(np.float32),
        f32(v_full.real), f32(v_full.imag), f32(vinv_full.real), f32(vinv_full.imag),
        H=d_model, P=d_state, C_init=cfg.get("C_init", "lecun_normal"),
        discretization=cfg.get("discretization", "zoh"), dt_min=cfg.get("dt_min", 0.001),
        dt_max=cfg.get("dt_max", 0.1), generator=generator, conj_sym=conj_sym,
        clip_eigs=cfg.get("clip_eigs", False), bidirectional=cfg.get("bidirectional", False),
    )
