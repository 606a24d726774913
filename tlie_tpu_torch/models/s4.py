"""S4, a DPLR SSM with a generating-function (FFT) convolution, counterpart
of ``tlie_tpu/models/s4.py::S4`` with the same parameter names and shapes:
``Lambda_re``, ``Lambda_im`` (N, H); ``P``, ``B``, ``C`` (N, H, 2), complex
with a trailing (re, im) axis; ``D`` (1, H); ``log_step`` (1, H).

CNN mode (training): the length-``l_max`` kernel of every channel is the
transfer function at the roots of unity, through one Cauchy reduction over
the (H, L, N) cube of 1/(g − Λ) shared by its four terms, then an inverse
FFT; the layer applies it with a causal FFT convolution
(:func:`tlie_tpu_torch.ops.fft_conv.causal_fft_conv`).  RNN mode
(``decode: true``, and the decoder): the bilinear DPLR discretisation
(:func:`discrete_dplr`) gives each channel a dense (N, N) Ā, and the state
runs one step at a time.  The analysis takes Ā's eigenvalues
(``analysis/extractors.py::eig_s4``).

Everything complex runs in native complex64 and ``torch.fft``, where
``tlie_tpu`` carries (re, im) planes through a matmul DFT (TPU-only
workarounds, not ported).  One difference follows from it: at the Nyquist
root ω = −1 the map g = (2/Δ)(1 − ω)/(1 + ω) is about 1.6e16 · 2/Δ, and
``tlie_tpu``'s reciprocal c/(c² + d²) overflows float32 there for Δ below
about 0.00177, so that frequency of the kernel becomes 0, and its
derivative squares |g − Λ| again, which overflows at every Δ, so its
``log_step`` gradient loses that frequency's term; the complex division here
keeps both (the value is Δ Σ C̃ᴴB / 2 to first order), as numpy's, JAX's
native complex and the reference's do (``tests/test_torch_s4.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.fft_conv import causal_fft_conv
from ..ops.scan import sp_shard
from .initializers import lecun_normal, log_step_initializer, make_dplr_hippo


def _cmatpow(m: torch.Tensor, power: int) -> torch.Tensor:
    """m**power by repeated squaring (``_cmatpow``'s order of products)."""
    result = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand_as(m)
    base, p = m, power
    while p > 0:
        if p & 1:
            result = result @ base
        base = base @ base
        p >>= 1
    return result


def discrete_dplr(lam: torch.Tensor, p: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, step: torch.Tensor, L: int):
    """Bilinear discretisation of the DPLR system A = diag(Λ) − P Q*.

    lam, p, q, b, c: (..., N) complex; step: (...,) real.  Returns
    (Ā (..., N, N), B̄ (..., N, 1), C̄ (..., 1, N)), with
    C̄ = conj(C̃ conj((I − Ā^L)⁻¹)) as the reference's."""
    n = lam.shape[-1]
    eye = torch.eye(n, dtype=lam.dtype, device=lam.device)
    two = (2.0 / step).to(lam.dtype)
    a = torch.diag_embed(lam) - p[..., :, None] * q[..., None, :].conj()
    a0 = two[..., None, None] * eye + a  # forward Euler half
    d = 1 / (two[..., None] - lam)  # backward Euler half, diagonal
    qd = q.conj()[..., None, :] * d[..., None, :]  # (..., 1, N)
    dp = (d * p)[..., :, None]  # (..., N, 1)
    denom = 1 / (1 + qd @ p[..., :, None])
    a1 = torch.diag_embed(d) - (dp @ qd) * denom
    ab = a1 @ a0
    bb = 2 * (a1 @ b[..., :, None])
    inv = torch.linalg.inv(eye - _cmatpow(ab, L))
    cb = c[..., None, :] @ inv.conj()
    return ab, bb, torch.conj_physical(cb)


def s4_kernel_dplr(lam: torch.Tensor, p: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   step: torch.Tensor, L: int) -> torch.Tensor:
    """Length-L convolution kernels of every channel: lam, p, b, c (N, H)
    complex (c is C̃), step (H,) real → (H, L) real."""
    # the roots of unity and the bilinear frequency map (host constants)
    omega = np.exp(-2j * np.pi * np.arange(L) / L)
    g_base = torch.from_numpy(((1.0 - omega) / (1.0 + omega)).astype(np.complex64))
    c_coef = torch.from_numpy((2.0 / (1.0 + omega)).astype(np.complex64))
    dev = lam.device
    g = (2.0 / step)[:, None] * g_base.to(dev)  # (H, L)
    r = 1 / (g[:, :, None] - lam.T[:, None, :])  # (H, L, N)
    a0, a1, b0, b1 = c.conj(), p.conj(), b, p
    v = torch.stack([a0 * b0, a0 * b1, a1 * b0, a1 * b1], dim=-1)  # (N, H, 4)
    k = r @ v.permute(1, 0, 2)  # (H, L, 4): the four Cauchy reductions
    k00, k01, k10, k11 = k.unbind(-1)
    at_roots = c_coef.to(dev) * (k00 - k01 * (1 / (1 + k11)) * k10)
    return torch.fft.ifft(at_roots, dim=-1).real


class S4(nn.Module):
    """Multichannel S4 layer: (..., L, H) real → (..., L, H) real, L at
    most ``l_max`` (CNN mode applies the kernel's first L taps)."""

    def __init__(self, Lambda_re_init: np.ndarray, Lambda_im_init: np.ndarray,
                 P_init_re: np.ndarray, P_init_im: np.ndarray, B_init_re: np.ndarray,
                 B_init_im: np.ndarray, d_state: int, d_model: int, dt_min: float,
                 dt_max: float, C_init: str, l_max: int, generator: torch.Generator,
                 decode: bool = False):
        super().__init__()
        n, h = d_state, d_model
        self.d_state, self.d_model, self.l_max, self.decode = n, h, l_max, decode

        def tiled(v):
            return torch.from_numpy(np.array(v, dtype=np.float32))[:, None].expand(n, h).clone()

        self.Lambda_re = nn.Parameter(tiled(Lambda_re_init))
        self.Lambda_im = nn.Parameter(tiled(Lambda_im_init))
        self.P = nn.Parameter(torch.stack([tiled(P_init_re), tiled(P_init_im)], -1))
        self.B = nn.Parameter(torch.stack([tiled(B_init_re), tiled(B_init_im)], -1))
        if C_init == "lecun_normal":  # fan-in N: in_axis 0, out_axes (1, 2)
            c = lecun_normal((n, h, 2), n, generator)
        elif C_init == "complex_normal":
            c = torch.randn((n, h, 2), generator=generator) * 0.5**0.5
        else:
            raise NotImplementedError(f"C_init method {C_init} not implemented")
        self.C = nn.Parameter(c)
        self.D = nn.Parameter(torch.ones(1, h))
        self.log_step = nn.Parameter(log_step_initializer((1, h), generator, dt_min, dt_max))

    def parameters_complex(self) -> Tuple[torch.Tensor, ...]:
        """(Λ, P, B, C̃) as (N, H) complex tensors, Re Λ clipped at −1e-4,
        and Δ (H,)."""
        # view_as_complex, not torch.complex: the same values and gradients,
        # and a batching rule under a stacked sweep's vmap, where
        # torch.complex's backward takes .imag of a conjugate view, which
        # vmap cannot batch
        def cx(w):
            return torch.view_as_complex(w.contiguous())

        lam = cx(torch.stack([self.Lambda_re.clamp(max=-1e-4), self.Lambda_im], -1))
        return lam, cx(self.P), cx(self.B), cx(self.C), torch.exp(self.log_step[0])

    def recurrence(self):
        """Each channel's (Ā (H, N, N), B̄ (H, N, 1), C̄ (H, 1, N)) at
        ``l_max``, the RNN mode's and the decoder's."""
        lam, p, b, c, step = self.parameters_complex()
        return discrete_dplr(lam.T, p.T, p.T, b.T, c.T, step, self.l_max)

    @staticmethod
    def rnn_step(consts, x: torch.Tensor, u_t: torch.Tensor):
        """One step of the dense recurrence: state x (..., H, N) complex,
        input u_t (..., H) → (new state, y_t (..., H) real, without D)."""
        ab, bb, cb = consts
        x = torch.einsum("hnm,...hm->...hn", ab, x) + bb[..., 0] * u_t[..., None]
        return x, torch.einsum("hn,...hn->...h", cb[:, 0, :], x).real

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        L = u.shape[-2]
        if L > self.l_max:
            raise ValueError(f"S4 takes sequences of at most l_max={self.l_max}, got {L}")
        if not self.decode:
            if sp_shard() is not None:
                raise NotImplementedError("S4's convolution has no sequence-parallel route; "
                                          "train.sequence_parallel covers the LRU, S5, "
                                          "Mamba-1 and the transformer")
            K = s4_kernel_dplr(*self.parameters_complex(), self.l_max)  # (H, l_max)
            y = causal_fft_conv(u.transpose(-1, -2), K[:, :L]).transpose(-1, -2)
            return y + self.D[0] * u
        consts = self.recurrence()
        x = torch.zeros(u.shape[:-2] + (self.d_model, self.d_state), dtype=consts[0].dtype,
                        device=u.device)
        ys = []
        for t in range(L):
            x, y = self.rnn_step(consts, x, u[..., t, :])
            ys.append(y)
        return torch.stack(ys, dim=-2) + self.D[0] * u


def init_S4(d_state: int, d_model: int, generator: torch.Generator, **cfg):
    """Registry factory (``init_S4``): the DPLR HiPPO init, ``l_max`` from
    the config's ``seq_len``.  Returns a constructor of :class:`S4` drawing
    from ``generator``."""
    lam, p, b, _, _ = make_dplr_hippo(d_state)
    return partial(
        S4, lam.real.astype(np.float32), lam.imag.astype(np.float32),
        p.real.astype(np.float32), p.imag.astype(np.float32),
        b.real.astype(np.float32), b.imag.astype(np.float32),
        d_state=d_state, d_model=d_model, dt_min=cfg.get("dt_min", 0.001),
        dt_max=cfg.get("dt_max", 0.1), C_init=cfg.get("C_init", "complex_normal"),
        l_max=cfg.get("seq_len", 100), generator=generator, decode=cfg.get("decode", False),
    )
