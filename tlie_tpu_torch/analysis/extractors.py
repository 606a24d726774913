"""Eigenvalue extractors, counterpart of ``tlie_tpu/analysis/extractors.py``
for the LRU, S5, S4, Mamba-2 and its pseudo-LTI variant, Mamba-1, and
softmax, linear and norm attention.
Complex spectra are native complex tensors (ROADMAP rule 5)."""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..models.attention_layers import norm_fn_by_name
from ..models.s4 import discrete_dplr
from ..ops.conv import depthwise_causal_conv1d
from ..ops.eig import eigvals

# the reference's guard: an exact-zero normaliser becomes this before the
# ratio (ref eval_eig.py:127)
ZERO_GUARD = 2e-23


def eig_lru(layer_params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """λ = exp(−exp(ν_log) + i·exp(θ_log)) (ref eval_eig.py:318-329), as
    complex64, computed in float32 like ``tlie_tpu``."""
    nu_log = torch.as_tensor(layer_params["nu_log"], dtype=torch.float32)
    theta_log = torch.as_tensor(layer_params["theta_log"], dtype=torch.float32)
    return torch.polar(torch.exp(-torch.exp(nu_log)), torch.exp(theta_log))


def eig_s5(layer_params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """λ = exp(Λ · exp(log_step)) elementwise (``eig_s5``), as complex64,
    computed in float32 as e^{Re}·(cos Im + i sin Im) like ``tlie_tpu``."""
    step = torch.exp(torch.as_tensor(layer_params["log_step"], dtype=torch.float32).flatten())
    lam_re = torch.as_tensor(layer_params["Lambda_re"], dtype=torch.float32)
    lam_im = torch.as_tensor(layer_params["Lambda_im"], dtype=torch.float32)
    return torch.polar(torch.exp(lam_re * step), lam_im * step)


def _complex_param(p) -> torch.Tensor:
    """A complex parameter from the trailing (re, im) layout or a complex
    array, as a reference checkpoint restored on the CPU holds S4's P and B
    (``_pair_from_param``); a real array without that axis is taken as real."""
    t = torch.as_tensor(p)
    if t.is_complex():
        return t.to(torch.complex64)
    t = t.float()
    if t.shape[-1] == 2:
        return torch.complex(t[..., 0], t[..., 1])
    return torch.complex(t, torch.zeros_like(t))


def eig_s4(layer_params: Mapping[str, torch.Tensor], idx: int, seq_len: int,
           eig_impl: str = "host") -> torch.Tensor:
    """Eigenvalues (N,) complex64 of channel ``idx``'s dense discretised DPLR
    Ā (``eig_s4``): :func:`discrete_dplr` on the parameters' device, then
    :func:`tlie_tpu_torch.ops.eig.eigvals` (host LAPACK, as ``tlie_tpu``, or
    ``torch.linalg.eigvals`` with ``eig_impl="device"``)."""
    f32 = torch.float32
    step = torch.exp(torch.as_tensor(layer_params["log_step"], dtype=f32)[0, idx])
    lam = torch.complex(
        torch.as_tensor(layer_params["Lambda_re"], dtype=f32)[:, idx].clamp(max=-1e-4),
        torch.as_tensor(layer_params["Lambda_im"], dtype=f32)[:, idx])
    p = _complex_param(layer_params["P"])[:, idx].to(lam.device)
    b = _complex_param(layer_params["B"])[:, idx].to(lam.device)
    c = _complex_param(layer_params["C"])[:, idx].to(lam.device)
    ab, _, _ = discrete_dplr(lam, p, p, b, c, step, seq_len)
    return eigvals(ab, impl=eig_impl)


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


def eig_mamba2_lti(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """λ = exp(β·A) with β ≡ 1 and A = −softplus(A) per head for
    ``SSD_LTI`` (``eig_mamba2_lti``, ref eval_eig.py:192-205): constant over
    the batch and time, broadcast to (B, L, nheads) float32 by the layer's
    output ``x`` (B, L, d)."""
    lam = torch.exp(-F.softplus(A))
    return lam.expand(x.shape[0], x.shape[1], lam.shape[-1])


def eig_mamba1(x: torch.Tensor, in_proj_weight: torch.Tensor, in_proj_bias,
               conv_weight: torch.Tensor, conv_bias: torch.Tensor, x_proj_weight: torch.Tensor,
               dt_proj_weight: torch.Tensor, dt_proj_bias: torch.Tensor, A_log: torch.Tensor,
               d_inner: int, dt_rank: int) -> torch.Tensor:
    """λ_t = exp(Δ_t[d]·A[d, n]) for Mamba-1 (``eig_mamba1``), flattened
    over the (d_inner, d_state) lattice → (B, L, d_inner·N) float32.  Δ is
    the layer's own step: the x half of ``in_proj(x)`` → the depthwise
    causal conv → SiLU → the dt slice of ``x_proj`` → ``dt_proj`` →
    softplus.  Weights in ``nn.Linear``'s (out, in) and ``nn.Conv1d``'s
    (C, 1, K) layouts."""
    proj = x @ in_proj_weight.t()
    if in_proj_bias is not None:
        proj = proj + in_proj_bias
    xm = F.silu(depthwise_causal_conv1d(proj[..., :d_inner], conv_weight, conv_bias))
    dt_lr = (xm @ x_proj_weight.t())[..., :dt_rank]
    dt = F.softplus(dt_lr @ dt_proj_weight.t() + dt_proj_bias)  # (B, L, d_inner)
    lam = torch.exp(dt[..., None] * (-torch.exp(A_log)))  # (B, L, d_inner, N)
    return lam.reshape(lam.shape[0], lam.shape[1], -1)


def eta_softmax_from_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """η_t of the softmax-attention normaliser recurrence from q, k heads
    (B, L, H, D) → (B, L−1, H) (``eta_softmax_from_qk``, ref
    eval_eig.py:43-95): η_t = ν_t/ν_{t+1}, ν_t = Σ_s exp(score[t, s] − m_t),
    with the scores above the diagonal set to 0 *and* the subtracted row max
    m_t (taken over the row, zeros included) set to 0 there, so that each
    masked entry adds exp(0) = 1 to ν_t.  The reference's quirk, kept."""
    L = q.shape[1]
    scores = torch.einsum("bthd,bshd->btsh", q, k)
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    scores = torch.where(causal, scores, torch.zeros((), dtype=scores.dtype, device=q.device))
    m = scores.amax(dim=2)  # (B, L, H), the zeros included
    shifted = torch.where(causal, scores - m[:, :, None, :], torch.zeros((), dtype=scores.dtype,
                                                                          device=q.device))
    se = torch.exp(shifted).sum(dim=2)
    return (se[:, :-1] / se[:, 1:]) * torch.exp(m[:, :-1] - m[:, 1:])


def eig_att_softmax(x: torch.Tensor, wqkv_weight: torch.Tensor, wqkv_bias, d_qk: int,
                    num_heads: int) -> torch.Tensor:
    """η_t of softmax attention recomputed from the fused ``Wqkv`` projection
    of x (``eig_att_softmax``); ``wqkv_weight`` is the ``nn.Linear`` (out,
    in) weight.  Returns (B, L−1, H) float32."""
    B, L, _ = x.shape
    head_dim = d_qk // num_heads
    qkv = x @ wqkv_weight.t()
    if wqkv_bias is not None:
        qkv = qkv + wqkv_bias
    q = qkv[..., :d_qk].reshape(B, L, num_heads, head_dim)
    k = qkv[..., d_qk: 2 * d_qk].reshape(B, L, num_heads, head_dim)
    return eta_softmax_from_qk(q, k)


def _guard(nu: torch.Tensor) -> torch.Tensor:
    """``nu`` with its zeros replaced by ZERO_GUARD; a subnormal counts as
    zero, since XLA flushes float32 subnormals to zero on the CPU and the
    TPU (a norm-attention n of exp(−90) would otherwise divide its successor
    to inf where ``tlie_tpu`` gives successor / 2e-23)."""
    zero = nu.abs() < torch.finfo(nu.dtype).tiny
    return torch.where(zero, torch.full((), ZERO_GUARD, dtype=nu.dtype, device=nu.device), nu)


def eig_att_linear(x: torch.Tensor, wqkv_weight: torch.Tensor, wqkv_bias, d_qk: int,
                   num_heads: int) -> torch.Tensor:
    """η_t of linear attention (``eig_att_linear``, ref eval_eig.py:97-135):
    ν_t = (elu(q_t)+1)·Σ_{s≤t}(elu(k_s)+1) from x through ``Wqkv`` (no conv,
    as the reference), a zero or subnormal ν replaced by 2e-23, η_t = ν_t/ν_{t+1}.
    Returns (B, L−1, H) float32."""
    B, L, _ = x.shape
    head_dim = d_qk // num_heads
    qkv = x @ wqkv_weight.t()
    if wqkv_bias is not None:
        qkv = qkv + wqkv_bias
    q = F.elu(qkv[..., :d_qk].reshape(B, L, num_heads, head_dim)) + 1
    k = F.elu(qkv[..., d_qk: 2 * d_qk].reshape(B, L, num_heads, head_dim)) + 1
    nu = _guard(torch.einsum("blhd,blhd->blh", q, torch.cumsum(k, dim=1)))
    return nu[:, :-1] / nu[:, 1:]


def eig_att_norm(x: torch.Tensor, wvqkn_weight: torch.Tensor, wvqkn_bias, d_qk: int,
                 d_model: int, norm_fn: str, offset=None) -> torch.Tensor:
    """η_t of norm attention (``eig_att_norm``, ref eval_eig.py:137-174):
    n_t = exp(−norm_fn(n-proj (+ offset))) from the n block of ``Wvqkn``,
    a zero or subnormal n replaced by 2e-23 (:func:`_guard`), η_t =
    n_{t+1}/n_t.  Returns (B, L−1,
    H) float32."""
    proj = x @ wvqkn_weight.t()
    if wvqkn_bias is not None:
        proj = proj + wvqkn_bias
    n = proj[..., d_model + 2 * d_qk:]
    if offset is not None:
        n = n + offset
    n = _guard(torch.exp(-norm_fn_by_name(norm_fn)(n)))
    return n[:, 1:] / n[:, :-1]
