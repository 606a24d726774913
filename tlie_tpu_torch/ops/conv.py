"""Depthwise causal 1-D convolution, counterpart of
``tlie_tpu/ops/conv.py::depthwise_causal_conv1d``.

``tlie_tpu`` lowers it to XLA's grouped convolution, not to a Pallas kernel,
so the port runs PyTorch's: ``F.conv1d(groups=C, padding=K-1)`` sliced back
to the first L steps, the reference's own ``nn.Conv1d`` form.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def depthwise_causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[t] = Σ_k weight[c, 0, k] · x[t − (K−1) + k] (+ bias) per channel c.

    x: (..., L, C); weight: (C, 1, K) in ``nn.Conv1d``'s layout, whose
    ``weight[c, 0, k]`` is ``tlie_tpu``'s ``weight[k, c]``; bias: (C,).
    Returns (..., L, C), contiguous: the convolution runs channels-first,
    and its output is copied back to time-major once here, so that the SSD
    can slice x, B and C out of it as row-strided views."""
    K = weight.shape[-1]
    L, C = x.shape[-2:]
    xr = x.reshape(-1, L, C).transpose(1, 2)
    y = F.conv1d(xr, weight, bias, padding=K - 1, groups=C)[..., :L]
    return y.transpose(1, 2).contiguous().reshape(x.shape)


def conv_tail(x: torch.Tensor, K: int) -> torch.Tensor:
    """The conv's decode state after a prompt x (B, L, C): its last K − 1
    inputs (B, K − 1, C), front-padded with zeros where L < K − 1, and (B,
    0, C) where K ≤ 1 (``Decoder._conv_tail``)."""
    n = max(K - 1, 0)
    tail = x[:, x.shape[1] - min(n, x.shape[1]):]
    if tail.shape[1] < n:
        tail = torch.cat([x.new_zeros(x.shape[0], n - tail.shape[1], x.shape[2]), tail], dim=1)
    return tail


def conv_step(tail: torch.Tensor, x_t: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None):
    """One token through the conv (``_conv_step``): its cached tail (B, K −
    1, C) and the token's input x_t (B, C) → (the tail moved on, y_t (B,
    C)); ``weight`` (C, 1, K) as in :func:`depthwise_causal_conv1d`."""
    window = torch.cat([tail, x_t[:, None]], dim=1)  # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, weight[:, 0])
    return window[:, 1:], (y if bias is None else y + bias)
