"""Eigenvalues of a dense complex matrix for the analysis, counterpart of
``tlie_tpu/ops/eig.py``: S4's spectra are those of its discretised Ā.

* ``impl="host"`` (the default): numpy's LAPACK on the complex64 matrix
  built from the float32 (re, im) planes, the matrix ``tlie_tpu``'s
  ``_host_eigvals`` sees, so the two give the same bits.
* ``impl="device"``: ``torch.linalg.eigvals`` on the tensor's device, in
  place of ``tlie_tpu``'s pair-arithmetic QR (``eig_device.py``, a TPU-only
  workaround).

S4's Ā has eigenvectors of condition about 1e15, so single eigenvalues from
two solvers may differ well beyond rounding while the binned radius and
phase statistics of the analysis agree."""

from __future__ import annotations

import numpy as np
import torch


def eigvals(m: torch.Tensor, impl: str = "host") -> torch.Tensor:
    """Eigenvalues (..., N), unordered, of the complex (..., N, N) ``m``, as
    complex64 on ``m``'s device."""
    if impl == "device":
        return torch.linalg.eigvals(m.to(torch.complex64))
    if impl != "host":
        raise ValueError(f"eigvals impl must be 'host' or 'device', got {impl!r}")
    re = m.real.detach().cpu().numpy().astype(np.float32)
    im = m.imag.detach().cpu().numpy().astype(np.float32)
    w = np.linalg.eigvals(re + 1j * im)
    w = w.real.astype(np.float32) + 1j * w.imag.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(w.astype(np.complex64))).to(m.device)
