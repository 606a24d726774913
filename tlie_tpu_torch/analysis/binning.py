"""Threshold binning of eigenvalue radii / phases into percentage histograms.

Copied from ``tlie_tpu/analysis/binning.py`` (numpy only); a test pins the
copy to the original's output.

Bit-parity with the reference's binning (ref analysis/eval_eig.py:335-391),
including its boundary conventions: the first bin is [0, t₀], middle bins
are CLOSED intervals [tᵢ, tᵢ₊₁] (boundary values count in two bins), the
last bin is (t_last, ∞); negative values fall only into bins whose lower
edge they clear.  Default thresholds: radii [0.1, 0.5, 0.9, 1.0, 10, 100],
phases (degrees) [1, 10, 45, 90, 180] (ref :603, :612).
"""

from __future__ import annotations

import numpy as np

RADIUS_THRESHOLDS = np.array([0.1, 0.5, 0.9, 1.0, 10, 100])
PHASE_THRESHOLDS = np.array([1, 10, 45, 90, 180])


def threshold_analysis(eig_val, thresholds, num_layers=None, num_heads=None, batch_size=None):
    """Bin (B, N, H, Lyr) values → (n_bins+1, B, H, Lyr) percentages over N
    (ref eval_eig.py:335-362)."""
    eta = np.asarray(eig_val)
    thresholds = np.asarray(thresholds).flatten()
    n_thresh = thresholds.shape[0]
    b, n, h, lyr = eta.shape
    percentages = np.empty([n_thresh + 1, b, h, lyr])

    percentages[0] = ((eta >= 0) & (eta <= thresholds[0])).sum(axis=1) / n * 100
    percentages[-1] = (eta > thresholds[-1]).sum(axis=1) / n * 100
    for t in range(n_thresh - 1):
        mask = (eta >= thresholds[t]) & (eta <= thresholds[t + 1])
        percentages[t + 1] = mask.sum(axis=1) / n * 100
    return percentages


def threshold_analysis_ssm(eig_val, thresholds, num_layers=None):
    """Bin (N, Lyr) values → (n_bins+1, Lyr) percentages over N
    (ref eval_eig.py:364-391)."""
    eta = np.asarray(eig_val)
    thresholds = np.asarray(thresholds).flatten()
    n_thresh = thresholds.shape[0]
    n, lyr = eta.shape
    percentages = np.empty([n_thresh + 1, lyr])

    percentages[0] = ((eta >= 0) & (eta <= thresholds[0])).sum(axis=0) / n * 100
    percentages[-1] = (eta > thresholds[-1]).sum(axis=0) / n * 100
    for t in range(n_thresh - 1):
        mask = (eta >= thresholds[t]) & (eta <= thresholds[t + 1])
        percentages[t + 1] = mask.sum(axis=0) / n * 100
    return percentages
