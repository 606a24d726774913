"""Render the spectra figures from an analysis artifact directory,
counterpart of ``tools/plot_spectra.py`` (the reference notebook's plotting
cells): per-layer radius-bin bars, the layers × heads bin grid, and the
grouped-by-head comparison with batch-std error bars, from the artifacts
:func:`tlie_tpu_torch.analysis.eval_eig` (or ``tlie_tpu``'s) writes:

* the attention and Mamba families: ``percentage*.npy`` shaped (bins, B, H,
  layers);
* the SSM families (LRU, S4, S5): shaped (bins, layers), with a
  complex-plane scatter of ``eig.npy`` against the unit circle.

    python -m tlie_tpu_torch.tools.plot_spectra <artifact dir> [--out <dir>] \\
        [--heads 0 1 2] [--layers 0 1 2] [--phase]

It writes the root tool's file names (``radius_bins_per_layer.png``,
``radius_bins_layers_heads.png``, ``radius_bins_by_head.png``,
``spectrum_unit_circle.png``; ``--phase`` bins the phases into the same
names).  The bin labels come from the port's own thresholds
(:mod:`tlie_tpu_torch.analysis.binning`).  It needs matplotlib, imported in
:func:`main` alone, so that the package imports where matplotlib is
missing.

Design notes, as the root tool's: one measure per axis; magnitude bars use
a single hue; trained-vs-init and per-head identity use a fixed-order
colorblind-safe (Okabe-Ito) palette with a legend, identity also carried by
panel position and order; grids are recessive; text stays in neutral ink.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..analysis.binning import PHASE_THRESHOLDS, RADIUS_THRESHOLDS

# Okabe-Ito (Wong, Nature Methods 2011) — fixed assignment order, never cycled.
CAT = ["#0072B2", "#E69F00", "#009E73", "#CC79A7", "#56B4E9", "#D55E00",
       "#F0E442", "#000000"]
INK = "#333333"
GRID = dict(color="#dddddd", linewidth=0.8, zorder=0)


def _bin_labels(thresholds) -> list:
    """Labels matching the binning boundary conventions of
    :mod:`tlie_tpu_torch.analysis.binning`."""
    t = np.asarray(thresholds, dtype=float)
    labels = [f"[0, {t[0]:g}]"]
    labels += [f"[{t[i]:g}, {t[i + 1]:g}]" for i in range(len(t) - 1)]
    labels.append(f"({t[-1]:g}, ∞)")
    return labels


def _style(ax):
    ax.grid(axis="y", **GRID)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.tick_params(colors=INK, labelsize=9)


def _save(plt, fig, out_dir, name):
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"[plot] {path}")


def plot_per_layer(plt, pct, pct_init, labels, out_dir, stem):
    """Per-layer bars, trained vs init side by side (ref notebook cell 26,
    plus the init comparison the artifact set carries)."""
    n_bins, n_layers = pct.shape
    fig, axes = plt.subplots(
        1, n_layers, figsize=(2.8 * n_layers + 1, 3.4), sharey=True, squeeze=False
    )
    x = np.arange(n_bins)
    for ly in range(n_layers):
        ax = axes[0, ly]
        ax.bar(x - 0.2, pct_init[:, ly], width=0.38, color=CAT[1],
               label="init", zorder=3)
        ax.bar(x + 0.2, pct[:, ly], width=0.38, color=CAT[0],
               label="trained", zorder=3)
        ax.set_title(f"Layer {ly}", fontsize=10, color=INK)
        ax.set_xticks(x)
        ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=8)
        _style(ax)
    axes[0, 0].set_ylabel("Eigenvalues in bin (%)", color=INK)
    axes[0, 0].legend(frameon=False, fontsize=9)
    fig.suptitle(f"Eigenvalue bins per layer — {stem}", color=INK, fontsize=11,
                 y=1.06)
    _save(plt, fig, out_dir, "radius_bins_per_layer.png")


def plot_layers_heads(plt, pct, labels, out_dir, heads, layers):
    """Layers × heads grid of bin bars (ref notebook cell 28)."""
    fig, axes = plt.subplots(
        len(layers), len(heads),
        figsize=(2.4 * len(heads) + 1, 2.0 * len(layers) + 1),
        sharex=True, sharey=True, squeeze=False,
    )
    x = np.arange(pct.shape[0])
    for i, ly in enumerate(layers):
        for j, h in enumerate(heads):
            ax = axes[i, j]
            ax.bar(x, pct[:, h, ly], color=CAT[0], zorder=3)
            if i == len(layers) - 1:
                ax.set_xticks(x)
                ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=7)
            if j == 0:
                ax.set_ylabel(f"Layer {ly}", color=INK, fontsize=9)
            if i == 0:
                ax.set_title(f"Head {h}", color=INK, fontsize=9)
            _style(ax)
    fig.suptitle("Eigenvalue bins per (layer, head)", color=INK, fontsize=11)
    _save(plt, fig, out_dir, "radius_bins_layers_heads.png")


def plot_by_head(plt, mean_pct, std_pct, labels, out_dir, heads, layers):
    """Grouped bars per head with batch-std error bars, one panel per layer
    (ref notebook cells 29-30).  Heads keep a fixed hue order; >8 heads plot
    the first 8 (stated on the figure) rather than cycling hues."""
    if len(heads) > len(CAT):
        heads = heads[: len(CAT)]
    fig, axes = plt.subplots(
        len(layers), 1, figsize=(1.4 * mean_pct.shape[0] * max(1, len(heads) // 2) + 2,
                                 2.6 * len(layers)),
        sharex=True, squeeze=False,
    )
    n_bins = mean_pct.shape[0]
    group_w = 0.8
    bar_w = group_w / len(heads)
    x = np.arange(n_bins)
    for i, ly in enumerate(layers):
        ax = axes[i, 0]
        for j, h in enumerate(heads):
            off = -group_w / 2 + (j + 0.5) * bar_w
            ax.bar(x + off, mean_pct[:, h, ly], width=bar_w * 0.92,
                   color=CAT[j], label=f"Head {h}" if i == 0 else None,
                   yerr=std_pct[:, h, ly], error_kw=dict(elinewidth=1, capsize=2,
                                                         ecolor=INK), zorder=3)
        ax.set_ylabel(f"Layer {ly}\n(%)", color=INK, fontsize=9)
        _style(ax)
    axes[-1, 0].set_xticks(x)
    axes[-1, 0].set_xticklabels(labels, rotation=45, ha="right", fontsize=8)
    axes[0, 0].legend(frameon=False, fontsize=9, ncols=min(4, len(heads)))
    fig.suptitle("Eigenvalue bins by head (mean ± std over batch)",
                 color=INK, fontsize=11)
    _save(plt, fig, out_dir, "radius_bins_by_head.png")


def plot_unit_circle(plt, eig, eig_init, out_dir):
    """SSM complex spectra on the complex plane vs the unit circle."""
    n_layers = eig.shape[-1]
    fig, axes = plt.subplots(1, n_layers, figsize=(3.0 * n_layers, 3.2),
                             squeeze=False)
    th = np.linspace(0, 2 * np.pi, 256)
    for ly in range(n_layers):
        ax = axes[0, ly]
        ax.plot(np.cos(th), np.sin(th), color="#bbbbbb", linewidth=1, zorder=1)
        ax.scatter(eig_init[:, ly].real, eig_init[:, ly].imag, s=12,
                   color=CAT[1], label="init", zorder=2)
        ax.scatter(eig[:, ly].real, eig[:, ly].imag, s=12, color=CAT[0],
                   label="trained", zorder=3)
        ax.set_title(f"Layer {ly}", fontsize=10, color=INK)
        ax.set_aspect("equal")
        _style(ax)
    axes[0, 0].legend(frameon=False, fontsize=9)
    fig.suptitle("Spectrum vs unit circle", color=INK, fontsize=11)
    _save(plt, fig, out_dir, "spectrum_unit_circle.png")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact_dir")
    ap.add_argument("--out", default=None, help="output dir (default: artifact dir)")
    ap.add_argument("--heads", type=int, nargs="*", default=None)
    ap.add_argument("--layers", type=int, nargs="*", default=None)
    ap.add_argument("--phase", action="store_true",
                    help="plot phase bins instead of radius bins")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = args.artifact_dir.rstrip("/")
    out_dir = args.out or d
    os.makedirs(out_dir, exist_ok=True)

    which = "percentage_phase" if args.phase else "percentage"
    thresholds = PHASE_THRESHOLDS if args.phase else RADIUS_THRESHOLDS
    pct = np.load(os.path.join(d, which + ".npy"))
    pct_init = np.load(os.path.join(d, which + "_init.npy"))
    labels = _bin_labels(thresholds)

    if pct.ndim == 2:  # SSM families: (bins, layers)
        plot_per_layer(plt, pct, pct_init, labels, out_dir, os.path.basename(d))
        eig = np.load(os.path.join(d, "eig.npy"))
        eig_init = np.load(os.path.join(d, "eig_init.npy"))
        if np.iscomplexobj(eig):
            plot_unit_circle(plt, eig, eig_init, out_dir)
        return 0

    # attention and Mamba: (bins, B, H, layers)
    n_heads, n_layers = pct.shape[2], pct.shape[3]
    heads = args.heads if args.heads else list(range(min(8, n_heads)))
    layers = args.layers if args.layers else list(range(min(6, n_layers)))
    mean_pct, std_pct = pct.mean(axis=1), pct.std(axis=1)
    mean_init = pct_init.mean(axis=1)
    plot_per_layer(plt, mean_pct.mean(axis=1), mean_init.mean(axis=1), labels,
                   out_dir, os.path.basename(d))
    plot_layers_heads(plt, mean_pct, labels, out_dir, heads, layers)
    plot_by_head(plt, mean_pct, std_pct, labels, out_dir, heads, layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
