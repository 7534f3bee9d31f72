# -*- coding: utf-8 -*-
"""Result plotting: the reference's double-panel figure — log-log data+fit
with background level, size-distribution bars with uncertainty and the
minimum-observability line, and a stats box — rendered headlessly.

Reference: PlotResults / plot1D / plotHist / plotStats
(src/mcsas/mcsas/plotting.py:80-643).  The reference pushes interactive Qt
windows through a subprocess to avoid blocking (mcsas.py:693-708); here
plotting is a pure host-side function on the Agg backend writing a PDF/PNG
(interactive display optional), so no process gymnastics are needed.

numpy and matplotlib only: the PyTorch port's results hold numpy arrays.
matplotlib is an optional dependency, imported only by the callers that
plot (``OutputFiles.write_all(plot=True)``, ``run_files(plot=True)``,
the CLI's ``--plot``).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

import matplotlib
matplotlib.use("Agg", force=False)
import matplotlib.pyplot as plt  # noqa: E402

log = logging.getLogger(__name__)


def _format_moments_box(hist) -> str:
    m = hist.moments
    rows = [("total", m.total), ("mean", m.mean), ("var", m.variance),
            ("skew", m.skew), ("kurt", m.kurtosis)]
    return "\n".join(f"{name:>6s}: {v[0]:.3e} ± {v[1]:.1e}"
                     for name, v in rows)


def _format_algo_info(result) -> str:
    """Algorithm-information block (reference formatAlgoInfo:
    src/mcsas/mcsas/plotting.py:281-303): data title, q limits, active
    parameters + ranges, background/scaling ± std over reps, timing and
    iteration counts."""
    d = result.data
    bound = result.bound
    eng = result.engine
    lines = [f"Fitting of data: {d.title or 'untitled'}"]
    q = np.asarray(d.q, np.float64) * 1e-9
    lines.append(f"q = [{q.min():.4g}, {q.max():.4g}] nm⁻¹  "
                 f"({d.count} points)")
    ranges = []
    for name, (lo, hi) in zip(bound.active, bound.ranges):
        unit = bound.model.spec(name).unit
        ranges.append(f"{name} ∈ [{unit.to_display(lo):.4g}, "
                      f"{unit.to_display(hi):.4g}] {unit.display}")
    lines.append(f"Active parameters: {bound.n_active} "
                 f"({'; '.join(ranges)})")
    bg_mean, bg_std = result.background
    sc_mean, sc_std = result.scaling
    lines.append(f"Background level: {bg_mean:3.3g} ± {bg_std:3.3g}")
    lines.append(f"( Scaling factor: {sc_mean:3.3g} ± {sc_std:3.3g} )")
    n_it = eng.n_iter
    lines.append(f"Timing: {eng.num_reps} repetitions in "
                 f"{eng.elapsed:3.3g} s  "
                 f"({n_it.mean():,.0f} ± {n_it.std():,.0f} "
                 "proposals/repetition)")
    chi2 = eng.conval
    lines.append(f"Reduced χ²: {chi2.mean():3.3g} ± {chi2.std():3.3g}  "
                 f"({int(eng.converged.sum())}/{eng.num_reps} converged)")
    return "\n".join(lines)


def plot_results(result, output_filename: Optional[str] = None,
                 axis_margin: float = 0.3, auto_close: bool = True,
                 show: bool = False, show_reps: bool = False):
    """Draws the fit panel plus one histogram panel per histogram spec,
    with the reference's algorithm-information strip above the panels
    (formatAlgoInfo/plotInfo: src/mcsas/mcsas/plotting.py:281-303,
    490-509), its axis-margin limits (plot1D :423-428, plotHist
    :530-540), and — with *show_reps* — the per-repetition partial
    intensity curves (plotPartial :407-411).

    Returns the matplotlib Figure (closed if auto_close and not shown).
    """
    hists = result.histograms
    n_panels = 1 + len(hists)
    fig = plt.figure(figsize=(5.0 * n_panels, 5.4))
    gs = fig.add_gridspec(2, n_panels, height_ratios=[1.0, 3.6],
                          hspace=0.05)
    info_ax = fig.add_subplot(gs[0, :])
    info_ax.axis("off")
    info_ax.text(0.01, 0.95, _format_algo_info(result),
                 transform=info_ax.transAxes, fontsize=7,
                 family="monospace", ha="left", va="top")
    axes = np.asarray([fig.add_subplot(gs[1, i])
                       for i in range(n_panels)])

    # --- fit panel (reference plot1D: plotting.py:413-486) --------------
    ax = axes[0]
    d = result.data
    q_disp = d.q * 1e-9          # show in nm⁻¹ like the reference UI
    ax.errorbar(q_disp, d.f, yerr=d.fu, fmt=".", color="#666666",
                markersize=3, elinewidth=0.5, label="data", zorder=2)
    if show_reps:
        for rep_curve in result._measval:
            ax.plot(q_disp, rep_curve, "b-", lw=0.5, alpha=0.35,
                    zorder=3)
        ax.plot([], [], "b-", lw=0.5, alpha=0.6,
                label="MC partial (per rep)")
    ax.plot(q_disp, result.fit_measval_mean, "r-", lw=1.5, label="MC fit",
            zorder=4)
    lo = result.fit_measval_mean - result.fit_measval_std
    hi = result.fit_measval_mean + result.fit_measval_std
    ax.fill_between(q_disp, lo, hi, color="r", alpha=0.2, lw=0)
    bg_mean, _ = result.background
    if bg_mean > 0:
        ax.axhline(bg_mean, color="b", ls="--", lw=1,
                   label="background")
    ax.set_xscale("log")
    ax.set_yscale("log")
    # reference axis margins (plot1D plotting.py:423-428): x from the
    # data extent, y from the smallest NONZERO intensity, both padded
    # by axis_margin
    ax.set_xlim(q_disp.min() * (1.0 - axis_margin),
                q_disp.max() * (1.0 + axis_margin))
    f = np.asarray(d.f, np.float64)
    # strictly positive floor: background-subtracted data can carry
    # negative points (f_mask_neg defaults off) and a non-positive
    # lower limit is silently ignored on a log axis
    nz = f[f > 0.0]
    if nz.size:
        ax.set_ylim(nz.min() * (1.0 - axis_margin),
                    f.max() * (1.0 + axis_margin))
    ax.set_xlabel("q (nm$^{-1}$)")
    ax.set_ylabel("I (m sr)$^{-1}$")
    ax.legend(loc="lower left", fontsize=8)
    ax.set_title(d.title or "fit", fontsize=9)

    # --- histogram panels (reference plotHist: plotting.py:510-604) -----
    for ax, h in zip(axes[1:], hists):
        unit = result.bound.model.spec(h.spec.param).unit
        x = unit.to_display(h.x_mean)
        width = unit.to_display(h.x_width)
        ax.bar(x, h.bins.mean, width=0.9 * width, yerr=h.bins.std,
               color="orange", edgecolor="k", linewidth=0.3,
               error_kw=dict(elinewidth=0.7), label=h.spec.yweight)
        ax.plot(x, h.observability, "r--", lw=1.2,
                label="min. observability")
        if h.spec.xscale == "log":
            ax.set_xscale("log")
        # reference histogram x-margins (plotHist plotting.py:530-540):
        # bar extents padded by axis_margin
        edges = unit.to_display(np.asarray(h.x_lower_edge, np.float64))
        ax.set_xlim(edges.min() * (1.0 - axis_margin),
                    edges.max() * (1.0 + axis_margin))
        ax.set_xlabel(f"{h.spec.param} ({unit.display})")
        ax.set_ylabel(f"{h.spec.yweight} fraction")
        ax.legend(fontsize=7)
        ax.text(0.98, 0.97, _format_moments_box(h),
                transform=ax.transAxes, fontsize=6, family="monospace",
                ha="right", va="top",
                bbox=dict(boxstyle="round", fc="w", alpha=0.7))

    # tight_layout is incompatible with the axis("off") info strip and
    # only warns; lay the panels out against the gridspec instead of
    # spraying a UserWarning on every plot call
    gs.tight_layout(fig)
    if output_filename:
        fig.savefig(output_filename)
        log.info("wrote plot to %s", output_filename)
    if show:  # pragma: no cover - interactive
        plt.show()
    elif auto_close:
        plt.close(fig)
    return fig


def plot_series_stats(series: dict, output_filename: Optional[str] = None,
                      auto_close: bool = True):
    """Mean ± std of each histogram range across a file series
    (reference PlotSeriesStats: plotting.py:606-643)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for (param, lo, hi, weight), entries in series.items():
        labels = [str(t) for t, _ in entries]
        means = [f[2] for _, f in entries]      # mean field
        stds = [f[3] for _, f in entries]       # meanStd field
        ax.errorbar(range(len(entries)), means, yerr=stds, marker="o",
                    label=f"{param} [{lo:g},{hi:g}] {weight}")
        ax.set_xticks(range(len(entries)))
        ax.set_xticklabels(labels, rotation=45, fontsize=7)
    ax.set_ylabel("distribution mean")
    ax.legend(fontsize=7)
    fig.tight_layout()
    if output_filename:
        fig.savefig(output_filename)
    if auto_close:
        plt.close(fig)
    return fig
