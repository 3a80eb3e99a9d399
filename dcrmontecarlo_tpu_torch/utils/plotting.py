"""Walk-history visualizers (port of ``utils/plotting.py``, the C11 consumers,
``utils.py:237-639``): single-walk path plot, multi-walk overlay, and
walk-statistics histograms, driven by :class:`WalkHistory` captures.

matplotlib is an optional dependency; importing this module without it
raises only when a plot function is called.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_walk_history", "plot_multiple_walks", "plot_walk_statistics",
           "plot_voltage_profile", "plot_pseudosection"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _draw_boundaries(ax, problem):
    if problem is None:
        return
    pts = np.asarray(problem.dirichlet.points)
    ax.plot(pts[:, 0], pts[:, 1], "k-", lw=1.5, label="Dirichlet")
    if problem.neumann is not None:
        npts = np.asarray(problem.neumann.points)
        ax.plot(npts[:, 0], npts[:, 1], "r-", lw=1.5, label="Neumann")


def plot_walk_history(history, walk_id: int = 0, problem=None, show_circles=True,
                      save_path=None, source: int = 0):
    """Single walk: path, step circles, contribution markers
    (reference ``plot_walk_history``, ``utils.py:237-431``).

    ``source`` selects which source field's contributions/total are drawn
    for multi-source ensembles (pseudosection sweeps trace every current
    dipole from the one shared walk set).
    """
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    _draw_boundaries(ax, problem)
    T = int(history.walk_length[walk_id]) + 1
    path = history.positions[walk_id, :T]
    ax.plot(path[:, 0], path[:, 1], "b.-", ms=4, lw=1, label="walk path")
    ax.plot(*history.point, "g*", ms=14, label="start")
    ax.plot(*path[-1], "rs", ms=8, label="end")
    if show_circles:
        from matplotlib.patches import Circle

        for t in range(T - 1):
            ax.add_patch(
                Circle(path[t], float(history.radius[walk_id, t]),
                       fill=False, alpha=0.15, color="gray", lw=0.5)
            )
    if source and history.source_contrib_all is not None:
        src = history.source_contrib_all[source][walk_id, :T]
        total = float(history.total_all[source][walk_id])
    else:
        src = history.source_contrib[walk_id, :T]
        total = float(history.total[walk_id])
    nz = np.nonzero(src)[0]
    if len(nz):
        ax.scatter(path[nz, 0], path[nz, 1], c="orange", s=25, zorder=5,
                   label="source contributions")
    ax.set_title(
        f"walk {walk_id}: {T - 1} steps, "
        f"total {total:.4g}"
        + (f" (source {source})" if source else "")
    )
    ax.legend(loc="best", fontsize=8)
    ax.set_aspect("equal")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_multiple_walks(history, max_walks: int = 20, problem=None,
                        save_path=None):
    """Overlay of many walk paths colored by contribution
    (reference ``plot_multiple_walks``, ``utils.py:434-559``)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    _draw_boundaries(ax, problem)
    n = min(max_walks, history.positions.shape[0])
    totals = history.total[:n]
    vmin, vmax = float(totals.min()), float(totals.max())
    cmap = plt.get_cmap("viridis")
    for w in range(n):
        T = int(history.walk_length[w]) + 1
        path = history.positions[w, :T]
        c = cmap(0.5 if vmax == vmin else (totals[w] - vmin) / (vmax - vmin))
        ax.plot(path[:, 0], path[:, 1], "-", color=c, alpha=0.6, lw=0.8)
        ax.plot(*path[-1], "s", color=c, ms=4)
    ax.plot(*history.point, "r*", ms=14, label="start")
    ax.set_title(f"{n} walks from {tuple(np.round(history.point, 3))}")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_walk_statistics(history, save_path=None):
    """Histograms of walk length and contribution + step-distance traces
    (reference ``plot_walk_statistics``, ``utils.py:562-639``)."""
    plt = _mpl()
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    axes[0, 0].hist(history.walk_length, bins=20, color="steelblue")
    axes[0, 0].set_title("walk length (steps)")
    axes[0, 1].hist(history.total, bins=20, color="darkorange")
    axes[0, 1].set_title("walk contribution")
    for w in range(min(10, history.positions.shape[0])):
        T = int(history.walk_length[w]) + 1
        axes[1, 0].plot(history.d_dirichlet[w, :T], alpha=0.6, lw=0.8)
    axes[1, 0].set_title("Dirichlet distance vs step")
    axes[1, 0].set_yscale("log")
    mean = history.total.mean()
    sem = history.total.std() / np.sqrt(len(history.total))
    axes[1, 1].axis("off")
    axes[1, 1].text(
        0.1, 0.6,
        f"walks: {len(history.total)}\n"
        f"mean: {mean:.5g}\n"
        f"stderr: {sem:.3g}\n"
        f"mean length: {history.walk_length.mean():.1f} steps",
        fontsize=12,
    )
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_voltage_profile(result, survey=None, conductivity=None,
                         bounds=None, save_path=None):
    """Surface voltage profile + conductivity section for a DCR survey.

    Reproduces the reference's scenario figure
    (``tests/testGeophysicalScenario.py:156-223``,
    ``dcr_survey_results.png``): top panel — electrode potentials with MC
    error bars and adjacent dipole voltages; bottom panel — the
    conductivity model with electrode/current-source markers.

    Args:
        result: :class:`~dcrmontecarlo_tpu_torch.survey.SurveyResult`.
        survey: optional :class:`DCRSurvey` (draws sources + domain).
        conductivity: optional ``alpha(x, y)`` override for the section.
        bounds: ``((x0, x1), (y0, y1))`` section extent (defaults to the
            survey's half-space box).
    """
    plt = _mpl()
    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(10, 8), height_ratios=[1, 1.2]
    )
    x = np.asarray(result.electrodes)[:, 0]
    ax1.errorbar(x, result.potentials, yerr=result.potentials_stderr,
                 fmt="o-", capsize=3, label="potential $u$ [V]")
    xm = 0.5 * (x[:-1] + x[1:])
    ax1.errorbar(xm, result.voltages, yerr=result.voltages_stderr,
                 fmt="s--", capsize=3, label="dipole voltage $\\Delta V$")
    ax1.axhline(0.0, color="0.7", lw=0.8)
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("voltage [V]")
    ax1.legend()
    ax1.set_title("DCR survey: surface potentials and dipole voltages")

    cond = conductivity
    if cond is None and survey is not None:
        cond = survey.conductivity
    if bounds is None and survey is not None:
        bounds = ((-survey.half_width, survey.half_width),
                  (survey.surface_y - survey.depth, survey.surface_y))
    if cond is not None and bounds is None:
        # a conductivity override without survey/bounds has no extent to
        # draw; fall back to the electrode line's bounding box
        el = np.asarray(result.electrodes)
        span = max(1.0, float(np.ptp(el[:, 0])))  # ndarray.ptp: gone in np2
        bounds = ((el[:, 0].min() - 0.1 * span, el[:, 0].max() + 0.1 * span),
                  (el[:, 1].min() - span, el[:, 1].max() + 0.1 * span))
    if cond is not None:
        (x0, x1), (y0, y1) = bounds
        import torch

        gx = np.linspace(x0, x1, 241)
        gy = np.linspace(y0, y1, 241)
        X, Y = np.meshgrid(gx, gy, indexing="ij")
        A = np.asarray(cond(
            torch.as_tensor(X.ravel(), dtype=torch.float32),
            torch.as_tensor(Y.ravel(), dtype=torch.float32))).reshape(X.shape)
        pc = ax2.pcolormesh(X, Y, A, shading="auto", cmap="viridis")
        fig.colorbar(pc, ax=ax2, label="conductivity [S/m]")
        ax2.plot(x, np.asarray(result.electrodes)[:, 1], "wv",
                 markersize=6, label="electrodes")
        if survey is not None:
            ax2.plot(*survey.current_a, "r+", markersize=14, mew=3,
                     label="+I")
            ax2.plot(*survey.current_b, "b_", markersize=14, mew=3,
                     label="-I")
        ax2.legend(loc="lower right")
        ax2.set_xlabel("x [m]")
        ax2.set_ylabel("y [m]")
        ax2.set_title("conductivity model")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig


def plot_pseudosection(ps, value="apparent_resistivity", log_abs=True,
                       save_path=None):
    """Dipole-dipole pseudosection scatter (SimPEG ``plot_pseudosection``
    convention, ``testNotebook.ipynb`` cell 15): measurements placed at the
    source/receiver midpoint with half their separation as pseudo-depth.

    Args:
        ps: :class:`~dcrmontecarlo_tpu_torch.survey.Pseudosection`.
        value: ``"apparent_resistivity"`` or ``"voltage"``.
        log_abs: color by ``log10 |value|`` (standard for resistivities).
    """
    plt = _mpl()
    v = np.asarray(getattr(ps, value), np.float64)
    c = np.log10(np.maximum(np.abs(v), 1e-30)) if log_abs else v
    fig, ax = plt.subplots(figsize=(10, 5))
    sc = ax.scatter(ps.pseudo_x, ps.pseudo_z, c=c, s=120, marker="s",
                    cmap="viridis", edgecolors="k", linewidths=0.3)
    label = value.replace("_", " ")
    fig.colorbar(
        sc, ax=ax,
        label=(f"log10 |{label}|" if log_abs else label),
    )
    ax.set_xlabel("midpoint x [m]")
    ax.set_ylabel("pseudo-depth [m]")
    ax.set_title(f"dipole-dipole pseudosection: {label}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig
