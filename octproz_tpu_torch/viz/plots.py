"""1-D line plots of raw spectra and processed A-scans, with statistics and
CSV export.

A copy of ``octproz_tpu/viz/plots.py`` (numpy; matplotlib is imported only
where a plot is drawn, so the statistics and CSV half runs without it).

Capability-equivalent of the reference's ``PlotWindow1D`` (+PlotArea1D,
StatsLabel; octproz_project/octproz/src/plotwindow1d.{h,cpp}): live raw
spectrum and processed A-scan traces with per-bit-depth casting (incl. the
optional display ``>>4``), min/max/mean/sigma statistics (Welford in the
reference, plotwindow1d.cpp:268-352), line selection, autoscaling, and
CSV/PNG export -- rendered offline with matplotlib instead of QCustomPlot.

Chart conventions: one y-axis per panel, fixed series hue order (raw = slot-1
blue #2a78d6, processed = slot-2 orange #eb6834), thin 2px-equivalent lines,
recessive grid, legends only for multi-series panels, neutral-ink text.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

# fixed categorical order: raw trace, processed trace, extra overlays
SERIES_COLORS = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100")
_TEXT = "#3d3d3a"
_GRID = "#d9d8d3"


@dataclasses.dataclass
class LineStats:
    """min/max/mean/sigma of one trace (StatsLabel analog)."""

    minimum: float
    maximum: float
    mean: float
    std: float

    @staticmethod
    def of(line: np.ndarray) -> "LineStats":
        line = np.asarray(line, np.float64)
        return LineStats(float(line.min()), float(line.max()),
                         float(line.mean()), float(line.std()))

    def label(self) -> str:
        return (f"min {self.minimum:.4g}  max {self.maximum:.4g}  "
                f"mean {self.mean:.4g}  σ {self.std:.4g}")


def cast_raw_line(buffer: np.ndarray, bit_depth: int,
                  bitshift: bool = False) -> np.ndarray:
    """Per-bit-depth display casting of a raw line (plotwindow1d.cpp:268-352),
    incl. the optional display bitshift for 12-in-16-bit digitizers."""
    line = np.asarray(buffer)
    if bit_depth <= 16 and bitshift:
        line = line >> 4
    return line.astype(np.float64)


def select_line(buffer: np.ndarray, bscan: int = 0, ascan: int = 0) -> np.ndarray:
    """Pick one line of a (bscans, ascans, samples) buffer, clamped."""
    b = np.asarray(buffer)
    return b[min(bscan, b.shape[0] - 1), min(ascan, b.shape[1] - 1)]


def export_csv(path: str, *traces: Tuple[str, np.ndarray]) -> str:
    """Write traces as columns: index;name1;name2;...  (MiniCurvePlot's
    index;value CSV convention, octalgorithmparametersmanager.cpp:12-45)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = [name for name, _ in traces]
    arrays = [np.asarray(t, np.float64).ravel() for _, t in traces]
    n = max(a.size for a in arrays)
    with open(path, "w") as f:
        f.write("index;" + ";".join(names) + "\n")
        for i in range(n):
            vals = [("%.9g" % a[i]) if i < a.size else "" for a in arrays]
            f.write(f"{i};" + ";".join(vals) + "\n")
    return path


def _style_axis(ax, title: str):
    ax.set_title(title, color=_TEXT, fontsize=10, loc="left")
    ax.grid(True, color=_GRID, linewidth=0.6, alpha=0.8)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(_GRID)
    ax.tick_params(colors=_TEXT, labelsize=8)


def plot_curves(
    path: str,
    curves: Sequence[Tuple[str, np.ndarray]],
    reference: Optional[np.ndarray] = None,
    title: str = "curves",
) -> str:
    """Small multi-curve plot with an optional dashed reference curve --
    the sidebar MiniCurvePlot analog (src/minicurveplot.{h,cpp}; the sidebar
    shows resampling/dispersion/window curves against references,
    docs/docs/functionality.md:55-63)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3), constrained_layout=True)
    if reference is not None:
        ref = np.asarray(reference, np.float64)
        ax.plot(np.arange(ref.size), ref, color=_GRID, linewidth=1.2,
                linestyle="--", label="reference")
    for i, (name, data) in enumerate(curves):
        data = np.asarray(data, np.float64)
        ax.plot(np.arange(data.size), data,
                color=SERIES_COLORS[i % len(SERIES_COLORS)], linewidth=1.4,
                label=name)
    _style_axis(ax, title)
    if len(curves) + (reference is not None) > 1:
        ax.legend(loc="best", fontsize=8, frameon=False, labelcolor=_TEXT)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_lines(
    path: str,
    raw_line: Optional[np.ndarray] = None,
    processed_line: Optional[np.ndarray] = None,
    overlays: Sequence[Tuple[str, np.ndarray]] = (),
    title: str = "octproz_tpu 1D plot",
    show_stats: bool = True,
    autoscale: bool = True,
) -> str:
    """Render the raw-spectrum / processed-A-scan panel(s) to a PNG.

    Raw and processed traces live on separate panels (different units --
    never a dual axis); overlays share the processed panel.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = []
    if raw_line is not None:
        panels.append(("Raw spectrum", [("raw", np.asarray(raw_line), SERIES_COLORS[0])]))
    if processed_line is not None:
        series = [("processed", np.asarray(processed_line), SERIES_COLORS[1])]
        for idx, (name, data) in enumerate(overlays):
            series.append((name, np.asarray(data),
                           SERIES_COLORS[(2 + idx) % len(SERIES_COLORS)]))
        panels.append(("Processed A-scan", series))
    if not panels:
        raise ValueError("nothing to plot")

    fig, axes = plt.subplots(len(panels), 1, figsize=(8, 2.6 * len(panels)),
                             squeeze=False, constrained_layout=True)
    fig.suptitle(title, color=_TEXT, fontsize=11)
    for ax_row, (panel_title, series) in zip(axes, panels):
        ax = ax_row[0]
        for name, data, color in series:
            ax.plot(np.arange(data.size), data.astype(np.float64), color=color,
                    linewidth=1.4, label=name)
        if show_stats:
            stats = LineStats.of(series[0][1])
            panel_title = f"{panel_title}   [{stats.label()}]"
        _style_axis(ax, panel_title)
        if len(series) > 1:
            ax.legend(loc="upper right", fontsize=8, frameon=False,
                      labelcolor=_TEXT)
        if not autoscale:
            ax.set_ylim(0.0, 1.0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
