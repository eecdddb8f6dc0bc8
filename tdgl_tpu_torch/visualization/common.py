"""Plottable-quantity registry and plotting helpers (the counterpart of
:mod:`tdgl_tpu.visualization.common`).

API parity with the reference ``tdgl/visualization/common.py:12-186``.
matplotlib is imported inside the functions that use it.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Sequence, Tuple, Union

import numpy as np


class Quantity(Enum):
    """The nine plottable quantities of a TDGL solution."""

    ORDER_PARAMETER = "Order parameter"
    PHASE = "Phase"
    SUPERCURRENT = "Supercurrent density"
    NORMAL_CURRENT = "Normal current density"
    VORTICITY = "Vorticity"
    SCALAR_POTENTIAL = "Scalar potential"
    APPLIED_VECTOR_POTENTIAL = "Applied vector potential"
    INDUCED_VECTOR_POTENTIAL = "Induced vector potential"
    EPSILON = "Epsilon"

    @classmethod
    def get_keys(cls) -> Sequence[str]:
        return [item.name for item in cls]

    @classmethod
    def from_key(cls, key: str) -> "Quantity":
        return cls[key.upper()]


@dataclass
class PlotDefault:
    cmap: str
    clabel: str
    xlabel: str = "$x/\\xi$"
    ylabel: str = "$y/\\xi$"
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    symmetric: bool = False


PLOT_DEFAULTS = {
    Quantity.ORDER_PARAMETER: PlotDefault(cmap="viridis", clabel="$|\\psi|$",
                                          vmin=0, vmax=1),
    Quantity.PHASE: PlotDefault(cmap="twilight_shifted",
                                clabel="$\\arg(\\psi)/\\pi$", vmin=-1, vmax=1),
    Quantity.SUPERCURRENT: PlotDefault(cmap="inferno",
                                       clabel="$|\\vec{{J}}_s|/J_0$"),
    Quantity.NORMAL_CURRENT: PlotDefault(cmap="inferno",
                                         clabel="$|\\vec{{J}}_n|/J_0$"),
    Quantity.SCALAR_POTENTIAL: PlotDefault(cmap="magma", clabel="$\\mu/v_0$"),
    Quantity.APPLIED_VECTOR_POTENTIAL: PlotDefault(
        cmap="cividis", clabel="$a_\\mathrm{{applied}}/(\\xi B_{{c2}})$"),
    Quantity.INDUCED_VECTOR_POTENTIAL: PlotDefault(
        cmap="cividis", clabel="$a_\\mathrm{{induced}}/(\\xi B_{{c2}})$"),
    Quantity.EPSILON: PlotDefault(cmap="viridis", clabel="$\\epsilon$",
                                  vmin=-1, vmax=1),
    Quantity.VORTICITY: PlotDefault(
        cmap="coolwarm",
        clabel="$(\\vec{{\\nabla}}\\times\\vec{{J}})\\cdot\\hat{{z}}$",
        symmetric=True),
}

DEFAULT_QUANTITIES = (
    "order_parameter",
    "phase",
    "supercurrent",
    "normal_current",
)


def auto_grid(num_plots: int, max_cols: int = 3, delaxes: bool = True,
              **kwargs):
    """A figure with >= num_plots subplots arranged in at most max_cols
    columns."""
    import matplotlib.pyplot as plt

    ncols = min(max_cols, num_plots)
    nrows = int(np.ceil(num_plots / ncols))
    fig, axes = plt.subplots(nrows, ncols, **kwargs)
    if not isinstance(axes, (list, np.ndarray)):
        axes = np.array([axes])
    axes = np.asarray(axes)
    if delaxes:
        for ax in list(axes.flat)[num_plots:]:
            fig.delaxes(ax)
    return fig, axes


@contextmanager
def non_gui_backend():
    """Temporarily switch matplotlib to the Agg backend."""
    import matplotlib as mpl

    with warnings.catch_warnings():
        for msg in ("Matplotlib is currently using agg",
                    "FigureCanvasAgg is non-interactive"):
            warnings.filterwarnings("ignore", category=UserWarning,
                                    message=msg)
        old_backend = mpl.get_backend()
        try:
            mpl.use("Agg")
            yield
        finally:
            mpl.use(old_backend)


def auto_range_iqr(
    data_array: np.ndarray,
    cutoff_percentile: Union[float, Tuple[float, float]] = 1,
) -> Tuple[float, float]:
    """Outlier-excluding (vmin, vmax) via the interquartile-range rule."""
    if isinstance(cutoff_percentile, tuple):
        bottom, top = cutoff_percentile
    else:
        bottom, top = cutoff_percentile, 100 - cutoff_percentile
    z = np.asarray(data_array).flatten()
    zmin, zmax = np.nanmin(z), np.nanmax(z)
    zrange = zmax - zmin
    pmin, q3, q1, pmax = np.nanpercentile(z, [bottom, 75, 25, top])
    iqr = q3 - q1
    if zrange == 0.0 or iqr / zrange < 1e-8:
        return float(zmin), float(zmax)
    vmin = min(max(q1 - 1.5 * iqr, zmin), pmin)
    vmax = max(min(q3 + 1.5 * iqr, zmax), pmax)
    return float(vmin), float(vmax)
