"""Static figures at requested simulation times (the counterpart of
:mod:`tdgl_tpu.visualization.snapshot`).

API parity with the reference ``tdgl/visualization/snapshot.py:14``; the
file is read through h5lite.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..solution.data import get_data_range
from .common import DEFAULT_QUANTITIES, PLOT_DEFAULTS, Quantity, auto_grid
from .io import get_plot_data, get_state_string, load_mesh, open_h5


def generate_snapshots(
    input_file: str,
    times: Union[float, Sequence[float]],
    quantities: Union[str, Sequence[str]] = DEFAULT_QUANTITIES,
    shading: str = "gouraud",
    max_cols: int = 4,
    dimensionless: bool = False,
    axis_labels: bool = False,
    axes_off: bool = False,
    title_off: bool = False,
    figure_kwargs: Optional[dict] = None,
):
    """One figure per requested time (nearest saved step).

    ``input_file`` is a path or an open h5lite file. Returns a list of
    ``(fig, axes)`` pairs.
    """
    if np.isscalar(times):
        times = [times]
    if isinstance(quantities, str):
        quantities = [quantities]
    quantities = [Quantity.from_key(str(q)) for q in quantities]
    figures = []
    with open_h5(input_file) as f:
        mesh = load_mesh(f)
        step_min, step_max = get_data_range(f)
        frame_times = np.array([
            f[f"data/{i}"].attrs.get("time", np.nan)
            for i in range(step_min, step_max + 1)
        ])
        x, y = mesh.sites.T
        if not dimensionless and "solution/device" in f:
            xi = f["solution/device/layer"].attrs["coherence_length"]
            x, y = x * xi, y * xi
        for time in times:
            frame = step_min + int(np.nanargmin(np.abs(frame_times - time)))
            fig, axes = auto_grid(len(quantities), max_cols=max_cols,
                                  **(figure_kwargs or {}))
            for quantity, ax in zip(quantities, np.asarray(axes).flat):
                value, _, limits = get_plot_data(f, mesh, quantity, frame)
                defaults = PLOT_DEFAULTS[quantity]
                pc = ax.tripcolor(x, y, value, triangles=mesh.elements,
                                  shading=shading, cmap=defaults.cmap)
                pc.set_clim(*limits)
                cbar = fig.get_figure().colorbar(pc, ax=ax)
                cbar.set_label(defaults.clabel)
                ax.set_aspect("equal")
                ax.set_title(quantity.value)
                if axis_labels:
                    ax.set_xlabel(defaults.xlabel)
                    ax.set_ylabel(defaults.ylabel)
                if axes_off:
                    ax.axis("off")
            if not title_off:
                fig.suptitle(get_state_string(f, frame, step_max))
            figures.append((fig, axes))
    return figures
