"""Live monitoring of a running simulation through its ``.tmp`` side file
(the counterpart of :mod:`tdgl_tpu.visualization.monitor`).

API parity with the reference ``tdgl/visualization/monitor.py:14-166``:
the solver writes each snapshot into ``<output>.h5.tmp`` under
``data/-1``; this module polls that file and redraws. The JAX package
keeps the file open under h5py's SWMR mode and refreshes it; here the
file is re-opened through h5lite at every poll (the solver overwrites it
in place, :mod:`tdgl_tpu_torch.solver.runner`). A read that meets the
writer mid-flush raises ``OSError`` and is retried at the next poll; the
arrays are read before ``step``, so a drawing that mixes two snapshots is
redrawn at the next poll.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence, Union

import numpy as np

from ..utils import h5lite
from .common import DEFAULT_QUANTITIES, PLOT_DEFAULTS, Quantity, auto_grid
from .io import get_plot_data

logger = logging.getLogger(__name__)


def read_latest(h5path: str, mesh, quantities: Sequence[Quantity]):
    """``(step, time, dt, [get_plot_data(...) per quantity])`` of the
    side file's latest snapshot, read in one opening of the file."""
    with h5lite.File(h5path, "r") as f:
        values = [get_plot_data(f, mesh, q, -1) for q in quantities]
        grp = f["data/-1"]
        step = int(np.asarray(grp["step"])[0])
        t = float(np.asarray(grp["time"])[0])
        dt = float(np.asarray(grp["dt"])[0])
    return step, t, dt, values


def monitor_solution(
    h5path: str,
    update_interval: float = 1.0,
    quantities: Union[str, Sequence[str], None] = None,
    shading: str = "gouraud",
    dimensionless: bool = False,
    max_cols: int = 4,
    figure_kwargs: Optional[dict] = None,
):
    """Poll a live ``.tmp`` output file and plot the latest state until the
    file disappears (solver finished) or the window is closed."""
    import matplotlib.pyplot as plt

    from ..device.device import Device

    if quantities is None:
        quantities = DEFAULT_QUANTITIES
    if isinstance(quantities, str):
        quantities = [quantities]
    quantities = [Quantity.from_key(str(q)) for q in quantities]

    # Wait for the file to hold the device (the solver writes it before
    # the first step).
    deadline = time.time() + 60
    while True:
        try:
            with h5lite.File(h5path, "r") as f:
                device = Device.from_hdf5(f["solution/device"])
            break
        except (KeyError, OSError) as exc:
            if time.time() > deadline:
                raise FileNotFoundError(
                    f"{h5path} did not hold a device within 60 s: {exc}"
                ) from exc
            time.sleep(0.25)

    mesh = device.mesh
    x, y = mesh.sites.T
    if not dimensionless:
        xi = device.layer.coherence_length
        x, y = x * xi, y * xi
    plt.ion()
    fig, axes = auto_grid(len(quantities), max_cols=max_cols,
                          **(figure_kwargs or {}))
    n = len(mesh.sites)
    collections = []
    for quantity, ax in zip(quantities, np.asarray(axes).flat):
        defaults = PLOT_DEFAULTS[quantity]
        pc = ax.tripcolor(x, y, np.zeros(n), triangles=mesh.elements,
                          shading=shading, cmap=defaults.cmap)
        cbar = fig.colorbar(pc, ax=ax)
        cbar.set_label(defaults.clabel)
        ax.set_aspect("equal")
        ax.set_title(quantity.value)
        collections.append(pc)
    suptitle = fig.suptitle("")
    while os.path.exists(h5path) and plt.fignum_exists(fig.number):
        try:
            step, t, dt, values = read_latest(h5path, mesh, quantities)
        except (KeyError, OSError, ValueError) as exc:
            logger.debug("Monitor read failed: %s", exc)
        else:
            for (value, _, limits), pc in zip(values, collections):
                pc.set_array(value)
                pc.set_clim(*limits)
            suptitle.set_text(f"Step {step}, time {t:.2f}, dt {dt:.2e}")
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
        plt.pause(update_interval)
    plt.ioff()
    return fig
