"""Keyboard-driven interactive browsers for solution files (the
counterpart of :mod:`tdgl_tpu.visualization.interactive`).

API parity with the reference ``tdgl/visualization/interactive.py:14-286``:
arrow keys step frames (+shift/ctrl for bigger jumps), number keys select the
displayed quantity. The file is read through h5lite.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from ..solution.data import get_data_range
from ..utils import h5lite
from .common import DEFAULT_QUANTITIES, PLOT_DEFAULTS, Quantity, auto_grid
from .io import get_plot_data, get_state_string, load_mesh

logger = logging.getLogger(__name__)


class _FrameCounter:
    def __init__(self, min_frame: int, max_frame: int):
        self.current = min_frame
        self.min_frame = min_frame
        self.max_frame = max_frame

    def jump(self, delta: int) -> None:
        self.current = int(
            np.clip(self.current + delta, self.min_frame, self.max_frame)
        )


# Frame jumps: reference parity (``tdgl/visualization/interactive.py:51-78``)
# — arrows step +-1/+-10 (shift), up/down +-100, shift+up/down +-1000,
# home/end jump to the first/last frame.
_KEY_JUMPS = {
    "right": 1, "left": -1,
    "shift+right": 10, "shift+left": -10,
    "up": 100, "down": -100,
    "shift+up": 1000, "shift+down": -1000,
}

# Number keys select the quantity: reference parity
# (``tdgl/visualization/interactive.py:80-106``).
_KEY_QUANTITIES = {
    "1": Quantity.ORDER_PARAMETER,
    "2": Quantity.PHASE,
    "3": Quantity.SUPERCURRENT,
    "4": Quantity.NORMAL_CURRENT,
    "5": Quantity.SCALAR_POTENTIAL,
    "6": Quantity.APPLIED_VECTOR_POTENTIAL,
    "7": Quantity.INDUCED_VECTOR_POTENTIAL,
    "8": Quantity.EPSILON,
    "9": Quantity.VORTICITY,
}


class InteractivePlot:
    """Browse a single quantity through the saved frames of a solution file."""

    def __init__(self, input_file: str, shading: str = "gouraud",
                 dimensionless: bool = False, figure_kwargs: Optional[dict] = None):
        self.input_file = input_file
        self.shading = shading
        self.dimensionless = dimensionless
        self.figure_kwargs = figure_kwargs or {}
        self.quantity = Quantity.ORDER_PARAMETER

    def _build(self, f):
        """Build the figure and wire the key handler against the open file.

        Split from :meth:`show` so tests can drive the handler with
        synthetic ``KeyEvent``s while the file is still open. Exposes
        ``self._frames`` (the frame counter), ``self._fig``, and
        ``self._on_key`` for that purpose.
        """
        import matplotlib.pyplot as plt

        mesh = load_mesh(f)
        min_frame, max_frame = get_data_range(f)
        frames = _FrameCounter(min_frame, max_frame)
        fig, ax = plt.subplots(**self.figure_kwargs)
        x, y = mesh.sites.T
        if not self.dimensionless and "solution/device" in f:
            xi = f["solution/device/layer"].attrs["coherence_length"]
            x, y = x * xi, y * xi
        value, _, limits = get_plot_data(f, mesh, self.quantity,
                                         frames.current)
        defaults = PLOT_DEFAULTS[self.quantity]
        pc = ax.tripcolor(x, y, value, triangles=mesh.elements,
                          shading=self.shading, cmap=defaults.cmap)
        pc.set_clim(*limits)
        cbar = fig.colorbar(pc, ax=ax)
        cbar.set_label(defaults.clabel)
        ax.set_aspect("equal")
        title = ax.set_title(
            get_state_string(f, frames.current, max_frame)
        )

        def redraw():
            value, _, limits = get_plot_data(f, mesh, self.quantity,
                                             frames.current)
            defaults = PLOT_DEFAULTS[self.quantity]
            pc.set_array(value)
            pc.set_cmap(defaults.cmap)
            pc.set_clim(*limits)
            cbar.set_label(defaults.clabel)
            title.set_text(get_state_string(f, frames.current, max_frame))
            fig.canvas.draw_idle()

        def on_key(event):
            if event.key in _KEY_JUMPS:
                frames.jump(_KEY_JUMPS[event.key])
                redraw()
            elif event.key == "home":
                frames.jump(frames.min_frame - frames.current)
                redraw()
            elif event.key == "end":
                frames.jump(frames.max_frame - frames.current)
                redraw()
            elif event.key in _KEY_QUANTITIES:
                self.quantity = _KEY_QUANTITIES[event.key]
                redraw()

        fig.canvas.mpl_connect("key_press_event", on_key)
        self._frames = frames
        self._fig = fig
        self._pc = pc
        self._on_key = on_key
        return fig

    def show(self):
        import matplotlib.pyplot as plt

        with h5lite.File(self.input_file, "r") as f:
            self._build(f)
            plt.show()


class MultiInteractivePlot:
    """Browse several quantities side by side through the saved frames."""

    def __init__(self, input_file: str,
                 quantities: Optional[Sequence[str]] = None,
                 shading: str = "gouraud", dimensionless: bool = False,
                 max_cols: int = 4, figure_kwargs: Optional[dict] = None):
        self.input_file = input_file
        if quantities is None:
            quantities = DEFAULT_QUANTITIES
        self.quantities = [Quantity.from_key(str(q)) for q in quantities]
        self.shading = shading
        self.dimensionless = dimensionless
        self.max_cols = max_cols
        self.figure_kwargs = figure_kwargs or {}

    def _build(self, f):
        """See :meth:`InteractivePlot._build` — test-drivable setup."""
        mesh = load_mesh(f)
        min_frame, max_frame = get_data_range(f)
        frames = _FrameCounter(min_frame, max_frame)
        x, y = mesh.sites.T
        fig, axes = auto_grid(len(self.quantities),
                              max_cols=self.max_cols,
                              **self.figure_kwargs)
        collections = []
        for quantity, ax in zip(self.quantities, axes.flat):
            value, _, limits = get_plot_data(f, mesh, quantity,
                                             frames.current)
            defaults = PLOT_DEFAULTS[quantity]
            pc = ax.tripcolor(x, y, value, triangles=mesh.elements,
                              shading=self.shading, cmap=defaults.cmap)
            pc.set_clim(*limits)
            cbar = fig.colorbar(pc, ax=ax)
            cbar.set_label(defaults.clabel)
            ax.set_aspect("equal")
            ax.set_title(quantity.value)
            collections.append(pc)
        suptitle = fig.suptitle(
            get_state_string(f, frames.current, max_frame)
        )

        def redraw():
            for quantity, pc in zip(self.quantities, collections):
                value, _, limits = get_plot_data(f, mesh, quantity,
                                                 frames.current)
                pc.set_array(value)
                pc.set_clim(*limits)
            suptitle.set_text(
                get_state_string(f, frames.current, max_frame)
            )
            fig.canvas.draw_idle()

        def on_key(event):
            if event.key in _KEY_JUMPS:
                frames.jump(_KEY_JUMPS[event.key])
                redraw()
            elif event.key == "home":
                frames.jump(frames.min_frame - frames.current)
                redraw()
            elif event.key == "end":
                frames.jump(frames.max_frame - frames.current)
                redraw()

        fig.canvas.mpl_connect("key_press_event", on_key)
        self._frames = frames
        self._fig = fig
        self._collections = collections
        self._on_key = on_key
        return fig

    def show(self):
        import matplotlib.pyplot as plt

        with h5lite.File(self.input_file, "r") as f:
            self._build(f)
            plt.show()
