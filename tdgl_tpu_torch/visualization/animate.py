"""Render saved frames to an animation (gif/mp4) (the counterpart of
:mod:`tdgl_tpu.visualization.animate`).

API parity with the reference ``tdgl/visualization/animate.py:19``; the
file is read through h5lite, and the progress bar is tqdm's where tqdm is
installed (:func:`~tdgl_tpu_torch.solution.data.progress`).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Union

import numpy as np

from ..solution.data import get_data_range, progress
from ..utils import h5lite
from .common import DEFAULT_QUANTITIES, PLOT_DEFAULTS, Quantity, auto_grid
from .io import get_plot_data, get_state_string, load_mesh, open_h5

logger = logging.getLogger(__name__)


def create_animation(
    input_file: Union[str, h5lite.Group],
    *,
    output_file: Optional[str] = None,
    quantities: Union[Sequence[str], str] = DEFAULT_QUANTITIES,
    shading: str = "gouraud",
    fps: int = 30,
    dpi: float = 100,
    max_cols: int = 4,
    min_frame: int = 0,
    max_frame: int = -1,
    autoscale: bool = False,
    dimensionless: bool = False,
    axis_labels: bool = False,
    axes_off: bool = False,
    title_off: bool = False,
    full_title: bool = True,
    figure_kwargs: Optional[dict] = None,
    writer=None,
    silent: bool = False,
):
    """Create a matplotlib FuncAnimation over the saved frames.

    Returns the animation object; saves it to ``output_file`` if given.
    """
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    from .common import non_gui_backend

    if isinstance(quantities, str):
        quantities = [quantities]
    quantities = [Quantity.from_key(str(q)) for q in quantities]

    with open_h5(input_file) as f:
        mesh = load_mesh(f)
        data_min, data_max = get_data_range(f)
        if max_frame < 0:
            max_frame = data_max + 1 + max_frame
        frames = list(range(max(min_frame, data_min), max_frame + 1))
        x, y = mesh.sites.T
        if not dimensionless and "solution/device" in f:
            xi = f["solution/device/layer"].attrs["coherence_length"]
            x, y = x * xi, y * xi

        with non_gui_backend():
            fig, axes = auto_grid(len(quantities), max_cols=max_cols,
                                  **(figure_kwargs or {}))
            collections = []
            for quantity, ax in zip(quantities, np.asarray(axes).flat):
                value, _, limits = get_plot_data(f, mesh, quantity, frames[0])
                defaults = PLOT_DEFAULTS[quantity]
                pc = ax.tripcolor(x, y, value, triangles=mesh.elements,
                                  shading=shading, cmap=defaults.cmap)
                pc.set_clim(*limits)
                cbar = fig.colorbar(pc, ax=ax)
                cbar.set_label(defaults.clabel)
                ax.set_aspect("equal")
                ax.set_title(quantity.value)
                if axis_labels:
                    ax.set_xlabel(defaults.xlabel)
                    ax.set_ylabel(defaults.ylabel)
                if axes_off:
                    ax.axis("off")
                collections.append(pc)
            suptitle = None
            if not title_off:
                suptitle = fig.suptitle(
                    get_state_string(f, frames[0], frames[-1])
                )

            bar = progress(range(len(frames)), "Rendering frames",
                           not silent)
            ticks = iter(bar)

            def update(frame):
                for quantity, pc in zip(quantities, collections):
                    value, _, limits = get_plot_data(f, mesh, quantity, frame)
                    pc.set_array(value)
                    if autoscale:
                        pc.set_clim(float(np.nanmin(value)),
                                    float(np.nanmax(value)))
                    else:
                        pc.set_clim(*limits)
                if suptitle is not None:
                    text = get_state_string(f, frame, frames[-1])
                    if not full_title:
                        text = text.split(",")[0]
                    suptitle.set_text(text)
                next(ticks, None)
                return collections

            anim = FuncAnimation(fig, update, frames=frames, blit=False,
                                 interval=1000 / fps)
            if output_file is not None:
                kwargs = dict(fps=fps, dpi=dpi)
                if writer is not None:
                    kwargs["writer"] = writer
                anim.save(output_file, **kwargs)
                plt.close(fig)
            getattr(bar, "close", lambda: None)()
            return anim
