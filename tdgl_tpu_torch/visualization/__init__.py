"""Plots, animations, the live monitor and XDMF export of output files
(the counterpart of :mod:`tdgl_tpu.visualization`).

Host-side numpy and matplotlib; matplotlib is imported when a function
that draws is called. Files are read through
:mod:`tdgl_tpu_torch.utils.h5lite`, so either package's output files and
the solver's ``.h5.tmp`` side file load without h5py.
"""

from .animate import create_animation
from .common import (
    DEFAULT_QUANTITIES,
    PLOT_DEFAULTS,
    Quantity,
    auto_grid,
    auto_range_iqr,
    non_gui_backend,
)
from .convert import convert_to_xdmf
from .interactive import InteractivePlot, MultiInteractivePlot
from .io import get_plot_data, get_state_string
from .monitor import monitor_solution
from .snapshot import generate_snapshots

__all__ = [
    "DEFAULT_QUANTITIES",
    "PLOT_DEFAULTS",
    "InteractivePlot",
    "MultiInteractivePlot",
    "Quantity",
    "auto_grid",
    "auto_range_iqr",
    "convert_to_xdmf",
    "create_animation",
    "generate_snapshots",
    "get_plot_data",
    "get_state_string",
    "monitor_solution",
    "non_gui_backend",
]
