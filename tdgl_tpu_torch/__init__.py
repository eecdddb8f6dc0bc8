"""tdgl_tpu_torch: the PyTorch/CUDA port of tdgl_tpu.

Time-dependent Ginzburg-Landau simulation of thin-film superconductors on
an NVIDIA GPU. The JAX package ``tdgl_tpu`` is the reference; this package
keeps its module paths and names. It covers both solver backends, the
unstructured (ELL) one of the default Delaunay mesh and the structured
(hex-lattice) one, with screening and with static, traced or
host-evaluated time-dependent inputs: build a :class:`Device`, mesh it
with ``make_mesh()`` (or ``make_mesh(structured=True)``) and call
``solve(device, options, ...)``,
which runs on the card (``torch_device="cuda"``, the default) or on the
CPU (``torch_device="cpu"``), writes the standard HDF5 output file and
returns a :class:`Solution`. :func:`parallel.solve_sweep` runs a
field or current sweep as one batch of runs on the same device. The
``plot_*`` functions, :mod:`.visualization` and the ``python -m
tdgl_tpu_torch.visualize`` CLI draw and convert output files (matplotlib
is imported when they draw), and ``SolverOptions(monitor=True)`` shows a
running solve live.
"""

from .about import version_dict, version_table
from .device.device import Device
from .device.layer import Layer
from .device.meshing import generate_mesh
from .device.polygon import Polygon
from .geometry import box, circle, close_curve, ellipse, path_vectors, rotate
from .em import convert_field
from .fluxoid import Fluxoid, make_fluxoid_polygons
from .parameter import CompositeParameter, Constant, Parameter
from .solution.data import DynamicsData, TDGLData, get_current_through_paths
from .solution.plot_solution import (
    plot_current_through_paths,
    plot_currents,
    plot_field_at_positions,
    plot_order_parameter,
    plot_scalar_potential,
    plot_vorticity,
)
from .solution.solution import BiotSavartField, BoundaryPhases, Solution
from .solver.options import SolverOptions, SolverOptionsError, SparseSolver
from .solver.solve import solve
from .solver.solver import SolverResult, TDGLSolver, jittable
from .sources import ConstantField, CurrentLoop, LinearRamp, Scale
from .utils.units import Quantity, UnitRegistry, ureg
from .version import __git_revision__, __version__, __version_info__
from .visualization.common import non_gui_backend
from . import em, fluxoid, geometry, parallel, sources, visualization
