"""tdgl_tpu_torch: the PyTorch/CUDA port of tdgl_tpu.

Time-dependent Ginzburg-Landau simulation of thin-film superconductors on
an NVIDIA GPU. The JAX package ``tdgl_tpu`` is the reference; this package
keeps its module paths and names. It covers the structured (hex-lattice)
solver path, with screening and with static, traced or host-evaluated
time-dependent inputs: build a :class:`Device`, mesh it with
``make_mesh(structured=True)`` and call ``solve(device, options, ...)``,
which runs on the card (``torch_device="cuda"``, the default) or on the
CPU (``torch_device="cpu"``), writes the standard HDF5 output file and
returns a :class:`Solution`.
"""

from .about import version_dict
from .device.device import Device
from .device.layer import Layer
from .device.polygon import Polygon
from .geometry import box, circle, close_curve, ellipse, path_vectors, rotate
from .em import convert_field
from .fluxoid import Fluxoid, make_fluxoid_polygons
from .parameter import CompositeParameter, Constant, Parameter
from .solution.data import DynamicsData, TDGLData, get_current_through_paths
from .solution.solution import BiotSavartField, BoundaryPhases, Solution
from .solver.options import SolverOptions, SolverOptionsError, SparseSolver
from .solver.solve import solve
from .solver.solver import TDGLSolver, jittable
from .sources import ConstantField, CurrentLoop, LinearRamp, Scale
from .utils.units import Quantity, UnitRegistry, ureg
from .version import __version__, __version_info__
from . import sources
