"""tdgl_tpu_torch: the PyTorch/CUDA port of tdgl_tpu.

Time-dependent Ginzburg-Landau simulation of thin-film superconductors on
an NVIDIA GPU. The JAX package ``tdgl_tpu`` is the reference; this package
keeps its module paths and names. It covers the structured (hex-lattice),
unscreened, static-input solver path: build a :class:`Device`, mesh it with
``make_mesh(structured=True)``, construct ``TDGLSolver(device, options,
..., torch_device="cuda")`` and advance ``solver.chunk_fn(state)`` from
``solver._initial_state()``.
"""

from .device.device import Device
from .device.layer import Layer
from .device.polygon import Polygon
from .geometry import box, circle, close_curve, ellipse, path_vectors, rotate
from .parameter import CompositeParameter, Constant, Parameter
from .solver.options import SolverOptions, SolverOptionsError, SparseSolver
from .solver.solver import TDGLSolver
from .sources import ConstantField
from .utils.units import Quantity, UnitRegistry, ureg
