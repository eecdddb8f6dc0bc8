from .options import SolverOptions, SolverOptionsError, SparseSolver
from .solver import TDGLSolver
