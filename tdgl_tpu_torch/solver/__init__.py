from .options import SolverOptions, SolverOptionsError, SparseSolver
from .solve import solve
from .solver import TDGLSolver
