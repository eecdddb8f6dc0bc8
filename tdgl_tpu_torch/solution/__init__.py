from .data import DynamicsData, TDGLData, get_current_through_paths
from .solution import BiotSavartField, BoundaryPhases, Solution

__all__ = [
    "BiotSavartField",
    "BoundaryPhases",
    "DynamicsData",
    "Solution",
    "TDGLData",
    "get_current_through_paths",
]
