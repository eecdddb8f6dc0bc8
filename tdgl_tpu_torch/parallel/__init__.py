"""Batched parameter sweeps (:func:`solve_sweep`, whose members may split
over a list of devices) and single-problem row sharding of a structured
solve (:func:`shard_solver_spatially`, :func:`spatial_device_mesh`,
:func:`spatial_spec`)."""

from .spatial import (shard_solver_spatially, spatial_device_mesh,
                      spatial_spec)
from .sweep import SweepResult, solve_sweep

__all__ = ["SweepResult", "solve_sweep", "shard_solver_spatially",
           "spatial_device_mesh", "spatial_spec"]
