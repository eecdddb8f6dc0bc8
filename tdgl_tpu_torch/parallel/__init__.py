"""Batched parameter sweeps (:func:`solve_sweep`), one batch on one device.

The JAX package's spatial sharding across devices (``shard_solver_spatially``,
``spatial_device_mesh``, ``spatial_spec``) is not ported.
"""

from .sweep import SweepResult, solve_sweep

__all__ = ["SweepResult", "solve_sweep"]
