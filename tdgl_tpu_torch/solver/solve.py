"""One-call solve facade (the counterpart of :mod:`tdgl_tpu.solver.solve`,
reference ``tdgl/solver/solve.py:9``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from ..device.device import Device
from .options import SolverOptions
from .solver import TDGLSolver


def solve(
    device: Device,
    options: SolverOptions,
    applied_vector_potential: Union[Callable, float] = 0.0,
    terminal_currents: Union[Callable, Dict[str, float], None] = None,
    disorder_epsilon: Union[Callable, float] = 1.0,
    seed_solution=None,
    resume_from: Optional[str] = None,
    *,
    torch_device: Union[str, torch.device] = "cuda",
):
    """Solve a TDGL model on the card (or, with ``torch_device="cpu"``, on
    the CPU).

    Args:
        device: The meshed :class:`tdgl_tpu_torch.Device`
            (``make_mesh(structured=True)``).
        options: Solver options.
        applied_vector_potential: Uniform field strength (float, in
            ``options.field_units``) or a Parameter/callable of position
            (and time).
        terminal_currents: ``{terminal_name: current}`` (in
            ``options.current_units``) or a callable of time
            (:func:`~tdgl_tpu_torch.jittable` for the traced path).
        disorder_epsilon: The local critical-temperature parameter
            epsilon(r[, t]) <= 1.
        seed_solution: Not ported yet (must be None).
        resume_from: Not ported yet (must be None).
        torch_device: ``"cuda"`` (default; raises where CUDA is not
            available) or ``"cpu"``.

    Returns:
        A :class:`tdgl_tpu_torch.Solution` (or None if cancelled during
        thermalization). Its file opens with ``tdgl_tpu.Solution.from_hdf5``
        and with h5py.
    """
    solver = TDGLSolver(
        device,
        options,
        applied_vector_potential=applied_vector_potential,
        terminal_currents=terminal_currents,
        disorder_epsilon=disorder_epsilon,
        seed_solution=seed_solution,
        torch_device=torch_device,
    )
    return solver.solve(resume_from=resume_from)
