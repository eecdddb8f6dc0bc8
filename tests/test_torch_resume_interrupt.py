"""``KeyboardInterrupt`` handling in the Runner (``tests/test_interrupt.py``):
cancel with partial, loadable data, pause and continue, decline, and a
cancel during thermalization, on both backends.

The fixtures and helpers are in ``tests/test_torch_resume.py``.
"""

import numpy as np

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.solver.solver import TDGLSolver

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_resume import (BACKENDS, _options, devices, one_blas_thread,
                               one_hierarchy_per_mesh)


# -- KeyboardInterrupt handling (tests/test_interrupt.py) ---------------------
def _interrupting_solver(device, options, interrupt_at):
    """A solver whose chunk_fn raises KeyboardInterrupt once, before the
    ``interrupt_at``-th chunk call (1-based): where a real Ctrl-C lands,
    inside the Runner's per-chunk try block."""
    solver = TDGLSolver(device, options,
                        applied_vector_potential=ttdgl.ConstantField(
                            100, field_units="uT"),
                        torch_device="cpu")
    orig = solver.chunk_fn
    calls = {"n": 0}

    def chunk_fn(state):
        calls["n"] += 1
        if calls["n"] == interrupt_at:
            raise KeyboardInterrupt
        return orig(state)

    solver.chunk_fn = chunk_fn
    return solver, calls


def _interrupt_options(solve_time, path, **kwargs):
    return _options(solve_time, path, dtype="float32", save_every=20,
                    steps_per_chunk=20, field_units="uT", **kwargs)


@BACKENDS
def test_interrupt_cancel_returns_partial_data(devices, structured,
                                                tmp_path):
    """Cancelling mid-simulation still returns a Solution holding the data
    generated so far, backed by a valid, loadable output file."""
    options = _interrupt_options(50, tmp_path / "cancel.h5",
                                 pause_on_interrupt=False)
    solver, calls = _interrupting_solver(devices[structured], options, 4)
    solution = solver.solve()
    assert solution is not None
    assert calls["n"] == 4
    times = solution.times
    assert times is not None and len(times) >= 1
    assert float(times[-1]) < 50.0
    reloaded = ttdgl.Solution.from_hdf5(solution.path)
    assert reloaded.equals(solution)
    assert np.isfinite(np.abs(reloaded.tdgl_data.psi)).all()


@BACKENDS
def test_interrupt_pause_resume_continues(devices, structured, tmp_path,
                                          monkeypatch):
    """With pause_on_interrupt, answering 'y' resumes the run and it
    completes to solve_time as if never interrupted."""
    prompts = []

    def fake_input(prompt=""):
        prompts.append(prompt)
        return "y"

    monkeypatch.setattr("builtins.input", fake_input)
    options = _interrupt_options(0.3, tmp_path / "pause.h5",
                                 pause_on_interrupt=True)
    solver, _ = _interrupting_solver(devices[structured], options, 2)
    solution = solver.solve()
    assert solution is not None
    assert len(prompts) == 1 and "paused" in prompts[0]
    assert float(solution.times[-1]) >= 0.3 - 1e-6


def test_interrupt_pause_then_decline_cancels(devices, tmp_path,
                                              monkeypatch):
    """Answering anything but 'y' at the pause prompt cancels, with
    partial data."""
    monkeypatch.setattr("builtins.input", lambda prompt="": "n")
    options = _interrupt_options(50, tmp_path / "decline.h5",
                                 pause_on_interrupt=True)
    solver, _ = _interrupting_solver(devices[True], options, 3)
    solution = solver.solve()
    assert solution is not None
    assert float(solution.times[-1]) < 50.0


def test_interrupt_during_thermalization_returns_none(devices, tmp_path):
    """A cancel during the thermalization stage aborts the run with no
    data (the reference returns None)."""
    options = _interrupt_options(50, tmp_path / "therm.h5", skip_time=50,
                                 pause_on_interrupt=False)
    solver, _ = _interrupting_solver(devices[True], options, 2)
    assert solver.solve() is None
