"""Resume and seed cases beside the exact resume: ``skip_time`` ignored on
resume, a seed of another device, a SIGKILLed solver process, a
screened run with a traced applied potential, and the factored-link
repair of a masked ``A_applied``.

The fixtures and helpers are in ``tests/test_torch_resume.py``.
"""

import logging
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.solver.solver import TDGLSolver
from tdgl_tpu_torch.utils import h5lite

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_resume import (_options, _solve, devices, one_blas_thread,
                               one_hierarchy_per_mesh, runs)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resume_ignores_skip_time(runs, tmp_path, caplog):
    full, part, _ = runs[False]
    with caplog.at_level(logging.WARNING):
        resumed = _solve(full.device,
                         _options(0.32, tmp_path / "skip.h5", skip_time=1.0),
                         resume_from=part.path)
    assert "skip_time is ignored" in caplog.text
    # No thermalization ran: the run continues from the checkpoint's step.
    assert resumed.tdgl_data.state["step"] > part.tdgl_data.state["step"]
    assert resumed.tdgl_data.state["time"] >= 0.32


_KILLED = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    import tdgl_tpu_torch as ttdgl
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(10)).resample(120)
    device = ttdgl.Device("resume", layer=layer, film=film,
                          length_units="um")
    device.make_mesh(min_points=300, structured=True)
    options = ttdgl.SolverOptions(
        solve_time=1e5, dt_init=1e-4, dt_max=1e-2, save_every=20,
        field_units="mT", current_units="uA", dtype="float64",
        output_file=sys.argv[1])
    ttdgl.solve(device, options, applied_vector_potential=0.4,
                torch_device="cpu")
""")


def test_resume_after_hard_kill(devices, tmp_path):
    """SIGKILL the solver mid-run (simulated preemption) and resume from
    the partial file: the flush at every checkpoint must leave a readable
    checkpoint although the writer never closed the file."""
    out = tmp_path / "killed.h5"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _KILLED, str(out)],
                            cwd=str(tmp_path), env=env)
    try:
        # Wait for at least two flushed checkpoints, then kill hard. A
        # read that meets the writer mid-flush raises OSError or KeyError
        # and is retried.
        deadline = time.time() + 240
        seen_step = 0
        while time.time() < deadline and proc.poll() is None:
            if out.exists():
                try:
                    with h5lite.File(out, "r") as f:
                        if "checkpoint" in f:
                            seen_step = int(f["checkpoint"].attrs["step"])
                except (OSError, KeyError):
                    pass
            if seen_step >= 40:
                break
            time.sleep(0.2)
        assert proc.poll() is None, "solver exited before it could be killed"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert seen_step >= 40, "never saw a checkpoint before the deadline"
    with h5lite.File(out, "r") as f:
        ckpt_step = int(f["checkpoint"].attrs["step"])
        ckpt_time = float(f["checkpoint"].attrs["time"])
    resumed = _solve(devices[True],
                     _options(ckpt_time + 0.05, tmp_path / "continued.h5"),
                     resume_from=str(out))
    assert int(resumed.tdgl_data.state["step"]) > ckpt_step
    assert float(resumed.tdgl_data.state["time"]) >= ckpt_time + 0.05


def test_resume_screened_and_traced_A(devices, tmp_path):
    """Resume with self-consistent screening (A_induced rides in the state)
    and a TRACED time-dependent applied potential: the continued
    trajectory matches an uninterrupted run exactly."""
    A = ttdgl.sources.LinearRamp(tmin=0, tmax=2.0) * ttdgl.sources.\
        ConstantField(0.3, field_units="mT")
    assert A.jittable

    def run(solve_time, name, resume_from=None):
        return _solve(devices[True],
                      _options(solve_time, tmp_path / name, save_every=20,
                               include_screening=True,
                               screening_tolerance=1e-3),
                      applied_vector_potential=A, resume_from=resume_from)

    full = run(0.04, "sfull.h5")
    part = run(0.02, "spart.h5")
    resumed = run(0.04, "sres.h5", resume_from=part.path)
    np.testing.assert_array_equal(resumed.tdgl_data.psi, full.tdgl_data.psi)
    np.testing.assert_array_equal(
        resumed.tdgl_data.induced_vector_potential,
        full.tdgl_data.induced_vector_potential,
    )
    assert np.abs(full.tdgl_data.induced_vector_potential).max() > 0
    assert resumed.tdgl_data.state["time"] == full.tdgl_data.state["time"]


def test_resume_factored_repairs_masked_A(devices, tmp_path):
    """The factored-link-phase path needs the SMOOTH full-grid A fill in
    state.A_applied. A checkpoint whose fill is the masked (edge-scattered)
    grid, the same physics at real edges, is repaired in place; a
    checkpoint from a different applied potential is rejected."""
    device = devices[True]

    def options(solve_time, name):
        return _options(solve_time, tmp_path / name, dtype="float32",
                        save_every=20)

    sol = _solve(device, options(0.3, "f.h5"), applied_vector_potential=0.3)
    probe = TDGLSolver(device, options(0.4, "p.h5"),
                       applied_vector_potential=0.3, torch_device="cpu")
    assert probe.cfg.factor_link_phases  # uniform field, f32 structured
    maps = probe.maps

    def rewrite_A(transform):
        with h5lite.File(sol.path, "r+") as f:
            A = np.asarray(f["checkpoint/A_applied"])
            del f["checkpoint/A_applied"]
            f["checkpoint/A_applied"] = transform(A)

    def masked(A):
        # The fill an older writer would have produced: smooth values at
        # real edges only.
        flat = np.zeros((3 * A.shape[1] * A.shape[2], 2), A.dtype)
        flat[maps.edge_flat] = A.reshape(-1, 2)[maps.edge_flat]
        return flat.reshape(A.shape)

    rewrite_A(masked)
    resumed = _solve(device, options(0.4, "r.h5"),
                     applied_vector_potential=0.3, resume_from=sol.path)
    assert resumed.tdgl_data is not None  # repaired and ran
    assert resumed.tdgl_data.state["time"] >= 0.4
    rewrite_A(lambda A: 2.0 * A)
    with pytest.raises(ValueError, match="A_applied"):
        _solve(device, options(0.4, "r2.h5"), applied_vector_potential=0.3,
               resume_from=sol.path)


def test_seed_solution_device_mismatch(runs, tmp_path):
    sol = runs[False][0]
    other = sol.device.copy()
    other.layer.thickness *= 3
    with pytest.raises(ValueError, match="seed_solution.device"):
        _solve(other, _options(0.01, tmp_path / "b.h5"), seed_solution=sol)
