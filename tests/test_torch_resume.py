"""Exact resume, seed solutions and interrupt handling in the port.

The port's counterparts of the JAX package's ``tests/test_resume.py``,
``tests/test_solver_features.py:23-64`` and ``tests/test_interrupt.py``,
run on the port alone (the cross-package resume and seed tests sit beside
their solve fixtures in ``tests/test_torch_solve.py`` and
``tests/test_torch_ell.py``). The films are cut from the JAX tests' 900
and 500 sites to about 300 sites (a 10 x 10 box), and the run lengths from
``solve_time`` 8 / 4 to 0.6 / 0.3 (and the interrupt tests' chunks from
50 to 20 steps), so that the whole file stays within a few seconds of
solver time per backend:

* a run to 0.3 resumed to 0.6 equals the uninterrupted run to 0.6 bit for
  bit in float64 (psi, mu, step, time, dt), on the structured and the ELL
  backend, and its first snapshot carries the checkpoint's absolute time
  and step;
* every error case raises the JAX package's exception with a message
  matching the JAX test's ``match=``: no checkpoint, another mesh, another
  backend, a finished run, another dtype, seed and resume together;
* a solver process killed with SIGKILL leaves a checkpoint that h5lite
  reads (torn reads during writes are retried) and the run resumes;
* a screened run with a traced applied potential resumes exactly;
* the factored-link-phase path repairs a masked ``A_applied`` in a
  checkpoint and rejects a different field;
* a run seeded from a solution starts from its final psi, and a seed of
  another device raises;
* a ``KeyboardInterrupt`` injected before a chunk cancels (with partial,
  loadable data), pauses and continues, or is declined, on both backends,
  and a cancel during thermalization returns None.
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
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.solver.solver import TDGLSolver
from tdgl_tpu_torch.utils import h5lite

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = pytest.mark.parametrize("structured", [True, False],
                                   ids=["grid", "ell"])


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS and OpenMP thread: each solver's set-up takes a dense
    pseudo-inverse whose eight OpenBLAS threads would spin on a CPU the
    other test workers keep busy."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_hierarchy_per_mesh():
    """Each package builds a mesh's multigrid hierarchy once in this
    module (``tdgl_tpu_torch.testing.one_hierarchy_per_mesh``)."""
    from tdgl_tpu.ops import hexmg as jhexmg
    from tdgl_tpu_torch import testing
    from tdgl_tpu_torch.solver import solver as tsolver

    with testing.one_hierarchy_per_mesh((jhexmg, "build_hexmg"),
                                        (tsolver, "build_hexmg")):
        yield


def _device(structured: bool, min_points: int = 300):
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(10)).resample(120)
    device = ttdgl.Device("resume", layer=layer, film=film,
                          length_units="um")
    device.make_mesh(min_points=min_points, structured=structured)
    return device


@pytest.fixture(scope="module")
def devices():
    return {structured: _device(structured) for structured in (True, False)}


def _options(solve_time, path, **kwargs):
    kwargs = dict(dict(dt_init=1e-4, dt_max=1e-2, save_every=50,
                       dtype="float64", field_units="mT",
                       current_units="uA"), **kwargs)
    return ttdgl.SolverOptions(solve_time=solve_time, output_file=str(path),
                               **kwargs)


def _solve(device, options, **kwargs):
    kwargs.setdefault("applied_vector_potential", 0.4)
    return ttdgl.solve(device, options, torch_device="cpu", **kwargs)


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """Per backend: the run to 0.6, the run to 0.3, and the latter resumed
    to 0.6 (the adaptive dt is still growing from dt_init there)."""
    out = {}
    for structured, device in devices.items():
        d = tmp_path_factory.mktemp("grid" if structured else "ell")
        full = _solve(device, _options(0.6, d / "full.h5"))
        part = _solve(device, _options(0.3, d / "part.h5"))
        resumed = _solve(device, _options(0.6, d / "resumed.h5"),
                         resume_from=part.path)
        out[structured] = (full, part, resumed)
    return out


@BACKENDS
def test_resume_reproduces_uninterrupted_run(runs, structured):
    full, part, resumed = runs[structured]
    with h5lite.File(part.path, "r") as f:
        ckpt_step = int(f["checkpoint"].attrs["step"])
        ckpt_time = float(f["checkpoint"].attrs["time"])
        assert f["checkpoint"].attrs["backend"] == (
            "grid" if structured else "ell")
    assert ckpt_step > 0 and 0.3 <= ckpt_time < 0.6
    np.testing.assert_array_equal(resumed.tdgl_data.psi, full.tdgl_data.psi)
    np.testing.assert_array_equal(resumed.tdgl_data.mu, full.tdgl_data.mu)
    for key in ("step", "time", "dt"):
        assert resumed.tdgl_data.state[key] == full.tdgl_data.state[key], key
    # Snapshot attrs carry the ABSOLUTE time, continuing from the
    # checkpoint; the resumed file loads and equals the returned solution.
    with h5lite.File(resumed.path, "r") as f:
        assert f["data/0"].attrs["time"] == pytest.approx(ckpt_time,
                                                          abs=1e-6)
        assert f["data/0"].attrs["step"] == ckpt_step
    assert ttdgl.Solution.from_hdf5(resumed.path).equals(resumed)


def test_resume_requires_checkpoint(devices, tmp_path):
    device = devices[True]
    sol = _solve(device, _options(0.01, tmp_path / "nock.h5", save_every=10,
                                  save_checkpoints=False))
    with h5lite.File(sol.path, "r") as f:
        assert "checkpoint" not in f
    with pytest.raises(ValueError, match="no checkpoint"):
        _solve(device, _options(0.02, tmp_path / "res.h5"),
               resume_from=sol.path)


def test_resume_rejects_mismatched_mesh(runs, tmp_path):
    part = runs[True][1]
    other = _device(structured=True, min_points=500)
    with pytest.raises(ValueError, match="shape|fingerprint"):
        _solve(other, _options(2.0, tmp_path / "b.h5"),
               resume_from=part.path)
    # Backend mismatch is caught before shapes.
    with pytest.raises(ValueError, match="backend"):
        _solve(runs[False][0].device, _options(2.0, tmp_path / "c.h5"),
               resume_from=part.path)


def test_resume_rejects_finished_run_and_other_dtype(runs, tmp_path):
    full, part, _ = runs[True]
    with pytest.raises(ValueError, match="solve_time"):
        _solve(full.device, _options(0.3, tmp_path / "e.h5"),
               resume_from=part.path)
    with pytest.raises(ValueError, match="dtype"):
        _solve(full.device, _options(2.0, tmp_path / "f.h5",
                                     dtype="float32"),
               resume_from=part.path)
    with pytest.raises(ValueError, match="either seed_solution or"):
        _solve(full.device, _options(2.0, tmp_path / "g.h5"),
               resume_from=part.path, seed_solution=full)


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


@BACKENDS
def test_seed_solution(runs, structured, tmp_path):
    first = runs[structured][0]
    second = _solve(first.device, _options(0.05, tmp_path / "second.h5"),
                    seed_solution=first)
    # The seeded run's step-0 snapshot equals the seed's final state.
    second.solve_step = 0
    np.testing.assert_allclose(second.tdgl_data.psi, first.tdgl_data.psi,
                               atol=1e-7)
    assert second.tdgl_data.state["step"] == 0
    # And it must not restart from the uniform state.
    second.solve_step = -1
    assert np.abs(second.tdgl_data.psi).min() < 1.0 - 1e-4


def test_seed_solution_device_mismatch(runs, tmp_path):
    sol = runs[False][0]
    other = sol.device.copy()
    other.layer.thickness *= 3
    with pytest.raises(ValueError, match="seed_solution.device"):
        _solve(other, _options(0.01, tmp_path / "b.h5"), seed_solution=sol)


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
