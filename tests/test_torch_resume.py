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

This module keeps 7 of the cases, and ``tests/test_torch_resume_*.py``
hold the others, 7 or fewer to a file, so that pytest-xdist's ``--dist
loadfile`` queues each file behind the long JAX files (ROADMAP
"Test-time budget"); they import this module's fixtures and helpers.
"""

import time

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch import testing
from tdgl_tpu_torch.utils import h5lite

torch.set_num_threads(1)

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
    """Per backend (``structured``): the run to 0.6, the run to 0.3, and
    the latter resumed to 0.6 (the adaptive dt is still growing from
    dt_init there); a backend's runs are made where a test of the file
    reads them (``testing.PerKey``)."""
    def run(structured):
        device = devices[structured]
        d = tmp_path_factory.mktemp("grid" if structured else "ell")
        full = _solve(device, _options(0.6, d / "full.h5"))
        part = _solve(device, _options(0.3, d / "part.h5"))
        resumed = _solve(device, _options(0.6, d / "resumed.h5"),
                         resume_from=part.path)
        return full, part, resumed

    return testing.PerKey(run)


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
