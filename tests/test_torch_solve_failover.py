"""Chunk failover: float64 bitwise against the robust program, the float32
cold start, the fast chunk's gated steps and the gate's value.

The helpers are in ``tests/test_torch_solve.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tdgl_tpu_torch as ttdgl

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_solve import (_transport_device, one_blas_thread,
                              one_hierarchy_per_mesh)


# -- (d) the failover gate tests through the port's solve() ------------------
def _fo_device():
    layer = ttdgl.Layer(coherence_length=0.5, london_lambda=2,
                        thickness=0.05, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(8)).resample(200)
    device = ttdgl.Device("fo", layer=layer, film=film)
    device.make_mesh(structured=True, max_edge_length=0.25)
    return device


@pytest.fixture(scope="module")
def fo_solves():
    device = _fo_device()
    # The four solvers share the device and so its multigrid hierarchy
    # (its coarsest level is a 2048 x 2048 pseudo-inverse, and the build
    # reads the mesh, not the stencil's dtype): the module's
    # one_hierarchy_per_mesh builds it once.
    out = {}
    for dtype in ("float64", "float32"):
        for failover in ("auto", "off"):
            options = ttdgl.SolverOptions(
                solve_time=0.3, dt_init=1e-5, save_every=20,
                output_file=None, dtype=dtype, chunk_failover=failover)
            solver = ttdgl.TDGLSolver(device, options,
                                      applied_vector_potential=0.4,
                                      torch_device="cpu")
            out[dtype, failover] = (solver, solver.solve())
    return out


def test_failover_f64_bitwise_vs_robust(fo_solves):
    (s_fast, sol_fast) = fo_solves["float64", "auto"]
    (s_rob, sol_rob) = fo_solves["float64", "off"]
    assert hasattr(s_fast, "_fast_chunk_fn")
    assert not hasattr(s_rob, "_fast_chunk_fn")
    assert s_fast._failover_count >= 1
    a, b = sol_fast.tdgl_data, sol_rob.tdgl_data
    assert np.array_equal(a.psi, b.psi)
    assert np.array_equal(a.mu, b.mu)


def test_failover_f32_cold_start_fires_then_fast(fo_solves):
    (s_fast, sol_fast) = fo_solves["float32", "auto"]
    (s_rob, sol_rob) = fo_solves["float32", "off"]
    # The cold-start chunk fails over; the steady chunks must not.
    assert sol_fast.data_range[1] >= 2
    assert 1 <= s_fast._failover_count <= 3
    a = np.abs(sol_fast.tdgl_data.psi)
    b = np.abs(sol_rob.tdgl_data.psi)
    assert float(np.max(np.abs(a - b))) < 1e-3


def test_fast_chunk_accepts_only_gated_steps(fo_solves):
    s, _ = fo_solves["float32", "auto"]
    state = s._initial_state()._replace(end_time=torch.tensor(1e9))
    for _ in range(3):
        state, _, _ = s.chunk_fn(state)
    _, outputs, exported = s._fast_chunk_fn(s.sten, s.amg, state)
    assert not bool(exported["diagnostics"][5])
    assert int(outputs.valid.sum()) == s.chunk_size


def test_fast_cfg_gate_value(fo_solves):
    # Unscreened auto float32: the fast program runs the gated fixed-1 mu
    # solve with the 1e-2 fail gate; the robust program keeps fixed-2 and
    # the top-up. An explicit tolerance opts out of the fixed-1 override.
    s, _ = fo_solves["float32", "auto"]
    assert s._fast_cfg.fast_chunk
    assert s._fast_cfg.poisson_fixed_iters == 1
    assert s.cfg.poisson_fixed_iters == 2
    assert s._fast_cfg.poisson_fail_gate == pytest.approx(1e-2)
    s2 = ttdgl.TDGLSolver(_transport_device(ttdgl), dataclasses.replace(
        s.options, poisson_tolerance=1e-4), applied_vector_potential=0.4,
        torch_device="cpu")
    assert s2._fast_cfg.poisson_fixed_iters == 2
    assert s2._fast_cfg.poisson_fail_gate == pytest.approx(
        10.0 * s2.cfg.poisson_tolerance)
