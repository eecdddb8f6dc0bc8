"""The slice as a whole: the torch TDGLSolver's chunk program against the
JAX package's, step for step.

Both packages build a ``TDGLSolver`` on the same device; ``convert`` hands
the JAX initial state to the port, and ``chunk_fn`` runs in both.

* float64 at fixed dt (40 steps, transport device with terminals, a hole
  and probes): psi and mu agree to 1e-10 relative — the same operation
  order, so only transcendental rounding differs.
* float32 with default options (adaptive dt, factored link phases, the
  gated fixed-1 fast program with failover to the robust fixed-2 + top-up
  program), 60 steps: psi to 5e-4 and mu to 5e-3 relative, the pins of
  ``tests/test_pallas_step.py`` for two formulations of the same f32 step,
  and equal failover counts. The cold start trips the fast program's gate,
  so the robust program (retries, top-up CG) is compared too.
"""

import sys

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS and OpenMP thread: the multigrid set-up's dense
    pseudo-inverse (numpy's OpenBLAS) otherwise spins eight threads on a
    CPU the other test workers keep busy."""
    with threadpool_limits(limits=1):
        yield


def _transport_device(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(14, 8)).resample(200)
    hole = pkg.Polygon("hole", points=pkg.circle(1.0, center=(2, 1)))
    source = pkg.Polygon("source", points=pkg.box(1, 6, center=(-7, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, 6, center=(7, 0)))
    device = pkg.Device("tr", layer=layer, film=film, holes=[hole],
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=700, structured=True)
    return device


def _box_device(pkg, structured=True):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(10)).resample(100)
    device = pkg.Device("box", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=400, structured=structured)
    return device


def _pair(make_device, solver_kwargs, **options):
    jax_solver = JaxSolver(make_device(jtdgl), jtdgl.SolverOptions(**options),
                           applied_vector_potential=0.5, **solver_kwargs)
    torch_solver = ttdgl.TDGLSolver(
        make_device(ttdgl), ttdgl.SolverOptions(**options),
        applied_vector_potential=0.5, torch_device="cpu", **solver_kwargs)
    jstate = jax_solver._initial_state()
    tstate = convert.grid_state_to_torch(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    return jax_solver, torch_solver, jstate, tstate


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_float64_fixed_dt_trajectory():
    js, ts, jstate, tstate = _pair(
        _transport_device, dict(terminal_currents=dict(source=5.0,
                                                       drain=-5.0)),
        solve_time=1e9, dt_init=1e-3, adaptive=False, save_every=20,
        steps_per_chunk=20, dtype="float64", field_units="mT",
        current_units="uA")
    for _ in range(2):
        jstate, jout, jexp = js.chunk_fn(jstate)
        tstate, tout, texp = ts.chunk_fn(tstate)
    assert int(jstate.step) == int(tstate.step) == 40
    assert not bool(jstate.failed) and not bool(tstate.failed)
    for name in ("psi_r", "psi_i", "mu", "supercurrent", "normal_current"):
        assert _rel(getattr(tstate, name), getattr(jstate, name)) < 1e-10, \
            name
    assert _rel(tout.mu_probe, jout.mu_probe) < 1e-10
    assert np.array_equal(tout.cg_iterations.numpy(),
                          np.asarray(jout.cg_iterations))
    assert np.array_equal(texp["diagnostics"].numpy(),
                          np.asarray(jexp["diagnostics"]))
    # The mesh-vector view of the exported state agrees too.
    tarr = ts._state_to_arrays(texp)
    jarr = js._state_to_arrays(jax.tree.map(np.asarray, jexp))
    assert np.abs(tarr["psi"] - jarr["psi"]).max() < 1e-10
    # An exported dict converts back into a state (scalars from its
    # float32 diagnostics, the rest from the template).
    back = convert.grid_state_to_torch(jax.tree.map(np.asarray, jexp), "cpu",
                                       template=tstate)
    assert np.array_equal(back.psi_r.numpy(), np.asarray(jstate.psi_r))
    assert int(back.step) == 40 and back.step.dtype == torch.int32
    assert not bool(back.failed) and back.done.dtype == torch.bool


def test_float32_default_options_trajectory():
    js, ts, jstate, tstate = _pair(
        _box_device, {}, solve_time=1e9, save_every=20, steps_per_chunk=20,
        dtype="float32", field_units="mT", current_units="uA")
    assert ts.cfg.factor_link_phases and js.cfg.factor_link_phases
    assert ts._fast_cfg.poisson_fixed_iters == 1
    for _ in range(3):
        jstate, _, _ = js.chunk_fn(jstate)
        tstate, tout, _ = ts.chunk_fn(tstate)
    assert int(jstate.step) == int(tstate.step) == 60
    assert not bool(jstate.failed) and not bool(tstate.failed)
    assert js._failover_count == ts._failover_count >= 1
    assert _rel(tstate.psi_r, jstate.psi_r) < 5e-4
    assert _rel(tstate.psi_i, jstate.psi_i) < 5e-4
    assert _rel(tstate.mu, jstate.mu) < 5e-3
    assert tout.valid.sum() == 20


def test_unported_paths_raise(monkeypatch):
    device = _box_device(ttdgl)
    opts = dict(solve_time=1.0, field_units="mT", current_units="uA")
    with pytest.raises(ttdgl.SolverOptionsError, match="mxu"):
        ttdgl.TDGLSolver(device, ttdgl.SolverOptions(
            include_screening=True, screening_kernel="mxu", **opts),
            torch_device="cpu")
    # The ELL backend is ported: solver_backend="ell" on a structured mesh
    # builds an ELL solver.
    ell = ttdgl.TDGLSolver(device, ttdgl.SolverOptions(
        solver_backend="ell", **opts), torch_device="cpu")
    assert not ell.structured and ell.op is not None and ell.sten is None
    # On an unstructured mesh the stencil-only options raise, as in the
    # JAX package.
    for pkg, kw in ((jtdgl, {}), (ttdgl, {"torch_device": "cpu"})):
        mesh_device = _box_device(pkg, structured=False)
        for bad, error in ((dict(chunk_failover="on"),
                            pkg.SolverOptionsError),
                           (dict(poisson_solver="mg"),
                            pkg.SolverOptionsError),
                           (dict(include_screening=True,
                                 screening_kernel="fft"), ValueError)):
            solver_cls = JaxSolver if pkg is jtdgl else ttdgl.TDGLSolver
            with pytest.raises(error):
                solver_cls(mesh_device, pkg.SolverOptions(**bad, **opts),
                           **kw)
    # Above unstructured_tpu_site_limit every tensor stays on the
    # requested device (the JAX package moves such solves to the host).
    small_limit = ttdgl.TDGLSolver(
        mesh_device, ttdgl.SolverOptions(unstructured_tpu_site_limit=10,
                                         **opts), torch_device="cpu")
    state = small_limit._initial_state()
    tensors = (list(small_limit.op) + list(small_limit.amg) + list(state))
    assert all(t.device == torch.device("cpu") for t in tensors)
    state, _, _ = small_limit.chunk_fn(state)
    assert state.psi.device == torch.device("cpu")
    solver = ttdgl.TDGLSolver(device, ttdgl.SolverOptions(**opts),
                              torch_device="cpu")
    # Resume is ported: it opens the checkpointed run's file.
    with pytest.raises(FileNotFoundError, match="previous.h5"):
        solver.solve(resume_from="previous.h5")
    # The live monitor is ported; where matplotlib is missing it raises
    # before the first step.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ttdgl.TDGLSolver(device, ttdgl.SolverOptions(monitor=True, **opts),
                         torch_device="cpu").solve()
    monkeypatch.undo()
    # The default device is the card: without CUDA the solver raises.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttdgl.TDGLSolver(device, ttdgl.SolverOptions(**opts))
