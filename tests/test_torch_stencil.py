"""Parity of the torch stencil model and of the fused-kernel wrappers'
plain versions against the JAX package.

The same seeded inputs (numpy) go through ``tdgl_tpu.models.gtdgl_stencil``
and ``tdgl_tpu_torch.models.gtdgl_stencil``, and through the Pallas kernels
(``tdgl_tpu.ops.pallas_step``, interpret mode on the CPU, as
``tests/test_pallas_step.py`` runs them) and the port's wrappers, which on
CPU tensors run their plain versions. Tolerances: 1e-12 relative in
float64 (same operation order; only libm/XLA transcendental rounding
differs); in float32 the pins of ``tests/test_pallas_step.py``: 3e-5
absolute for psi and 3e-5 times the RHS scale for the RHS.

This module keeps 6 of the cases, and ``tests/test_torch_stencil_*.py``
hold the others, 7 or fewer to a file, so that pytest-xdist's ``--dist
loadfile`` queues each file behind the long JAX files (ROADMAP
"Test-time budget"); they import this module's fixtures and helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
from tdgl_tpu.models import gtdgl_stencil as jgs
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.models import gtdgl_stencil as tgs

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for this module's set-up: the multigrid's dense
    pseudo-inverse otherwise spins eight OpenBLAS threads on a CPU that
    the other test workers keep busy (see ``tests/test_torch_solve.py``)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def device():
    layer = jtdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = jtdgl.Polygon("film", points=jtdgl.box(14, 8)).resample(200)
    hole = jtdgl.Polygon("hole", points=jtdgl.circle(1.0, center=(2, 1)))
    source = jtdgl.Polygon("source", points=jtdgl.box(1, 6, center=(-7, 0)))
    drain = jtdgl.Polygon("drain", points=jtdgl.box(1, 6, center=(7, 0)))
    dev = jtdgl.Device("st", layer=layer, film=film, holes=[hole],
                       terminals=[source, drain], length_units="um")
    dev.make_mesh(min_points=700, structured=True)
    return dev


@pytest.fixture(scope="module", params=sorted(DTYPES))
def case(request, device):
    """Both packages' stencils, raw and factored link phases, and a seeded
    random state, in one dtype. The JAX solver gives the stencil, the
    state and the step constants; it is built with the Jacobi
    preconditioner, so it skips the multigrid set-up no test here reads."""
    npd, _ = DTYPES[request.param]
    options = jtdgl.SolverOptions(solve_time=1.0, dtype=request.param,
                                  field_units="mT", current_units="uA",
                                  factor_link_phases=True,
                                  poisson_preconditioner="jacobi")
    solver = JaxSolver(device, options, applied_vector_potential=0.5,
                       terminal_currents=dict(source=3.0, drain=-3.0))
    state = solver._initial_state()
    jsten = solver.sten
    shape = solver.maps.shape
    valid = np.asarray(solver.host_sten.valid)
    rng = np.random.default_rng(11)
    amp = rng.uniform(0.2, 1.0, shape)
    phase = rng.uniform(-np.pi, np.pi, shape)
    arrays = dict(
        pr=(amp * np.cos(phase) * valid).astype(npd),
        pi=(amp * np.sin(phase) * valid).astype(npd),
        mu=(rng.normal(size=shape) * 0.3 * valid).astype(npd),
        eps=(1.0 - 0.2 * rng.uniform(size=shape) * valid).astype(npd),
        dA=(rng.normal(size=(3,) + shape) * 0.05
            * np.asarray(solver.host_sten.edge_valid)).astype(npd),
        x=(rng.normal(size=shape) * valid).astype(npd),
    )
    arrays["neumann"] = np.asarray(state.neumann_term)
    jU = {"raw": jgs.edge_link_phases(jsten, state.A_applied),
          "factored": jgs.factor_link_phases(jsten, state.A_applied)}
    tsten = convert.stencil_to_torch(solver.host_sten, "cpu")
    tU = {k: convert.link_phases_to_torch(jax.tree.map(np.asarray, v), "cpu")
          for k, v in jU.items()}
    A = np.asarray(state.A_applied)
    return dict(dtype=request.param, solver=solver, jsten=jsten, tsten=tsten,
                jU=jU, tU=tU, A=A, arrays=arrays)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _j(case, name):
    return jnp.asarray(case["arrays"][name])


def _t(case, name):
    return torch.from_numpy(case["arrays"][name].copy())


def _tol(case):
    return 1e-12 if case["dtype"] == "float64" else 1e-5


def test_link_phases(case):
    A_j = jnp.asarray(case["A"])
    A_t = torch.from_numpy(case["A"].copy())
    jr = jgs.edge_link_phases(case["jsten"], A_j)
    tr = tgs.edge_link_phases(case["tsten"], A_t)
    for f in jr._fields:
        assert _rel(getattr(tr, f), getattr(jr, f)) < _tol(case), f
    jf = jgs.factor_link_phases(case["jsten"], A_j)
    tf = tgs.factor_link_phases(case["tsten"], A_t)
    for f in jf._fields:
        assert _rel(getattr(tf, f), getattr(jf, f)) < _tol(case), f


@pytest.mark.parametrize("form", ["raw", "factored"])
def test_link_dependent_stencils(case, form):
    js, ts = case["jsten"], case["tsten"]
    jU, tU = case["jU"][form], case["tU"][form]
    pr_j, pi_j, pr_t, pi_t = (_j(case, "pr"), _j(case, "pi"),
                              _t(case, "pr"), _t(case, "pi"))
    tol = _tol(case)
    for a, b in zip(tgs.covariant_laplacian(ts, tU, pr_t, pi_t),
                    jgs.covariant_laplacian(js, jU, pr_j, pi_j)):
        assert _rel(a, b) < tol
    assert _rel(tgs.supercurrent_on_edges(ts, tU, pr_t, pi_t),
                jgs.supercurrent_on_edges(js, jU, pr_j, pi_j)) < tol
    old_sq_j, old_sq_t = pr_j**2 + pi_j**2, pr_t**2 + pi_t**2
    dt = 1e-2
    jres = jgs.implicit_euler_psi(js, jU, pr_j, pi_j, old_sq_j,
                                  _j(case, "mu"), _j(case, "eps"), 1.7, 5.79,
                                  jnp.asarray(dt, pr_j.dtype))
    tres = tgs.implicit_euler_psi(ts, tU, pr_t, pi_t, old_sq_t,
                                  _t(case, "mu"), _t(case, "eps"), 1.7, 5.79,
                                  torch.tensor(dt, dtype=pr_t.dtype))
    for f in ("psi_r", "psi_i", "abs_sq_psi"):
        assert _rel(getattr(tres, f), getattr(jres, f)) < tol, f
    assert bool(tres.ok) == bool(jres.ok)


def _psi_args(case):
    return (_t(case, "pr"), _t(case, "pi"), _t(case, "mu"), _t(case, "eps"))


def _psi_tol(case, ref):
    if case["dtype"] == "float64":
        return 1e-12 * max(np.abs(np.asarray(ref)).max(), 1.0)
    return 3e-5
