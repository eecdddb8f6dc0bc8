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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdgl_tpu as jtdgl
from tdgl_tpu.models import gtdgl_stencil as jgs
from tdgl_tpu.ops import pallas_step
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.models import gtdgl_stencil as tgs
from tdgl_tpu_torch.ops import step_kernels

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


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
    random state, in one dtype."""
    npd, _ = DTYPES[request.param]
    options = jtdgl.SolverOptions(solve_time=1.0, dtype=request.param,
                                  field_units="mT", current_units="uA",
                                  factor_link_phases=True)
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


def test_link_free_stencils(case):
    js, ts = case["jsten"], case["tsten"]
    tol = _tol(case)
    x_j, x_t = _j(case, "x"), _t(case, "x")
    assert _rel(tgs.scalar_laplacian_sym(ts, x_t),
                jgs.scalar_laplacian_sym(js, x_j)) < tol
    assert _rel(tgs.gradient_on_edges(ts, x_t),
                jgs.gradient_on_edges(js, x_j)) < tol
    F_j = jnp.stack([x_j, 2 * x_j, -x_j])
    F_t = torch.stack([x_t, 2 * x_t, -x_t])
    assert _rel(tgs.divergence_on_sites(ts, F_t),
                jgs.divergence_on_sites(js, F_j)) < tol
    assert _rel(tgs.poisson_rhs(ts, F_t, _t(case, "dA"), _t(case, "x")),
                jgs.poisson_rhs(js, F_j, _j(case, "dA"), x_j)) < tol
    mu_b = case["solver"]._mu_boundary(0.0)
    nb_t = tgs.neumann_boundary_term(ts, torch.from_numpy(mu_b))
    assert _rel(nb_t, jgs.neumann_boundary_term(js, jnp.asarray(mu_b))) < tol
    assert np.abs(nb_t.numpy()).max() > 0


def _psi_args(case):
    return (_t(case, "pr"), _t(case, "pi"), _t(case, "mu"), _t(case, "eps"))


def _psi_tol(case, ref):
    if case["dtype"] == "float64":
        return 1e-12 * max(np.abs(np.asarray(ref)).max(), 1.0)
    return 3e-5


def test_psi_kernel_plain_matches_pallas(case):
    """Raw links: the wrapper's plain version vs the Pallas kernel."""
    solver = case["solver"]
    g, u = solver.cfg.gamma, solver.cfg.u
    dt = 1e-2
    jd = case["arrays"]["pr"].dtype
    ref = pallas_step.fused_psi_update(
        g, u, case["jsten"], case["jU"]["raw"], _j(case, "pr"),
        _j(case, "pi"), _j(case, "mu"), _j(case, "eps"),
        jnp.asarray(dt, jd))
    got = step_kernels.fused_psi_update(
        g, u, case["tsten"], case["tU"]["raw"], *_psi_args(case),
        torch.tensor(dt, dtype=_t(case, "pr").dtype))
    for a, b in zip(got[:3], ref[:3]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < _psi_tol(case, b)
    assert bool(got[3]) == bool(ref[3])


def test_rhs_kernel_plain_matches_pallas(case):
    ref = pallas_step.fused_poisson_rhs(
        case["jsten"], case["jU"]["raw"], _j(case, "pr"), _j(case, "pi"),
        _j(case, "dA"), _j(case, "neumann"))
    got = step_kernels.fused_poisson_rhs(
        case["tsten"], case["tU"]["raw"], _t(case, "pr"), _t(case, "pi"),
        _t(case, "dA"), _t(case, "neumann"))
    scale = max(float(np.abs(np.asarray(ref)).max()), 1.0)
    tol = 1e-12 if case["dtype"] == "float64" else 3e-5
    assert np.abs(got.numpy() - np.asarray(ref)).max() < tol * scale


def test_kernels_plain_factored_match_gs(case):
    """Factored links (the Pallas kernels take raw planes only): the
    wrappers' plain versions vs the JAX stencil composition."""
    solver = case["solver"]
    g, u = solver.cfg.gamma, solver.cfg.u
    js, jU = case["jsten"], case["jU"]["factored"]
    pr_j, pi_j = _j(case, "pr"), _j(case, "pi")
    dt = 1e-2
    ref = jgs.implicit_euler_psi(js, jU, pr_j, pi_j, pr_j**2 + pi_j**2,
                                 _j(case, "mu"), _j(case, "eps"), g, u,
                                 jnp.asarray(dt, pr_j.dtype))
    got = step_kernels.fused_psi_update(
        g, u, case["tsten"], case["tU"]["factored"], *_psi_args(case), dt)
    for a, b in zip(got[:3], ref[:3]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < _psi_tol(case, b)
    assert bool(got[3]) == bool(ref.ok)
    rhs_ref = jgs.poisson_rhs(js, jgs.supercurrent_on_edges(js, jU, pr_j,
                                                            pi_j),
                              _j(case, "dA"), _j(case, "neumann"))
    rhs = step_kernels.fused_poisson_rhs(
        case["tsten"], case["tU"]["factored"], _t(case, "pr"),
        _t(case, "pi"), _t(case, "dA"), _t(case, "neumann"))
    scale = max(float(np.abs(np.asarray(rhs_ref)).max()), 1.0)
    tol = 1e-12 if case["dtype"] == "float64" else 3e-5
    assert np.abs(rhs.numpy() - np.asarray(rhs_ref)).max() < tol * scale


def test_cpu_tensors_do_not_launch(case):
    """On CPU tensors the wrappers run their plain versions: the launch
    counters stay at 0 and no kernel library is loaded."""
    from tdgl_tpu_torch.ops import kernel_build

    step_kernels.reset_launch_counts()
    solver = case["solver"]
    for form in ("raw", "factored"):
        step_kernels.fused_psi_update(
            solver.cfg.gamma, solver.cfg.u, case["tsten"], case["tU"][form],
            *_psi_args(case), 1e-2)
        step_kernels.fused_poisson_rhs(
            case["tsten"], case["tU"][form], _t(case, "pr"), _t(case, "pi"),
            _t(case, "dA"), _t(case, "neumann"))
    assert step_kernels.fused_psi_update.launches == 0
    assert step_kernels.fused_poisson_rhs.launches == 0
    assert kernel_build._lib is None
