"""Time-dependent inputs in the port against the JAX package.

On the ~700-site transport device of ``tests/test_torch_solve.py`` (two
terminals, a hole, two probes), in float64 at a fixed dt:

* the sources (``LinearRamp``, ``Scale``, ``CurrentLoop``, composites)
  give the JAX package's values on the host, and ``evaluate_traced`` on
  tensors gives the same values;
* a traced field ramp (``ConstantField * LinearRamp``), a traced current
  ramp (the port of ``tests/test_stencil.py:267-333``) and a traced
  ``t``-dependent epsilon run in chunks of 25 steps (chunk size > 1) for
  100 steps and match ``tdgl_tpu``'s ``TDGLSolver`` to 1e-10 relative;
* the host path through ``solve()`` (a plain time-dependent Parameter,
  chunk size 1; the port of ``tests/test_solver_features.py:83-112``)
  matches ``tdgl_tpu.solve()`` to 1e-10 relative;
* the Neumann term the traced current path scatters on the device equals
  the host's ``np.add.at`` and repeats bit for bit.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.parameter import Parameter as JParameter
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.models import gtdgl_stencil as tgs
from tdgl_tpu_torch.parameter import Parameter as TParameter

torch.set_num_threads(1)

OPTIONS = dict(solve_time=1e9, dt_init=1e-3, adaptive=False, save_every=25,
               dtype="float64", field_units="mT", current_units="uA")


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
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


@pytest.fixture(scope="module")
def devices():
    return {"jax": _transport_device(jtdgl),
            "torch": _transport_device(ttdgl)}


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


# -- sources ------------------------------------------------------------------
def scale_fn(x, y, z, *, t, rate=2.0):
    return 1.0 + rate * t


def test_sources_match_jax_and_trace():
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-3, 3, (2, 50))
    z = 0.5 * np.ones(50)
    pairs = [
        (jtdgl.LinearRamp(tmin=0.1, tmax=0.6, initial=0.2, final=1.5),
         ttdgl.LinearRamp(tmin=0.1, tmax=0.6, initial=0.2, final=1.5)),
        (jtdgl.Scale(scale_fn, rate=3.0), ttdgl.Scale(scale_fn, rate=3.0)),
        (jtdgl.CurrentLoop(current=5.0, radius=2.0, center=(0.5, 0, 1.0)),
         ttdgl.CurrentLoop(current=5.0, radius=2.0, center=(0.5, 0, 1.0))),
        (jtdgl.ConstantField(0.3) * jtdgl.LinearRamp(tmin=0, tmax=1),
         ttdgl.ConstantField(0.3) * ttdgl.LinearRamp(tmin=0, tmax=1)),
        (2.0 * jtdgl.ConstantField(0.3) + jtdgl.Scale(scale_fn),
         2.0 * ttdgl.ConstantField(0.3) + ttdgl.Scale(scale_fn)),
    ]
    for jp, tp in pairs:
        assert tp.time_dependent == jp.time_dependent
        assert tp.jittable == jp.jittable
        for t in (0.0, 0.35, 2.0):
            kw = dict(t=t) if jp.time_dependent else {}
            ref = np.asarray(jp(x, y, z, **kw))
            assert np.array_equal(np.asarray(tp(x, y, z, **kw)), ref)
    # The traced path: tensors in, tensors out, equal to the host values.
    composite = pairs[3][1]
    coords = [torch.from_numpy(c) for c in (x, y, z)]
    for t in (0.0, 0.35, 2.0):
        got = composite.evaluate_traced(*coords,
                                        t=torch.tensor(t, dtype=torch.float64))
        assert isinstance(got, torch.Tensor)
        assert np.array_equal(got.numpy(),
                              np.asarray(pairs[3][0](x, y, z, t=t)))
    ramp = ttdgl.LinearRamp(tmin=0.0, tmax=0.5)
    value = ramp.evaluate_traced(*coords, t=torch.tensor(0.2))
    assert isinstance(value, torch.Tensor) and float(value) == \
        pytest.approx(0.4)
    # Fingerprints and pickling survive the traced evaluation's cache.
    again = pickle.loads(pickle.dumps(composite))
    assert again == composite
    assert again.fingerprint() == composite.fingerprint()
    assert not hasattr(again, "_traced_cache") or not again._traced_cache


# -- traced inputs on the chunk -----------------------------------------------
def jax_current_ramp(t):
    bias = 1.0 + 2.0 * jnp.minimum(t * 5.0, 1.0)
    return dict(source=bias, drain=-bias)


def torch_current_ramp(t):
    bias = 1.0 + 2.0 * torch.clamp(t * 5.0, max=1.0)
    return dict(source=bias, drain=-bias)


class JaxEpsilonRamp:
    """A traced epsilon(r, t) for the JAX package: a dip that deepens."""

    jittable = True

    def __call__(self, r, *, t, vectorized=True):
        return self.evaluate_traced(r[:, 0], r[:, 1], t=t)

    def fingerprint(self):
        return "epsilon-ramp"

    def evaluate_traced(self, x, y, t):
        depth = 0.4 * jnp.clip(t / 0.05, 0.0, 1.0)
        return 1.0 - depth * jnp.exp(-((x + 3.0) ** 2 + y ** 2) / 4.0)


class TorchEpsilonRamp:
    """The same epsilon(r, t) on tensors."""

    jittable = True

    def __call__(self, r, *, t, vectorized=True):
        depth = 0.4 * min(max(float(t) / 0.05, 0.0), 1.0)
        return 1.0 - depth * np.exp(-((r[:, 0] + 3.0) ** 2 + r[:, 1] ** 2)
                                    / 4.0)

    def evaluate_traced(self, x, y, t):
        depth = 0.4 * torch.clamp(t / 0.05, 0.0, 1.0)
        return 1.0 - depth * torch.exp(-((x + 3.0) ** 2 + y ** 2) / 4.0)


def _inputs(case):
    field = 0.5
    currents = {"jax": dict(source=2.0, drain=-2.0),
                "torch": dict(source=2.0, drain=-2.0)}
    eps = {"jax": 1.0, "torch": 1.0}
    if case == "field":
        field = {
            "jax": jtdgl.ConstantField(0.5) * jtdgl.LinearRamp(tmin=0,
                                                               tmax=0.05),
            "torch": ttdgl.ConstantField(0.5) * ttdgl.LinearRamp(tmin=0,
                                                                 tmax=0.05)}
    elif case == "current":
        currents = {"jax": jtdgl.jittable(jax_current_ramp),
                    "torch": ttdgl.jittable(torch_current_ramp)}
    else:
        eps = {"jax": JaxEpsilonRamp(), "torch": TorchEpsilonRamp()}
    if not isinstance(field, dict):
        field = {"jax": field, "torch": field}
    return {pkg: dict(applied_vector_potential=field[pkg],
                      terminal_currents=currents[pkg],
                      disorder_epsilon=eps[pkg])
            for pkg in ("jax", "torch")}


@pytest.fixture(scope="module")
def traced_runs(devices):
    """Each traced case in both packages: 4 chunks of 25 steps from the
    same initial state, with the states after the first chunk (the field
    still ramps then) and at the end."""
    out = {}
    for case in ("field", "current", "epsilon"):
        kw = _inputs(case)
        js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**OPTIONS),
                       **kw["jax"])
        ts = ttdgl.TDGLSolver(devices["torch"],
                              ttdgl.SolverOptions(**OPTIONS),
                              torch_device="cpu", **kw["torch"])
        jstate = js._initial_state()
        tstate = convert.grid_state_to_torch(
            jax.tree.map(np.asarray, jstate), "cpu")
        first = None
        for _ in range(4):
            jstate, jout, jexp = js.chunk_fn(jstate)
            tstate, tout, texp = ts.chunk_fn(tstate)
            first = first or (jstate, tstate)
        out[case] = dict(js=js, ts=ts, jstate=jstate, tstate=tstate,
                         jout=jout, tout=tout, jexp=jexp, texp=texp,
                         first=first)
    return out


@pytest.mark.parametrize("case", ["field", "current", "epsilon"])
def test_traced_ramp_matches_jax(traced_runs, case):
    run = traced_runs[case]
    js, ts = run["js"], run["ts"]
    jstate, tstate = run["jstate"], run["tstate"]
    traced = {"field": "A_fn", "current": "mu_boundary_fn",
              "epsilon": "eps_fn"}[case]
    assert getattr(ts.cfg, traced) is not None
    assert ts.chunk_size == js.chunk_size == 25 and not ts.host_dynamic
    assert int(tstate.step) == int(jstate.step) == 100
    assert not bool(tstate.failed) and not bool(jstate.failed)
    for name in ("psi_r", "psi_i", "mu", "supercurrent", "normal_current",
                 "A_applied", "epsilon", "neumann_term"):
        assert _rel(getattr(tstate, name), getattr(jstate, name)) < 1e-10, \
            name
    assert _rel(run["tout"].mu_probe, run["jout"].mu_probe) < 1e-10
    tarr = ts._state_to_arrays(run["texp"])
    jarr = js._state_to_arrays(jax.tree.map(np.asarray, run["jexp"]))
    assert sorted(tarr) == sorted(jarr)
    # The input really moved during the run.
    moved = {"field": "A_applied", "current": "neumann_term",
             "epsilon": "epsilon"}[case]
    start = getattr(ts._initial_state(), moved)
    assert float((getattr(tstate, moved) - start).abs().max()) > 1e-3


def test_traced_field_ramp_dA_dt(traced_runs):
    """While the field ramps (after the first chunk), dA/dt, from the
    carried applied potential and ``prev_dt``, matches too."""
    jstate, tstate = traced_runs["field"]["first"]
    assert _rel(tstate.dA_dt, jstate.dA_dt) < 1e-10
    assert float(tstate.dA_dt.abs().max()) > 0


# -- the host path ------------------------------------------------------------
def host_ramp_field(x, y, z, *, t, Bz_max, ramp_time):
    scale = float(np.clip(t / ramp_time, 0.0, 1.0))
    A = 0.5 * scale * Bz_max
    return np.stack([-A * y, A * x, np.zeros_like(x)], axis=1)


def test_host_path_solve_matches_jax(devices, tmp_path):
    kwargs = dict(Bz_max=0.5, ramp_time=0.05)
    solutions, solvers = {}, {}
    for name, pkg, param, kw in (
            ("jax", jtdgl, JParameter, {}),
            ("torch", ttdgl, TParameter, {"torch_device": "cpu"})):
        options = pkg.SolverOptions(
            solve_time=0.08, dt_init=1e-3, adaptive=False, save_every=40,
            dtype="float64", field_units="mT", current_units="uA",
            output_file=str(tmp_path / f"{name}.h5"))
        solver = pkg.TDGLSolver(
            devices[name], options,
            applied_vector_potential=param(host_ramp_field,
                                           time_dependent=True, **kwargs),
            terminal_currents=dict(source=2.0, drain=-2.0), **kw)
        solvers[name] = solver
        solutions[name] = solver.solve()
    assert solvers["torch"].host_dynamic and solvers["torch"].chunk_size == 1
    j, t = solutions["jax"], solutions["torch"]
    assert len(t.dynamics.dt) == len(j.dynamics.dt) == 81
    assert t.data_range == j.data_range
    for name in ("psi", "mu", "supercurrent", "applied_vector_potential"):
        assert _rel(getattr(t.tdgl_data, name),
                    getattr(j.tdgl_data, name)) < 1e-10, name
    assert _rel(t.dynamics.mu, j.dynamics.mu) < 1e-10
    assert np.abs(t.tdgl_data.applied_vector_potential).max() > 0


# -- the deterministic Neumann term -------------------------------------------
def test_neumann_term_equals_add_at_and_repeats(devices):
    ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**OPTIONS),
                          terminal_currents=dict(source=3.0, drain=-3.0),
                          torch_device="cpu")
    rng = np.random.default_rng(9)
    n_b = len(devices["torch"].mesh.edge_mesh.boundary_edge_indices)
    for mu_b in (ts._mu_boundary(0.0), rng.normal(size=n_b)):
        ref = ts._host_neumann_term(mu_b)
        got = [tgs.neumann_boundary_term(ts.sten, torch.from_numpy(mu_b))
               for _ in range(3)]
        assert np.abs(got[0].numpy() - ref).max() <= 1e-15 * np.abs(ref).max()
        assert all(torch.equal(got[0], g) for g in got[1:])
        assert np.abs(ref).max() > 0
