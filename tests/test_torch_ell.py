"""The unstructured (ELL) backend of the port against the JAX package.

Both packages mesh the same small transport film with the default
(Delaunay) mesher: ~400 sites, a hole, a source and a drain terminal and
two probes. The same host-built inputs go through both packages:

* ``build_operators`` and ``build_amg`` are equal field by field, and the
  AMG restriction table lists every aggregate's members in site order;
* every function of ``models/gtdgl.py`` matches ``tdgl_tpu.models.gtdgl``
  to 1e-13 relative in float64 on seeded inputs (``ok`` too, on a passing
  and on a failing dt);
* ``solve_mu_poisson`` with Jacobi and with the two-level AMG, in its
  tolerance-stopped, fixed and top-up forms, matches with equal iteration
  counts: to 1e-13 with AMG and for fixed counts; the Jacobi
  tolerance-stopped forms run ~100 iterations, over which the two
  packages' reduction orders part to 1e-8 relative (stated below);
* a chunk of the port's ``TDGLSolver`` from the JAX initial state matches
  the JAX chunk to 1e-10 in float64 over 20 steps with equal dt sequences
  (1e-10 relative), retries and CG and screening iteration counts: static
  inputs with the adaptive dt, a forced discriminant retry, a traced field
  and current ramp, the host path (chunk size 1) and a screened (``xla``)
  chunk; float32 holds to the pins stated in its test;
* the port's ``solve()`` matches ``tdgl_tpu.solve()`` snapshot for
  snapshot (float64, 1e-10), its file loads with
  ``tdgl_tpu.Solution.from_hdf5``, and its ``checkpoint`` group has the
  JAX file's keys and attributes (``backend`` ``"ell"``);
* ``convert.solver_state_to_torch`` takes the JAX state or its
  ``export_state_arrays`` dict;
* the port resumes the ``checkpoint`` of the JAX package's ``solve()`` file
  20 steps on, and agrees with its resume of its own file to 1e-10 with
  equal steps; the JAX file loads in the port with the JAX package's
  fields and seeds a port ``solve()``.

Past about 20 adaptive steps the adaptive dt of this small film oscillates
(0.003 <-> 0.06) and amplifies rounding differences by ~10x per step in
both packages alike, so the chunks stop at 20 steps.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.fv.operators import build_operators as j_build_operators
from tdgl_tpu.models import gtdgl as jg
from tdgl_tpu.ops.amg import build_amg as j_build_amg
from tdgl_tpu.ops.cg import solve_mu_poisson as j_solve_mu
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.fv.operators import build_operators as t_build_operators
from tdgl_tpu_torch.models import gtdgl as tg
from tdgl_tpu_torch.ops.amg import build_amg as t_build_amg
from tdgl_tpu_torch.ops.cg import solve_mu_poisson as t_solve_mu

torch.set_num_threads(1)

CURRENTS = dict(source=3.0, drain=-3.0)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS and OpenMP thread: the AMG set-up's dense pseudo-inverse
    (numpy's OpenBLAS) otherwise spins eight threads on a CPU the other
    test workers keep busy."""
    with threadpool_limits(limits=1):
        yield


def _transport_device(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(14, 8)).resample(120)
    hole = pkg.Polygon("hole", points=pkg.circle(1.0, center=(2, 1)))
    source = pkg.Polygon("source", points=pkg.box(1, 6, center=(-7, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, 6, center=(7, 0)))
    device = pkg.Device("tr", layer=layer, film=film, holes=[hole],
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=300)
    return device


@pytest.fixture(scope="module")
def devices():
    out = {"jax": _transport_device(jtdgl), "torch": _transport_device(ttdgl)}
    assert out["jax"].mesh.grid is None and out["torch"].mesh.grid is None
    assert np.array_equal(out["jax"].mesh.sites, out["torch"].mesh.sites)
    return out


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def tables(devices):
    """Both packages' float64 ELL tables and AMG (terminal sites fixed),
    on their devices, and seeded inputs."""
    mesh = devices["torch"].mesh
    fixed = np.concatenate([t.site_indices for t in
                            devices["torch"].terminal_info()]).astype(np.int32)
    out = dict(
        j_host=j_build_operators(devices["jax"].mesh, fixed_sites=fixed,
                                 dtype=np.float64),
        t_host=t_build_operators(mesh, fixed_sites=fixed, dtype=np.float64),
    )
    out["j_amg"] = j_build_amg(out["j_host"], coarsening=16,
                               dtype=np.float64)
    out["t_amg"] = t_build_amg(out["t_host"], coarsening=16,
                               dtype=np.float64)
    out["jop"] = jax.tree.map(jnp.asarray, out["j_host"])
    out["top"] = convert.operators_to_torch(out["t_host"], "cpu")
    out["jamg"] = jax.tree.map(jnp.asarray, out["j_amg"])
    out["tamg"] = convert.amg_to_torch(out["t_amg"], "cpu")
    n, e = len(mesh.sites), len(out["t_host"].edges)
    rng = np.random.default_rng(3)
    out["inputs"] = dict(
        psi=rng.normal(size=(n, 2)) * 0.5,
        A=rng.normal(size=(e, 2)) * 0.3,
        mu=rng.normal(size=n),
        F=rng.normal(size=e),
        mu_b=rng.normal(size=len(out["t_host"].boundary_edge_indices)),
        rhs=rng.normal(size=n),
    )
    return out


def test_build_operators_and_amg_equal_jax(tables):
    j, t = tables["j_host"], tables["t_host"]
    assert t._fields == j._fields
    for field in j._fields:
        a, b = np.asarray(getattr(j, field)), np.asarray(getattr(t, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in tables["j_amg"]._fields:
        a = np.asarray(getattr(tables["j_amg"], field))
        b = np.asarray(getattr(tables["t_amg"], field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    # The restriction table: each aggregate's members, in site order,
    # padded with N; every site exactly once.
    ids = np.asarray(tables["t_amg"].cluster_ids)
    members = tables["tamg"].members.numpy()
    n = len(ids)
    assert sorted(members[members < n].tolist()) == list(range(n))
    for c, row in enumerate(members):
        real = row[row < n]
        assert np.all(np.diff(real) > 0) and np.all(ids[real] == c)
    # Index tables become int64 once, at conversion.
    assert tables["top"].nbr_site.dtype == torch.int64
    assert tables["top"].nbr_edge.dtype == torch.int64


def _pair(tables, name, *args):
    """``gtdgl.<name>`` in both packages on the same host arrays."""
    jf, tf = getattr(jg, name), getattr(tg, name)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    return (jax.jit(lambda *x: jf(tables["jop"], *x))(*jargs)
            if not any(isinstance(a, int) for a in args)
            else jf(tables["jop"], *jargs)), tf(tables["top"], *targs)


@pytest.mark.parametrize("name", [
    "edge_link_phases", "covariant_laplacian", "scalar_laplacian_sym",
    "gradient_on_edges", "supercurrent_on_edges", "divergence_on_sites",
    "neumann_boundary_term", "edge_quantity_to_sites", "poisson_rhs"])
def test_gtdgl_function_matches_jax(tables, name):
    x = tables["inputs"]
    n = len(x["mu"])
    jU = jg.edge_link_phases(jnp.asarray(x["A"]),
                             tables["jop"].edge_directions)
    tU = tg.edge_link_phases(torch.from_numpy(x["A"]),
                             tables["top"].edge_directions)
    if name == "edge_link_phases":
        got, ref = tU, jU
    else:
        U = np.asarray(jU)
        args = {
            "covariant_laplacian": (U, x["psi"]),
            "scalar_laplacian_sym": (x["mu"],),
            "gradient_on_edges": (x["mu"],),
            "supercurrent_on_edges": (U, x["psi"]),
            "divergence_on_sites": (x["F"],),
            "neumann_boundary_term": (x["mu_b"], n),
            "edge_quantity_to_sites": (x["F"], n),
            "poisson_rhs": (x["F"], 0.3 * x["F"], x["mu_b"]),
        }[name]
        ref, got = _pair(tables, name, *args)
    assert _rel(got, ref) < 1e-13
    if name == "neumann_boundary_term":
        # The ordered gather equals the host's np.add.at bit for bit.
        h = tables["t_host"]
        host = np.zeros(n)
        np.add.at(host, h.nbl_rows, h.nbl_vals * x["mu_b"][h.nbl_cols])
        assert np.array_equal(got.numpy(), host)


@pytest.mark.parametrize("dt", [1e-2, 40.0])
def test_implicit_euler_psi_matches_jax(tables, dt):
    """A passing and a failing (``ok`` False) time step."""
    x = tables["inputs"]
    n = len(x["mu"])
    sq = np.sum(x["psi"] ** 2, axis=-1)
    eps = np.ones(n)
    U = np.asarray(jg.edge_link_phases(jnp.asarray(x["A"]),
                                       tables["jop"].edge_directions))
    ref = jax.jit(lambda *a: jg.implicit_euler_psi(
        tables["jop"], *a, 0.5, 5.79, dt))(
        *(jnp.asarray(a) for a in (U, x["psi"], sq, x["mu"], eps)))
    got = tg.implicit_euler_psi(
        tables["top"], *(torch.tensor(a) for a in (U, x["psi"], sq,
                                                   x["mu"], eps)),
        0.5, 5.79, torch.tensor(dt, dtype=torch.float64))
    assert bool(got.ok) == bool(ref.ok) == (dt < 1)
    assert _rel(got.psi, ref.psi) < 1e-13
    assert _rel(got.abs_sq_psi, ref.abs_sq_psi) < 1e-13


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
@pytest.mark.parametrize("form", ["stopped", "fixed", "topup"])
def test_solve_mu_poisson_matches_jax(tables, precond, form):
    x = tables["inputs"]
    fixed_iters, topup = {"stopped": (None, False), "fixed": (3, False),
                          "topup": (2, True)}[form]
    amg = precond == "amg"
    ref = jax.jit(lambda r, m: j_solve_mu(
        tables["jop"], r, m, tol=1e-8, amg=tables["jamg"] if amg else None,
        fixed_iters=fixed_iters, topup=topup))(
        jnp.asarray(x["rhs"]), jnp.asarray(x["mu"]))
    got = t_solve_mu(tables["top"], torch.from_numpy(x["rhs"]),
                     torch.from_numpy(x["mu"]), tol=1e-8,
                     amg=tables["tamg"] if amg else None,
                     fixed_iters=fixed_iters, topup=topup)
    assert int(got.iterations) == int(ref.iterations)
    if precond == "jacobi" and form != "fixed":
        # Jacobi-PCG stopped at 1e-8 takes ~100 iterations on this film,
        # over which the packages' different reduction orders part x to
        # ~1e-9; the final residual (a recurrence at the rounding scale)
        # agrees to a few percent, and both meet the tolerance.
        assert _rel(got.x, ref.x) < 1e-8
        assert float(got.residual_norm) < 1e-8
        assert float(ref.residual_norm) < 1e-8
        assert abs(float(got.residual_norm) / float(ref.residual_norm)
                   - 1.0) < 0.05
    else:
        assert _rel(got.x, ref.x) < 1e-13
        assert abs(float(got.residual_norm) - float(ref.residual_norm)) \
            <= 1e-10 * float(ref.residual_norm)


class HostRamp:
    """Terminal currents as a plain callable (the host path)."""

    def __call__(self, t):
        current = 3.0 * min(float(t) / 0.01, 1.0)
        return {"source": current, "drain": -current}


@ttdgl.jittable
def _torch_ramp(t):
    current = 3.0 * torch.clamp(t / 0.01, 0.0, 1.0)
    return {"source": current, "drain": -current}


@jtdgl.jittable
def _jax_ramp(t):
    current = 3.0 * jnp.clip(t / 0.01, 0.0, 1.0)
    return {"source": current, "drain": -current}


def _case(pkg, case):
    """``(options, inputs)`` of one chunk case for ``pkg``."""
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    inputs = dict(applied_vector_potential=0.5, terminal_currents=CURRENTS)
    if case == "retry":
        # A first step far too large: the discriminant test rejects it
        # and the dt shrinks until it passes.
        opts.update(dt_init=0.5, dt_max=1.0, save_every=10)
    elif case == "traced ramp":
        inputs = dict(
            applied_vector_potential=pkg.ConstantField(0.5)
            * pkg.LinearRamp(tmin=0.0, tmax=0.01),
            terminal_currents=_torch_ramp if pkg is ttdgl else _jax_ramp)
    elif case == "host path":
        opts.update(save_every=1)
        inputs["terminal_currents"] = HostRamp()
    elif case == "screened":
        opts.update(dt_init=1e-4, adaptive=False, save_every=10,
                    include_screening=True, screening_tolerance=1e-4,
                    screening_error_norm="global")
    return opts, inputs


@pytest.mark.parametrize("case", ["static", "retry", "traced ramp",
                                  "host path", "screened"])
def test_ell_chunk_matches_jax(devices, case):
    opts, jin = _case(jtdgl, case)
    _, tin = _case(ttdgl, case)
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts), **jin)
    ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**opts),
                          torch_device="cpu", **tin)
    assert not ts.structured and ts.chunk_size == js.chunk_size
    assert ts.cfg.amg_omega == js.cfg.amg_omega == 0.6
    assert ts.cfg.screening_cg_iters == js.cfg.screening_cg_iters == 32
    assert ts.cfg.poisson_fixed_iters is js.cfg.poisson_fixed_iters is None
    jstate = js._initial_state()
    tstate = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")
    outs = []
    while int(jstate.step) < (10 if case in ("retry", "screened") else 20):
        if case == "host path":
            assert ts.host_dynamic and ts.chunk_size == 1
            jstate = js._host_update(jstate)
            tstate = ts._host_update(tstate)
        jstate, jout, _ = js.chunk_fn(jstate)
        tstate, tout, texp = ts.chunk_fn(tstate)
        outs.append((jout, tout))
    assert int(tstate.step) == int(jstate.step)
    assert not bool(jstate.failed) and not bool(tstate.failed)
    for name in ("psi", "mu", "supercurrent", "normal_current", "A_induced",
                 "A_applied", "mu_boundary", "dpsi_window"):
        assert _rel(getattr(tstate, name), getattr(jstate, name)) < 1e-10, \
            name
    # dA/dt is zero once the ramp ends, up to the JAX program's rounding
    # (~1e-14): measured against the scale of A / dt.
    scale = max(float(np.abs(np.asarray(jstate.A_applied)).max())
                / float(jstate.prev_dt), 1e-300)
    assert np.abs(tstate.dA_dt.numpy()
                  - np.asarray(jstate.dA_dt)).max() < 1e-10 * scale
    for field in ("cg_iterations", "screening_iterations", "valid"):
        for jout, tout in outs:
            assert getattr(tout, field).tolist() == \
                np.asarray(getattr(jout, field)).tolist(), field
    for name in ("dt", "mu_probe", "theta_probe"):
        got = np.concatenate([getattr(t, name).numpy() for _, t in outs])
        ref = np.concatenate([np.asarray(getattr(j, name)) for j, _ in outs])
        assert _rel(got, ref) < 1e-10, name
    dts = np.concatenate([np.asarray(j.dt) for j, _ in outs])
    if case == "retry":
        assert dts[0] < opts["dt_init"]
    if case == "screened":
        its = np.concatenate([np.asarray(j.screening_iterations)
                              for j, _ in outs])
        assert its.max() > 1
        assert float(torch.abs(tstate.A_induced).max()) > 0
    assert _rel(texp["psi_real"], np.asarray(jstate.psi)[:, 0]) < 1e-10


def test_float32_chunk(devices):
    """Float32, default options (adaptive dt, AMG, tolerance-stopped CG at
    1e-4): 20 steps from the JAX initial state. Float32 rounding parts the
    two packages' CG iterates at the 1e-4 stopping tolerance, so the
    pins are those of the structured port's float32 test (psi 5e-4, mu
    5e-3 relative), and the mean CG count agrees to 1 iteration."""
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=20,
                dtype="float32", field_units="mT", current_units="uA")
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts),
                   applied_vector_potential=0.5, terminal_currents=CURRENTS)
    ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**opts),
                          applied_vector_potential=0.5,
                          terminal_currents=CURRENTS, torch_device="cpu")
    jstate = js._initial_state()
    tstate = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")
    jstate, jout, _ = js.chunk_fn(jstate)
    tstate, tout, _ = ts.chunk_fn(tstate)
    assert tstate.psi.dtype == torch.float32
    assert int(tstate.step) == int(jstate.step) == 20
    assert _rel(tstate.psi, jstate.psi) < 5e-4
    assert _rel(tstate.mu, jstate.mu) < 5e-3
    assert abs(float(tout.cg_iterations.float().mean())
               - float(np.mean(jout.cg_iterations))) <= 1.0


@pytest.fixture(scope="module")
def solved(devices, tmp_path_factory):
    """Both packages' ``solve()`` (float64, fixed dt, 61 steps, a
    snapshot every 20)."""
    out = {}
    for name, pkg, kw in (("jax", jtdgl, {}),
                          ("torch", ttdgl, {"torch_device": "cpu"})):
        path = str(tmp_path_factory.mktemp(f"ell_{name}") / "out.h5")
        out[name] = pkg.solve(
            devices[name],
            pkg.SolverOptions(solve_time=0.06, dt_init=1e-3, adaptive=False,
                              save_every=20, dtype="float64",
                              output_file=path, field_units="mT",
                              current_units="uA"),
            applied_vector_potential=0.5, terminal_currents=CURRENTS, **kw)
    return out


def test_solve_matches_jax(solved):
    j, t = solved["jax"], solved["torch"]
    assert t.data_range == j.data_range == (0, 4)
    assert len(t.dynamics.dt) == len(j.dynamics.dt) == 61
    for step in range(j.data_range[0], j.data_range[1] + 1):
        j.solve_step = t.solve_step = step
        assert t.tdgl_data.state["step"] == j.tdgl_data.state["step"]
        for name in ("psi", "mu", "supercurrent", "normal_current"):
            assert _rel(getattr(t.tdgl_data, name),
                        getattr(j.tdgl_data, name)) < 1e-10, (step, name)
    for name in ("dt", "mu", "theta"):
        assert _rel(getattr(t.dynamics, name),
                    getattr(j.dynamics, name)) < 1e-10, name
    j.solve_step = t.solve_step = -1
    # The port's file loads in the JAX package and in the port.
    loaded = jtdgl.Solution.from_hdf5(t.path)
    assert _rel(loaded.tdgl_data.psi, j.tdgl_data.psi) < 1e-10
    assert ttdgl.Solution.from_hdf5(t.path).equals(t)


def test_checkpoint_group_matches_jax(solved):
    """The ``checkpoint`` group has the JAX file's datasets (same shapes
    and dtypes) and attributes, ``backend`` ``"ell"``: the resume slice
    reads both backends from it."""
    groups = {}
    for name in ("jax", "torch"):
        with h5py.File(solved[name].path, "r") as f:
            grp = f["checkpoint"]
            groups[name] = (
                {k: (grp[k].shape, grp[k].dtype) for k in grp},
                {k: grp.attrs[k] for k in grp.attrs},
                {k: np.asarray(grp[k]) for k in grp})
    (jd, ja, jv), (td, ta, tv) = groups["jax"], groups["torch"]
    assert td == jd
    assert sorted(ta) == sorted(ja)
    assert ta["backend"] == ja["backend"] == "ell"
    assert ta["mesh_fingerprint"] == ja["mesh_fingerprint"]
    assert ta["step"] == ja["step"]
    for k in ("time", "prev_dt", "tentative_dt"):
        assert abs(ta[k] - ja[k]) <= 1e-12 * abs(ja[k]), k
    for k in ("psi", "mu", "mu_boundary", "A_applied"):
        assert _rel(tv[k], jv[k]) < 1e-10, k


def test_solver_state_converter_takes_export_dict(devices):
    """``convert.solver_state_to_torch`` on the JAX chunk's
    ``export_state_arrays`` dict (with a template for the fields an
    export lacks) gives the same state as on the JAX ``SolverState``."""
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=5,
                dtype="float64", field_units="mT", current_units="uA")
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts),
                   applied_vector_potential=0.5, terminal_currents=CURRENTS)
    jstate, _, exported = js.chunk_fn(js._initial_state())
    direct = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")
    with pytest.raises(ValueError, match="template"):
        convert.solver_state_to_torch(exported, "cpu")
    from_export = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, exported), "cpu", template=direct)
    for name in direct._fields:
        a, b = getattr(from_export, name), getattr(direct, name)
        if name in ("time", "prev_dt", "tentative_dt"):
            # The export's diagnostics are float32.
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)), name
        else:
            assert torch.equal(a, b), name
    assert int(from_export.step) == 5 and from_export.psi.shape[-1] == 2


def test_resume_and_seed_from_jax_file(solved, tmp_path):
    """Both packages' files of ``solved`` resumed by the port 20 fixed
    steps on agree to 1e-10 with equal steps; the JAX file loads in the
    port with the JAX package's fields and seeds a port run."""
    device = solved["torch"].device
    kw = dict(applied_vector_potential=0.5, terminal_currents=CURRENTS,
              torch_device="cpu")

    def options(solve_time, name):
        return ttdgl.SolverOptions(
            solve_time=solve_time, dt_init=1e-3, adaptive=False,
            save_every=20, dtype="float64",
            output_file=str(tmp_path / name), field_units="mT",
            current_units="uA")

    out = {name: ttdgl.solve(device, options(0.08, f"{name}.h5"),
                             resume_from=solved[name].path, **kw)
           for name in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    assert j.tdgl_data.state["step"] == t.tdgl_data.state["step"] == 81
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        assert _rel(getattr(j.tdgl_data, name),
                    getattr(t.tdgl_data, name)) < 1e-10, name
    ours = ttdgl.Solution.from_hdf5(solved["jax"].path)
    theirs = jtdgl.Solution.from_hdf5(solved["jax"].path)
    for name in ("psi", "mu", "supercurrent", "normal_current",
                 "induced_vector_potential", "applied_vector_potential",
                 "epsilon"):
        assert np.array_equal(getattr(ours.tdgl_data, name),
                              getattr(theirs.tdgl_data, name)), name
    assert ours.tdgl_data.state["time"] == theirs.tdgl_data.state["time"]
    seeded = ttdgl.solve(device, options(0.002, "seeded.h5"),
                         seed_solution=ours, **kw)
    seeded.solve_step = 0
    assert np.array_equal(seeded.tdgl_data.psi, theirs.tdgl_data.psi)
