"""The port's ``solve()``, Runner and ``Solution`` against the JAX package.

Both packages solve the same small structured transport device (the
~700-site film of ``tests/test_torch_grid_step.py``, with terminals,
probes and a hole), once per module-scoped fixture, and write their
standard output files:

* (a) float64 at a fixed dt (101 steps, ``save_every=25``): every
  snapshot's psi, mu, supercurrent and normal current, and the dynamics'
  dt, mu and theta agree to 1e-10 relative (the same operation order, as
  in the 40-step chunk of ``tests/test_torch_grid_step.py``), with equal
  step and snapshot counts, and ``magnetic_moment``, ``hole_fluxoid``
  and ``mean_voltage`` agree;
* (b) float32 with default options (adaptive dt, failover on), about 60
  steps: the pins of ``tests/test_torch_grid_step.py`` (psi 5e-4, mu 5e-3
  relative) with equal failover counts;
* (c) the port's file opens with h5py and with ``tdgl_tpu.Solution.
  from_hdf5`` and has the JAX file's tree of groups, datasets and
  attributes, with their dtypes and shapes (the ``version_info`` group
  differs by nature, and pickled callables differ in length);
* (d) the failover gate tests of ``tests/test_failover.py:41-86`` and
  ``:205-220`` through the port's ``solve()`` (port against itself), with
  ``solve_time`` cut from 3 to 0.3 and ``save_every`` from 100 to 20;
* (e) a port ``solve()`` (with a thermalization stage) in a process
  where h5py, cloudpickle, tqdm, matplotlib, jax and tdgl_tpu cannot be
  imported;
* (f) the JAX file of (a): h5lite reads it equal to h5py, the port's
  ``Solution.from_hdf5`` loads it with the JAX package's fields, dynamics
  and callables, the port resumes its checkpoint 20 steps on and agrees
  with the port's resume of its own file of (a) to 1e-10 with equal steps,
  and, in a process where jax, tdgl_tpu, h5py and cloudpickle cannot be
  imported, the file loads and seeds a port ``solve()`` without importing
  ``tdgl_tpu``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.ops.hexmg import build_hexmg
from tdgl_tpu_torch.solution.tri_interp import LinearTriInterpolator
from tdgl_tpu_torch.solver import solver as solver_module

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURRENTS = dict(source=5.0, drain=-5.0)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS and OpenMP thread for this module's solves: each solver's
    set-up takes a dense pseudo-inverse (numpy's OpenBLAS), whose eight
    threads spin for seconds on a CPU the other test workers keep busy."""
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


def _solver_pair(tmp_path_factory, tag, **options):
    """Both packages' TDGLSolver, solved, with their Solutions."""
    out = {}
    for name, pkg, kw in (("jax", jtdgl, {}),
                          ("torch", ttdgl, {"torch_device": "cpu"})):
        path = str(tmp_path_factory.mktemp(f"{tag}_{name}") / "out.h5")
        solver = pkg.TDGLSolver(
            _transport_device(pkg),
            pkg.SolverOptions(output_file=path, field_units="mT",
                              current_units="uA", **options),
            applied_vector_potential=0.5, terminal_currents=CURRENTS, **kw)
        out[name] = (solver, solver.solve())
    return out


@pytest.fixture(scope="module")
def f64_pair(tmp_path_factory):
    """(a): the facades ``tdgl_tpu.solve`` and ``tdgl_tpu_torch.solve``."""
    out = {}
    for name, pkg, kw in (("jax", jtdgl, {}),
                          ("torch", ttdgl, {"torch_device": "cpu"})):
        path = str(tmp_path_factory.mktemp(f"f64_{name}") / "out.h5")
        out[name] = pkg.solve(
            _transport_device(pkg),
            pkg.SolverOptions(solve_time=0.1, dt_init=1e-3, adaptive=False,
                              save_every=25, dtype="float64",
                              output_file=path, field_units="mT",
                              current_units="uA"),
            applied_vector_potential=0.5, terminal_currents=CURRENTS, **kw)
    return out


@pytest.fixture(scope="module")
def f32_pair(tmp_path_factory):
    return _solver_pair(tmp_path_factory, "f32", solve_time=0.03,
                        save_every=20)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_float64_snapshots_and_dynamics(f64_pair):
    j, t = f64_pair["jax"], f64_pair["torch"]
    assert t.data_range == j.data_range == (0, 5)
    assert len(t.dynamics.dt) == len(j.dynamics.dt) == 101
    for step in range(j.data_range[0], j.data_range[1] + 1):
        j.solve_step = step
        t.solve_step = step
        assert t.tdgl_data.state["step"] == j.tdgl_data.state["step"]
        for name in ("psi", "mu", "supercurrent", "normal_current"):
            assert _rel(getattr(t.tdgl_data, name),
                        getattr(j.tdgl_data, name)) < 1e-10, (step, name)
    for name in ("dt", "mu", "theta"):
        assert _rel(getattr(t.dynamics, name),
                    getattr(j.dynamics, name)) < 1e-10, name
    j.solve_step = t.solve_step = -1
    assert _rel(t.magnetic_moment(with_units=False),
                j.magnetic_moment(with_units=False)) < 1e-10
    for got, ref in zip(t.hole_fluxoid("hole", with_units=False),
                        j.hole_fluxoid("hole", with_units=False)):
        assert abs(got - ref) < 1e-10 * max(abs(ref), 1.0)
    assert _rel(t.dynamics.mean_voltage(), j.dynamics.mean_voltage()) < 1e-10
    assert _rel(t.current_density.magnitude,
                j.current_density.magnitude) < 1e-10


def _gate_values(solution):
    """The eight post-processing methods of ROADMAP Queue 1 item 4, on a
    solution of the transport film (``length_units`` um)."""
    rng = np.random.default_rng(5)
    inside = rng.uniform([-6, -3], [6, 3], size=(40, 2))
    above = np.stack([np.linspace(-8, 8, 7), np.zeros(7)], axis=1)
    ys = np.linspace(-4, 4, 81)
    centre = np.stack([np.zeros_like(ys), ys], axis=1)
    out = {
        "field_at_position": solution.field_at_position(
            above, zs=1.0, with_units=False),
        "field_at_position vector": solution.field_at_position(
            above, zs=0.5, vector=True, with_units=False),
        "vector_potential_at_position": solution.vector_potential_at_position(
            above, zs=1.0, with_units=False),
        "current_through_path": solution.current_through_path(
            centre, with_units=False),
        "vorticity": solution.vorticity.magnitude,
        "interp_order_parameter": solution.interp_order_parameter(inside),
        "interp_current_density": solution.interp_current_density(
            inside, dataset="supercurrent"),
    }
    xgrid, ygrid, J = solution.grid_current_density(grid_shape=(30, 40))
    out.update(grid_x=xgrid, grid_y=ygrid, grid_J=J)
    for name, phases in solution.boundary_phases(delta=True).items():
        out[f"boundary_phases {name} indices"] = phases.indices
        out[f"boundary_phases {name}"] = phases.phases
    return out


def test_post_processing_gate(f64_pair):
    """ROADMAP Queue 1 item 4's gate: the eight post-processing methods
    agree with the JAX package's on the same run, to 1e-10."""
    ours = _gate_values(f64_pair["torch"])
    theirs = _gate_values(f64_pair["jax"])
    assert sorted(ours) == sorted(theirs)
    for name, ref in theirs.items():
        got, ref = np.asarray(ours[name]), np.asarray(ref)
        nan = np.isnan(ref)     # linear interpolation in the hole
        assert np.array_equal(np.isnan(got), nan), name
        assert _rel(got[~nan], ref[~nan]) < 1e-10, name
    assert abs(ours["current_through_path"]) > 1.0


def test_float32_default_options(f32_pair):
    (js, j), (ts, t) = f32_pair["jax"], f32_pair["torch"]
    assert ts.cfg.factor_link_phases and js.cfg.factor_link_phases
    assert js._failover_count == ts._failover_count >= 1
    assert len(t.dynamics.dt) == len(j.dynamics.dt) >= 50
    assert t.data_range == j.data_range
    assert _rel(t.tdgl_data.psi, j.tdgl_data.psi) < 5e-4
    assert _rel(t.tdgl_data.mu, j.tdgl_data.mu) < 5e-3


def _schema(path):
    """``{name: (kind, dtype, shape)}`` of every group, dataset and
    attribute, apart from the version_info group."""
    out = {}

    def add_attrs(name, obj):
        for key, value in obj.attrs.items():
            value = np.asarray(value)
            kind = value.dtype.kind
            out[f"{name}@{key}"] = ("attr", kind if kind in "OU"
                                    else value.dtype.str, value.shape)

    def visit(name, obj):
        if name.split("/")[0] == "version_info":
            return
        if isinstance(obj, h5py.Dataset):
            dt = obj.dtype
            out[name] = ("dataset", "V" if dt.kind == "V" else dt.str,
                         obj.shape)
        else:
            out[name] = ("group", None, None)
        add_attrs(name, obj)

    with h5py.File(path, "r") as f:
        add_attrs("", f)
        f.visititems(visit)
    return out


def test_output_file_schema_and_readers(f64_pair):
    j, t = f64_pair["jax"], f64_pair["torch"]
    theirs, ours = _schema(j.path), _schema(t.path)
    assert sorted(ours) == sorted(theirs)
    diff = {k: (ours[k], theirs[k]) for k in ours if ours[k] != theirs[k]}
    assert not diff, diff
    with h5py.File(t.path, "r") as f:
        assert "version_info" in f and "checkpoint" in f
        ck = f["checkpoint"]
        assert ck.attrs["backend"] == "grid"
        assert type(ck.attrs["mesh_fingerprint"]) is str
        assert list(f["data"]) == [str(i) for i in range(6)]
    loaded = jtdgl.Solution.from_hdf5(t.path)
    assert loaded.data_range == t.data_range
    assert np.array_equal(loaded.tdgl_data.psi, t.tdgl_data.psi)
    assert np.array_equal(loaded.dynamics.mu, t.dynamics.mu)
    assert loaded.device == j.device
    assert (dataclasses.replace(loaded.options, output_file=None)
            == dataclasses.replace(j.options, output_file=None))
    again = ttdgl.Solution.from_hdf5(t.path)
    assert again.equals(t)
    assert again.applied_vector_potential == t.applied_vector_potential
    assert again.disorder_epsilon == t.disorder_epsilon
    assert again.terminal_currents == CURRENTS
    # A standalone copy (to_hdf5 with a path) reopens in r+ mode.
    copy = os.path.join(os.path.dirname(t.path), "copy.h5")
    t.to_hdf5(copy)
    assert ttdgl.Solution.from_hdf5(copy).equals(t)


def test_linear_interpolation_matches_matplotlib(f64_pair):
    import matplotlib.tri as mtri

    t = f64_pair["torch"]
    device = t.device
    rng = np.random.default_rng(0)
    lo, hi = device.points.min(axis=0) - 1, device.points.max(axis=0) + 1
    xy = rng.uniform(lo, hi, size=(400, 2))
    values = np.abs(t.tdgl_data.psi)
    ours = LinearTriInterpolator(device.points, device.triangles)(
        values, xy[:, 0], xy[:, 1])
    ref = mtri.LinearTriInterpolator(device.triangulation, values)(
        xy[:, 0], xy[:, 1])
    inside = ~np.ma.getmaskarray(ref)
    assert 100 < inside.sum() < len(xy)
    assert np.array_equal(np.isnan(ours), ~inside)
    assert np.abs(ours[inside] - ref.data[inside]).max() < 1e-12


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
    # The four solvers share the device: build the multigrid hierarchy
    # (its coarsest level is a 2048 x 2048 pseudo-inverse) once per dtype.
    built = {}

    def build_once(sten, maps, mesh):
        key = np.asarray(sten.w).dtype
        if key not in built:
            built[key] = build_hexmg(sten, maps, mesh)
        return built[key]

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver_module, "build_hexmg", build_once)
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


# -- (e) no h5py, cloudpickle, tqdm, matplotlib, jax or tdgl_tpu ---------------
_NO_EXTRAS = textwrap.dedent("""
    import sys
    for name in ("h5py", "cloudpickle", "tqdm", "matplotlib", "jax",
                 "tdgl_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import tdgl_tpu_torch as ttdgl

    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(10)).resample(100)
    source = ttdgl.Polygon("source", points=ttdgl.box(1, 4, center=(-5, 0)))
    drain = ttdgl.Polygon("drain", points=ttdgl.box(1, 4, center=(5, 0)))
    device = ttdgl.Device("box", layer=layer, film=film,
                          terminals=[source, drain],
                          probe_points=[(-2, 0), (2, 0)], length_units="um")
    device.make_mesh(min_points=400, structured=True)
    options = ttdgl.SolverOptions(solve_time=0.02, skip_time=0.01,
                                  dt_init=1e-3, save_every=10,
                                  output_file=sys.argv[1],
                                  field_units="mT", current_units="uA")
    kw = dict(applied_vector_potential=0.5,
              terminal_currents=dict(source=2.0, drain=-2.0),
              torch_device="cpu")
    solution = ttdgl.solve(device, options, **kw)
    assert ttdgl.Solution.from_hdf5(solution.path).equals(solution)
    # Thermalization (skip_time) ran first; the clock restarted at 0.
    assert solution.tdgl_data.state["step"] == len(solution.dynamics.dt)
    assert np.isfinite(solution.magnetic_moment(with_units=False))
    assert solution.hole_fluxoid is not None
    try:
        ttdgl.solve(device, options, disorder_epsilon=lambda r: 1.0,
                    **kw)
    except ValueError as exc:
        assert "disorder_epsilon" in str(exc), exc
    else:
        raise AssertionError("a lambda pickled without cloudpickle")
    missing = [m for m in ("h5py", "cloudpickle", "tqdm", "matplotlib",
                           "jax", "tdgl_tpu") if sys.modules.get(m)]
    assert not missing, missing
    print("ok", solution.data_range)
""")


def test_solve_without_optional_packages(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    result = subprocess.run(
        [sys.executable, "-c", _NO_EXTRAS, str(tmp_path / "out.h5")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.strip().startswith("ok"), result.stdout


# -- (f) the JAX package's output file in the port ---------------------------
def _tdgl_fields(data):
    return {f: np.asarray(getattr(data, f))
            for f in ("psi", "mu", "supercurrent", "normal_current",
                      "induced_vector_potential", "applied_vector_potential",
                      "epsilon")}


def test_port_loads_jax_output_file(f64_pair):
    from test_torch_h5 import _assert_same_tree

    path = f64_pair["jax"].path
    _assert_same_tree(path)
    theirs = jtdgl.Solution.from_hdf5(path)
    ours = ttdgl.Solution.from_hdf5(path)
    assert ours.data_range == theirs.data_range == (0, 5)
    for step in (0, 5):
        ours.solve_step = theirs.solve_step = step
        got = _tdgl_fields(ours.tdgl_data)
        want = _tdgl_fields(theirs.tdgl_data)
        for name in want:
            assert np.array_equal(got[name], want[name]), (step, name)
        for key in ("step", "time", "dt"):
            assert ours.tdgl_data.state[key] == theirs.tdgl_data.state[key]
    for name in ("dt", "mu", "theta"):
        assert np.array_equal(getattr(ours.dynamics, name),
                              getattr(theirs.dynamics, name)), name
    assert np.array_equal(ours.times, theirs.times)
    assert (dataclasses.replace(ours.options, output_file=None)
            == dataclasses.replace(f64_pair["torch"].options,
                                   output_file=None))
    assert ours.device == f64_pair["torch"].device
    # The JAX package's pickles load as the port's objects.
    assert ours.applied_vector_potential == ttdgl.ConstantField(
        0.5, field_units="mT", length_units="um")
    assert ours.terminal_currents == CURRENTS
    assert np.array_equal(ours.disorder_epsilon(np.zeros((3, 2))),
                          np.ones(3))


def test_resume_from_jax_checkpoint(f64_pair, tmp_path):
    """The port continues the JAX run as it continues its own run of the
    same fixture: 20 more fixed steps, 1e-10, equal steps."""
    device = f64_pair["torch"].device
    out = {}
    for name in ("jax", "torch"):
        options = ttdgl.SolverOptions(
            solve_time=0.12, dt_init=1e-3, adaptive=False, save_every=25,
            dtype="float64", output_file=str(tmp_path / f"{name}.h5"),
            field_units="mT", current_units="uA")
        out[name] = ttdgl.solve(
            device, options, applied_vector_potential=0.5,
            terminal_currents=CURRENTS, torch_device="cpu",
            resume_from=f64_pair[name].path)
    j, t = out["jax"], out["torch"]
    assert j.tdgl_data.state["step"] == t.tdgl_data.state["step"] == 121
    assert len(j.dynamics.dt) == len(t.dynamics.dt) == 20
    for name, ref in _tdgl_fields(t.tdgl_data).items():
        assert _rel(getattr(j.tdgl_data, name), ref) < 1e-10, name
    for name in ("dt", "mu", "theta"):
        assert _rel(getattr(j.dynamics, name),
                    getattr(t.dynamics, name)) < 1e-10, name


_JAX_FILE_WITHOUT_JAX = textwrap.dedent("""
    import sys
    for name in ("h5py", "cloudpickle", "jax", "tdgl_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import tdgl_tpu_torch as ttdgl

    seed = ttdgl.Solution.from_hdf5(sys.argv[1])
    assert seed.data_range == (0, 5), seed.data_range
    assert seed.terminal_currents == {"source": 5.0, "drain": -5.0}
    assert isinstance(seed.applied_vector_potential, ttdgl.Parameter)
    # The JAX package stored its uniform disorder by value with cloudpickle,
    # which this process lacks: reading it raises, the rest loads.
    try:
        seed.disorder_epsilon
    except RuntimeError as exc:
        assert "cloudpickle" in str(exc), exc
    else:
        raise AssertionError("a cloudpickle stream loaded without it")
    options = ttdgl.SolverOptions(solve_time=0.005, dt_init=1e-3,
                                  adaptive=False, save_every=5,
                                  dtype="float64", output_file=sys.argv[2],
                                  field_units="mT", current_units="uA")
    solution = ttdgl.solve(seed.device, options, applied_vector_potential=0.5,
                           terminal_currents=seed.terminal_currents,
                           seed_solution=seed, torch_device="cpu")
    solution.solve_step = 0
    assert np.array_equal(solution.tdgl_data.psi, seed.tdgl_data.psi)
    assert "tdgl_tpu" not in sys.modules or sys.modules["tdgl_tpu"] is None
    loaded = [m for m in sys.modules if m.startswith("tdgl_tpu.")]
    assert not loaded, loaded
    print("ok", solution.data_range)
""")


def test_jax_file_seeds_without_jax(f64_pair, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    result = subprocess.run(
        [sys.executable, "-c", _JAX_FILE_WITHOUT_JAX, f64_pair["jax"].path,
         str(tmp_path / "seeded.h5")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.strip().startswith("ok"), result.stdout
