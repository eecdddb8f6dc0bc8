"""Batched parameter sweeps: ``tdgl_tpu_torch.parallel.solve_sweep`` against
``tdgl_tpu.parallel.solve_sweep``, on the CPU, in one process.

* (a) A structured field sweep and an ELL callable-bias current sweep, 3
  members each at float64, from the same inputs in both packages: per
  member ``psi``, ``mu``, ``supercurrent`` and ``normal_current`` agree to
  1e-10 relative, ``dynamics_dt`` to 1e-12, and ``steps``, ``failed``,
  ``times`` and the per-step CG iteration counts are equal. The JAX sweeps
  run once, in module fixtures (the JAX package shards the 3 members over
  3 of the tests' 8 virtual CPU devices). The JAX package's batched
  state (and its export) converts into the port's
  (``convert.grid_state_to_torch``).
* (b) A 3-member batched chunk of the port equals 3 single robust chunks
  to 1e-12, on both backends.
* (c) Mirrors of ``tests/test_parallel.py``'s sweep tests (the field
  sweep without its 8-device assert, the callable bias, the failed
  member, validation, member Solutions with the serial rename and
  ``magnetic_moment``), on films of ~300 sites and shorter times: the
  field sweep runs 1.0 time unit instead of 5 (to 0-600 uT instead of
  0-200 uT, so the strongest member is suppressed as early), the current
  sweep 1.0 instead of 4, the member-Solution sweeps 1.0 instead of 3,
  the failing sweep 20 steps in chunks of 10 instead of 200 in chunks of
  50.
* (d) A port member file read with h5py equals the JAX member file field
  by field, and each package's ``Solution`` loads the other's file.
* (e) What the port does not run raises: ``mesh=`` and ``field_scales``
  with a time-dependent applied potential (which the JAX package runs
  unscaled for every member). Screened sweeps run: see
  ``tests/test_torch_screened_sweep.py``.
"""

import h5py
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.parallel import sweep as jsweep
from tdgl_tpu_torch.parallel import sweep as tsweep

torch.set_num_threads(1)

FIELDS = np.linspace(0, 600, 3)
SCALES = np.linspace(0.5, 2.0, 3)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for this module's solver set-ups (see
    ``tests/test_torch_solve.py``)."""
    with threadpool_limits(limits=1):
        yield


def _box(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = pkg.Polygon("film", points=pkg.box(8)).resample(100)
    device = pkg.Device("film", layer=layer, film=film,
                        probe_points=[(-3, 0), (3, 0)])
    device.make_mesh(min_points=300, structured=True)
    return device


def _bridge(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1,
                      conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(12, 5)).resample(120)
    source = pkg.Polygon(points=pkg.box(0.5, 5, center=(-6, 0))).set_name(
        "source")
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = pkg.Device("bridge", layer=layer, film=film,
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)])
    device.make_mesh(min_points=300, smooth=20)
    return device


def terminal_currents(t):
    bias = 1.0 + 0.5 * min(float(t), 2.0)
    return dict(source=bias, drain=-bias)


def _options(pkg, **kw):
    opts = dict(solve_time=1.0, dt_init=1e-4, save_every=50,
                field_units="uT", current_units="uA", dtype="float64")
    opts.update(kw)
    return pkg.SolverOptions(**opts)


def _run(pkg, device, kind, out_dir):
    """One sweep; also returns its per-chunk ``StepOutputs`` (host
    arrays), recorded where each package reads them back."""
    recorded = []
    if pkg is jtdgl:
        module, name, extra = jsweep, "tree_to_numpy", {}
    else:
        module, name, extra = tsweep, "_host_outputs", {"torch_device":
                                                        "cpu"}
    original = getattr(module, name)

    def record(tree):
        out = original(tree)
        if hasattr(out, "cg_iterations"):
            recorded.append(out)
        return out

    if kind == "field":
        args = dict(applied_vector_potential=pkg.ConstantField(
            1.0, field_units="uT"), field_scales=FIELDS)
        options = _options(pkg)
    else:
        args = dict(terminal_currents=terminal_currents,
                    current_scales=SCALES)
        options = _options(pkg, dt_max=1e-2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, record)
        result = module.solve_sweep(device, options, max_steps=20000,
                                    output_dir=str(out_dir), **args,
                                    **extra)
    return result, recorded


@pytest.fixture(scope="module")
def field_pair(tmp_path_factory):
    """(a) The structured field sweep in both packages."""
    return {name: _run(pkg, _box(pkg), "field",
                       tmp_path_factory.mktemp(f"field_{name}"))
            for name, pkg in (("jax", jtdgl), ("torch", ttdgl))}


@pytest.fixture(scope="module")
def current_pair(tmp_path_factory):
    """(a) The ELL callable-bias current sweep in both packages."""
    return {name: _run(pkg, _bridge(pkg), "current",
                       tmp_path_factory.mktemp(f"current_{name}"))
            for name, pkg in (("jax", jtdgl), ("torch", ttdgl))}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("pair", ["field_pair", "current_pair"])
def test_sweep_matches_jax(pair, request):
    (j, j_out), (t, t_out) = request.getfixturevalue(pair).values()
    np.testing.assert_array_equal(t.values, j.values)
    np.testing.assert_array_equal(t.steps, j.steps)
    np.testing.assert_array_equal(t.failed, j.failed)
    np.testing.assert_array_equal(t.times, j.times)
    assert np.all(t.steps > 0) and not np.any(t.failed)
    for b in range(len(j.values)):
        for name in ("psi", "mu", "supercurrent", "normal_current"):
            ref = getattr(j, name)[b]
            if np.abs(ref).max() > 0:
                assert _rel(getattr(t, name)[b], ref) < 1e-10, (b, name)
            else:
                assert np.abs(getattr(t, name)[b]).max() < 1e-12, (b, name)
    assert np.abs(t.dynamics_dt - j.dynamics_dt).max() < 1e-12
    for name in ("dynamics_mu", "dynamics_theta"):
        assert _rel(getattr(t, name), getattr(j, name)) < 1e-10, name
    # The per-step CG iteration counts of every valid slot.
    assert len(t_out) == len(j_out)
    for to, jo in zip(t_out, j_out):
        np.testing.assert_array_equal(to.valid, np.asarray(jo.valid))
        valid = np.asarray(jo.valid) > 0
        np.testing.assert_array_equal(to.cg_iterations[valid],
                                      np.asarray(jo.cg_iterations)[valid])
    np.testing.assert_allclose(t.mean_voltages(), j.mean_voltages(),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("backend", ["grid", "grid traced A", "ell"])
def test_batched_chunk_equals_single_chunks(backend):
    """(b) One 20-step chunk of a 3-member batch against 3 single robust
    chunks, each started from its member's input: the scaled applied
    potential (grid), the scaled boundary currents (ELL), or, with a
    traced ramp of the applied potential, its own start time (each member
    evaluates A(t) at its own time). (The batch sums its dot products per
    member and does one matmul for all members' coarse solves where a
    single run does a matvec: rounding-order differences that grow, on the
    grid at the largest dt, to ~3e-12 by step 37.)"""
    if backend == "grid":
        solver = ttdgl.TDGLSolver(
            _box(ttdgl), _options(ttdgl, save_every=20),
            applied_vector_potential=100.0, torch_device="cpu")
        field = "A_applied"
    elif backend == "grid traced A":
        ramp = (ttdgl.ConstantField(300.0, field_units="uT")
                * ttdgl.LinearRamp(tmin=0, tmax=0.05))
        solver = ttdgl.TDGLSolver(
            _box(ttdgl), _options(ttdgl, save_every=20),
            applied_vector_potential=ramp, torch_device="cpu")
        assert solver.cfg.A_fn is not None
        field = "time"
    else:
        solver = ttdgl.TDGLSolver(
            _bridge(ttdgl), _options(ttdgl, dt_max=1e-2, save_every=20),
            terminal_currents=terminal_currents(0.0), torch_device="cpu")
        field = "mu_boundary"
    base = solver._initial_state()
    s = torch.tensor(SCALES, dtype=torch.float64)
    if field == "time":
        # Each member at its own time, with its own A(t) in the state.
        t0 = 0.01 * (s - s[0])
        start = {"time": t0, "A_applied": torch.stack(
            [solver.cfg.A_fn(t) for t in t0])}
    else:
        start = {field: getattr(base, field)[None] * s.reshape(
            (3,) + (1,) * getattr(base, field).dim())}
    per_member = ("psi_r", "psi_i", "psi", "mu", "mu_prev", "supercurrent",
                  "normal_current", "dpsi_window")
    batch = tsweep._member_axis(base, 3, per_member, start)
    if solver.structured:
        def chunk(st):
            return solver._raw_chunk_fn(solver.sten, solver.amg, st, None)
    else:
        def chunk(st):
            return solver._raw_chunk_fn(solver.op, None, solver.amg, st)
    b_state, b_out, _ = chunk(batch)
    for m in range(3):
        state, out, _ = chunk(base._replace(
            **{k: v[m] for k, v in start.items()}))
        for name in state._fields:
            ref = getattr(state, name)
            got = getattr(b_state, name)
            got = got[m] if got.dim() > ref.dim() else got
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (m, name)
                continue
            # The window holds differences of |psi|^2 (<= 1): absolute.
            scale = (1.0 if name == "dpsi_window"
                     else max(float(ref.abs().max()), 1e-300))
            assert float((got - ref).abs().max()) <= 1e-12 * scale, (
                m, name)
        # Probe potentials on the scale of mu, phases absolutely.
        scales = dict(mu_probe=float(state.mu.abs().max()),
                      theta_probe=1.0)
        for name in out._fields:
            ref = getattr(out, name)
            got = getattr(b_out, name)[m]
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (m, name)
                continue
            scale = scales.get(name, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= 1e-12 * scale, (
                m, name)


def test_field_sweep(field_pair):
    """(c) ``test_parallel.py::test_field_sweep_sharded`` on one device."""
    result = field_pair["torch"][0]
    assert result.psi.shape[0] == 3
    assert np.all(result.steps > 0)
    # Zero field: |psi| ~ 1 everywhere. Strong field: suppressed somewhere.
    assert np.abs(result.psi[0]).min() > 0.9
    assert np.abs(result.psi[-1]).min() < 0.85
    # Each member took its own number of steps (adaptive dt is per-member).
    assert len(set(result.steps.tolist())) == 3
    assert result.dynamics_dt.shape[0] == 3
    assert np.all(result.dynamics_dt >= 0)


def test_current_sweep_callable_bias(current_pair):
    """(c) The callable IV-like bias: the probe voltage scales with the
    member's bias."""
    result = current_pair["torch"][0]
    assert result.psi.shape[0] == 3
    assert not np.any(result.failed)
    assert np.all(result.times >= 1.0)
    v = np.abs(result.dynamics_mu[:, 0, :] - result.dynamics_mu[:, 1, :])
    final_v = np.array([
        row[np.flatnonzero(dt > 0)[-1]]
        for row, dt in zip(v, result.dynamics_dt)
    ])
    assert final_v[-1] > 2.0 * final_v[0] > 0


def test_sweep_failed_member_surfaced():
    """(c) A member that cannot converge (fixed dt far too large) is
    reported: raise_on_failure=True raises; False returns per-member
    flags."""
    device = _box(ttdgl)
    options = ttdgl.SolverOptions(
        solve_time=5, dt_init=0.5, dt_max=0.5, adaptive=False,
        save_every=10, field_units="uT", current_units="uA",
    )
    kwargs = dict(
        applied_vector_potential=ttdgl.ConstantField(1.0, field_units="uT"),
        field_scales=np.linspace(100, 400, 4), max_steps=20,
        torch_device="cpu",
    )
    with pytest.raises(RuntimeError, match="failed to converge"):
        tsweep.solve_sweep(device, options, **kwargs)
    result = tsweep.solve_sweep(device, options, raise_on_failure=False,
                                **kwargs)
    assert np.any(result.failed)


def test_sweep_validation_and_unported_paths():
    """(c), (e) Exactly one of the scales; ``mesh=`` and a time-dependent
    field under ``field_scales`` raise."""
    device = _box(ttdgl)
    options = ttdgl.SolverOptions(solve_time=1)
    with pytest.raises(ValueError):
        tsweep.solve_sweep(device, options, torch_device="cpu")
    with pytest.raises(ValueError):
        tsweep.solve_sweep(device, options, field_scales=[1],
                           current_scales=[1], torch_device="cpu")
    with pytest.raises(ValueError, match="Queue 1 item 6"):
        tsweep.solve_sweep(device, options, field_scales=[1],
                           mesh=object(), torch_device="cpu")
    ramp = (ttdgl.ConstantField(1.0, field_units="uT")
            * ttdgl.LinearRamp(tmin=0, tmax=1))
    with pytest.raises(ValueError, match="time-dependent"):
        tsweep.solve_sweep(device, options, applied_vector_potential=ramp,
                           field_scales=[1, 2], torch_device="cpu")
    # The CUDA default raises where there is no card, before any work.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsweep.solve_sweep(device, options, field_scales=[1])


def plain_field(x, y, z):
    """A uniform field's vector potential as a plain (non-Parameter)
    callable of the edge centres."""
    return np.stack([-0.5 * y, 0.5 * x, np.zeros_like(x)], axis=1)


def test_member_solution_of_plain_callable_field(tmp_path):
    """(c) A field sweep of a plain callable: each member's Solution stores
    the callable times its scale (``ScaledApplied``) and reloads it."""
    result = tsweep.solve_sweep(
        _box(ttdgl), _options(ttdgl, solve_time=0.002, dt_init=1e-3,
                              save_every=2),
        applied_vector_potential=plain_field, field_scales=[0.5, 2.0],
        output_dir=str(tmp_path), torch_device="cpu")
    xyz = np.array([[1.0, 2.0, 0.0], [-3.0, 0.5, 0.0]]).T
    for scale, sol in zip((0.5, 2.0), result.solutions):
        reloaded = ttdgl.Solution.from_hdf5(sol.path)
        for applied in (sol.applied_vector_potential,
                        reloaded.applied_vector_potential):
            assert isinstance(applied, tsweep.ScaledApplied)
            np.testing.assert_allclose(applied(*xyz),
                                       scale * plain_field(*xyz))


def test_sweep_member_solutions_structured(field_pair):
    """(c) Member Solutions of the structured field sweep: the final
    fields, the analysis stack, the round trip through the loader."""
    result = field_pair["torch"][0]
    assert result.solutions is not None and len(result.solutions) == 3
    for b, sol in enumerate(result.solutions):
        np.testing.assert_allclose(sol.tdgl_data.psi, result.psi[b])
        np.testing.assert_allclose(sol.tdgl_data.mu, result.mu[b])
        m = sol.magnetic_moment(with_units=False)
        assert np.isfinite(m)
        reloaded = ttdgl.Solution.from_hdf5(sol.path)
        np.testing.assert_allclose(reloaded.tdgl_data.psi, sol.tdgl_data.psi)
    # The strongest member is the most diamagnetic; zero field none.
    moments = [abs(s.magnetic_moment(with_units=False))
               for s in result.solutions]
    assert moments[0] < 1e-6 and moments[-1] > moments[1] > moments[0]


def test_sweep_member_solutions_ell_and_rename(current_pair, tmp_path):
    """(c) Member Solutions of the ELL current sweep (the scaled callable
    bias is stored), and a second sweep into the same directory is
    serial-renamed, not lost."""
    result = current_pair["torch"][0]
    for b, sol in enumerate(result.solutions):
        np.testing.assert_allclose(sol.tdgl_data.psi, result.psi[b])
        assert len(sol.dynamics.time) == result.steps[b]
        tc = sol.terminal_currents(0.0)
        assert tc["source"] == pytest.approx(1.0 * result.values[b])
        assert np.isfinite(sol.magnetic_moment(with_units=False))
    device = result.solutions[0].device
    kwargs = dict(terminal_currents=dict(source=1.0, drain=-1.0),
                  current_scales=[1.0, 2.0], max_steps=40,
                  output_dir=str(tmp_path), torch_device="cpu")
    options = _options(ttdgl, solve_time=0.01, dt_max=1e-2)
    first = tsweep.solve_sweep(device, options, **kwargs)
    again = tsweep.solve_sweep(device, options, **kwargs)
    assert len(again.solutions) == 2
    assert again.solutions[0].path != first.solutions[0].path
    assert again.solutions[0].path.endswith("member_000-1.h5")


def _h5_items(path):
    """Every dataset (value) and attribute of a member file, by path,
    except the Solution group and the packages' version_info."""
    items = {}

    def visit(name, obj):
        if name.startswith(("solution", "version_info")):
            return
        for key, value in obj.attrs.items():
            items[f"{name}@{key}"] = value
        if isinstance(obj, h5py.Dataset):
            items[name] = obj[()]

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return items


@pytest.mark.parametrize("pair", ["field_pair", "current_pair"])
def test_member_files_match_jax(pair, request):
    """(d) Field by field under h5py, to the parity tolerance; each
    package's Solution loads the other's file."""
    (j, _), (t, _) = request.getfixturevalue(pair).values()
    for js, ts in zip(j.solutions, t.solutions):
        ji, ti = _h5_items(js.path), _h5_items(ts.path)
        assert sorted(ji) == sorted(ti)
        for key, ref in ji.items():
            got = ti[key]
            if isinstance(ref, (bytes, str)):
                assert got == ref, key
                continue
            ref, got = np.asarray(ref), np.asarray(got)
            assert got.shape == ref.shape and got.dtype == ref.dtype, key
            if ref.dtype.kind in "fc" and np.abs(ref).max(initial=0) > 0:
                assert _rel(got, ref) < 1e-10, key
            else:
                np.testing.assert_array_equal(got, ref, err_msg=key)
        np.testing.assert_allclose(
            jtdgl.Solution.from_hdf5(ts.path).tdgl_data.psi,
            ts.tdgl_data.psi)
        np.testing.assert_allclose(
            ttdgl.Solution.from_hdf5(js.path).tdgl_data.psi,
            js.tdgl_data.psi)


def test_batched_jax_state_converts():
    """(a) ``convert.grid_state_to_torch`` carries the JAX package's batch
    (the vmapped layout: every field with a leading member axis) into the
    port, as a state and as an export (diagnostics ``(B, 6)``) completed
    from a batched template."""
    import jax

    from tdgl_tpu.solver.grid_step import export_grid_state_arrays
    from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
    from tdgl_tpu_torch import convert

    js = JaxSolver(_box(jtdgl), _options(jtdgl, poisson_preconditioner=
                                         "jacobi"),
                   applied_vector_potential=100.0)
    base = jax.tree.map(np.asarray, js._initial_state())
    B = len(SCALES)
    batched = jax.tree.map(
        lambda leaf: np.broadcast_to(leaf, (B,) + leaf.shape), base)
    batched = batched._replace(
        A_applied=batched.A_applied * SCALES[:, None, None, None, None],
        time=np.asarray(SCALES), step=np.arange(B, dtype=np.int32),
        done=np.array([False, True, False]))
    state = convert.grid_state_to_torch(batched, "cpu")
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(batched, name)),
                                      err_msg=name)
    exported = jax.tree.map(np.asarray,
                            jax.vmap(export_grid_state_arrays)(batched))
    assert exported["diagnostics"].shape == (B, 6)
    again = convert.grid_state_to_torch(exported, "cpu", template=state)
    for name in ("psi_r", "psi_i", "mu", "A_applied", "epsilon", "time",
                 "step", "done", "failed", "mu_prev", "dpsi_window"):
        np.testing.assert_array_equal(getattr(again, name).numpy(),
                                      getattr(state, name).numpy(),
                                      err_msg=name)
