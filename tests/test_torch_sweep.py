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
* (e) What the port does not run raises: ``field_scales`` with a
  time-dependent applied potential (which the JAX package runs unscaled
  for every member); so do a batch that does not divide over ``mesh=``
  and a ``mesh`` that is neither a ``DeviceMesh`` nor a device list
  (``tests/test_torch_spatial.py`` runs a sweep over a device list).
  Screened sweeps run: see ``tests/test_torch_screened_sweep.py``.

This module keeps 7 of the cases, and ``tests/test_torch_sweep_*.py``
hold the others, 7 or fewer to a file, so that pytest-xdist's ``--dist
loadfile`` queues each file behind the long JAX files (ROADMAP
"Test-time budget"); they import this module's fixtures and helpers.
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


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def sweep_matches_jax(pair):
    """(a) The port's sweep of a fixture pair against the JAX package's."""
    (j, j_out), (t, t_out) = pair.values()
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


# The current pair's cases of this test and of test_member_files_match_jax
# are in test_torch_sweep_current.py.
@pytest.mark.parametrize("pair", ["field_pair"])
def test_sweep_matches_jax(pair, request):
    sweep_matches_jax(request.getfixturevalue(pair))


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


def test_sweep_validation_and_unported_paths():
    """(c), (e) Exactly one of the scales; a batch that does not divide
    over ``mesh=``, a mesh that is not one, and a time-dependent field
    under ``field_scales`` raise."""
    device = _box(ttdgl)
    options = ttdgl.SolverOptions(solve_time=1)
    with pytest.raises(ValueError):
        tsweep.solve_sweep(device, options, torch_device="cpu")
    with pytest.raises(ValueError):
        tsweep.solve_sweep(device, options, field_scales=[1],
                           current_scales=[1], torch_device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        tsweep.solve_sweep(device, options, field_scales=[1],
                           mesh=["cpu", "cpu"], torch_device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
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


def test_member_devices_of_mesh_none(monkeypatch):
    """(e) ``mesh=None`` splits the members over the visible cards only
    for a plain ``"cuda"``: the largest count that divides B (the JAX
    rule); a named card or the CPU runs the whole batch."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert tsweep._member_devices(None, 4, "cuda") == cuda
    assert tsweep._member_devices(None, 3, "cuda") == [torch.device("cuda")]
    for named in ("cuda:1", "cuda:0", "cpu"):
        assert tsweep._member_devices(None, 4, named) == [
            torch.device(named)]
    assert tsweep._member_devices(["cpu", "cpu"], 4, "cuda:1") == [
        torch.device("cpu")] * 2


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


def member_files_match_jax(pair):
    """(d) Field by field under h5py, to the parity tolerance; each
    package's Solution loads the other's file."""
    (j, _), (t, _) = pair.values()
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


@pytest.mark.parametrize("pair", ["field_pair"])
def test_member_files_match_jax(pair, request):
    member_files_match_jax(request.getfixturevalue(pair))


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
