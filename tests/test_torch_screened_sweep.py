"""Screened batched sweeps: ``tdgl_tpu_torch.parallel.solve_sweep`` with
``include_screening`` against ``tdgl_tpu.parallel.solve_sweep``, on the
CPU, in one process.

* (a) A structured field sweep (the exact FFT convolution) and an ELL field
  sweep (the pairwise ``"xla"`` sum), 0, 300 and 600 uT at float64 over
  0.1 time units, from the same inputs in both packages. The 600 uT member
  fails at step 13 in both (its fixed point does not converge; a single
  run fails there too). ``steps``, ``failed``, ``times`` and the per-step
  screening and CG iteration counts are equal, ``dynamics_dt`` agrees to
  1e-12 and the probe potentials to 1e-10 (the failed member's up to its
  failing step). Every member agrees to 1e-10 relative in ``psi``,
  ``mu``, ``supercurrent``, ``normal_current`` and its member file's
  ``induced_vector_potential``, except the ELL 300 and 600 uT members:
  the dt jump at step 12 gives the first a fixed-point burst of 134
  iterations, and the second ``CAP + 1`` = 141 iterations that do not
  converge, and each amplifies rounding-level differences about 1e6-fold.
  The JAX package itself moves their final states by up to 5.6e-8 when
  their fields are perturbed by 1e-15 relative (the fixture runs that),
  and the port is held to 10 times the package's own response, field by
  field (it sits within 2 times). The fixed point is capped at ``CAP``
  iterations (the default is 1000) to keep the file short: 20 on the box
  film, whose other members take at most 11, and 140 on ELL, above the
  134-iteration burst. The JAX sweeps run once, in a module fixture.
* (b) A 3-member screened batched chunk of the port equals 3 single
  screened robust chunks to 1e-12: ELL (pairwise), structured with the
  exact FFT convolution, with ``screening_site_eval=True``, and with the
  pairwise ``screening_kernel="xla"``.
* (c) The ghost gate: once the 600 uT member has failed it runs no
  fixed-point iteration. Per step slot the port evaluates the induced
  potential (once for the whole batch per iteration) exactly as often as
  the largest iteration count among the live members.
* (d) The per-member reductions (``screening_error``, the Anderson and
  Polyak updates) and the batched induced-potential evaluations (pairwise,
  FFT exact and site-evaluated, the ELL edge-to-site average) equal their
  single-member results, member by member.
* (e) The JAX package's batched screened state, with its per-member
  ``A_induced``, converts into the port's on both backends.
"""

import dataclasses

import h5py
import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.parallel import sweep as jsweep
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.models import gtdgl
from tdgl_tpu_torch.ops import fft_screening as fs
from tdgl_tpu_torch.ops.screening import induced_vector_potential
from tdgl_tpu_torch.parallel import sweep as tsweep
from tdgl_tpu_torch.solver import grid_step
from tdgl_tpu_torch.solver import step as tstep

torch.set_num_threads(1)

FIELDS = np.array([0.0, 300.0, 600.0])
SCALES = np.array([0.5, 1.0, 2.0])
CAP = {"box": 20, "bridge": 140}
FAILED = [False, False, True]


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


FILMS = {"box": _box, "bridge": _bridge}


def _options(pkg, **kw):
    opts = dict(solve_time=0.1, dt_init=1e-4, save_every=50,
                field_units="uT", current_units="uA", dtype="float64",
                include_screening=True, max_iterations_per_step=CAP["box"])
    opts.update(kw)
    return pkg.SolverOptions(**opts)


def _counting(fn, counter):
    def wrapped(*args, **kwargs):
        counter[0] += 1
        return fn(*args, **kwargs)
    return wrapped


def _run(pkg, film, out_dir, fields=FIELDS):
    """One screened field sweep; also returns its per-chunk
    ``StepOutputs`` (host arrays) and, for the port, the induced-potential
    evaluations of each step call (counted until the step's adaptive-dt
    update)."""
    recorded, per_step, evals = [], [], [0]
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

    def window(fn):
        def wrapped(*args, **kwargs):
            per_step.append(evals[0])
            evals[0] = 0
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, record)
        if pkg is ttdgl:
            mp.setattr(fs, "induced_vector_potential_fft", _counting(
                fs.induced_vector_potential_fft, evals))
            mp.setattr(tstep, "induced_vector_potential", _counting(
                tstep.induced_vector_potential, evals))
            for mod in (grid_step, tstep):
                mp.setattr(mod, "adaptive_window",
                           window(mod.adaptive_window))
        result = module.solve_sweep(
            FILMS[film](pkg), _options(
                pkg, max_iterations_per_step=CAP[film]), max_steps=20000,
            applied_vector_potential=pkg.ConstantField(1.0,
                                                       field_units="uT"),
            field_scales=fields, raise_on_failure=False,
            output_dir=str(out_dir), **extra)
    return result, recorded, per_step


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """(a) Both films' screened field sweeps in both packages, and the JAX
    package's ELL 300 and 600 uT members with their fields perturbed by
    1e-15 relative (its own rounding-level response; the JAX package's
    batched members equal its single runs bit for bit)."""
    runs = {(film, name): _run(pkg, film,
                               tmp_path_factory.mktemp(f"{film}_{name}"))
            for film in FILMS
            for name, pkg in (("jax", jtdgl), ("torch", ttdgl))}
    runs[("bridge", "jax perturbed")] = _run(
        jtdgl, "bridge", tmp_path_factory.mktemp("bridge_perturbed"),
        FIELDS[1:] * (1 + 1e-15))
    return runs


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _steps_of(outputs, name):
    return np.concatenate([np.asarray(getattr(o, name)) for o in outputs],
                          axis=1)


def _induced(solution):
    with h5py.File(solution.path, "r") as f:
        return f["data/0/induced_vector_potential"][()]


@pytest.mark.parametrize("film", list(FILMS))
def test_screened_sweep_matches_jax(sweeps, film):
    """(a) Member by member against the JAX package's screened sweep."""
    j, j_out, _ = sweeps[(film, "jax")]
    t, t_out, _ = sweeps[(film, "torch")]
    np.testing.assert_array_equal(t.values, j.values)
    np.testing.assert_array_equal(t.steps, j.steps)
    np.testing.assert_array_equal(t.times, j.times)
    np.testing.assert_array_equal(t.failed, FAILED)
    np.testing.assert_array_equal(j.failed, FAILED)
    assert t.steps[2] == 13 and np.all(t.steps[:2] > 13)
    assert np.abs(t.dynamics_dt - j.dynamics_dt).max() < 1e-12
    # The per-step screening and CG iteration counts of every valid slot.
    assert len(t_out) == len(j_out)
    valid = _steps_of(j_out, "valid") > 0
    np.testing.assert_array_equal(_steps_of(t_out, "valid") > 0, valid)
    for name in ("screening_iterations", "cg_iterations"):
        np.testing.assert_array_equal(_steps_of(t_out, name)[valid],
                                      _steps_of(j_out, name)[valid])
    its = _steps_of(t_out, "screening_iterations")
    cap = CAP[film]
    assert its[2, 12] == cap + 1 and its[:2][valid[:2]].max() <= cap
    for b in range(len(FIELDS)):
        n = int(t.steps[b]) - int(t.failed[b])
        for name in ("dynamics_mu", "dynamics_theta"):
            assert _rel(getattr(t, name)[b][:, :n],
                        getattr(j, name)[b][:, :n]) < 1e-10, (b, name)
        names = ("psi", "mu", "supercurrent", "normal_current")
        fields = {name: (getattr(t, name)[b], getattr(j, name)[b])
                  for name in names}
        fields["induced"] = (_induced(t.solutions[b]),
                             _induced(j.solutions[b]))
        np.testing.assert_allclose(
            t.solutions[b].tdgl_data.induced_vector_potential,
            fields["induced"][0])
        envelope = {name: 1e-10 for name in fields}
        if film == "bridge" and b > 0:
            # The JAX package's own response to a 1e-15 relative field
            # perturbation, after the burst or the failed fixed point at
            # step 12.
            p = sweeps[("bridge", "jax perturbed")][0]
            np.testing.assert_array_equal(p.steps, j.steps[1:])
            moved = {name: _rel(getattr(p, name)[b - 1], fields[name][1])
                     for name in names}
            moved["induced"] = _rel(_induced(p.solutions[b - 1]),
                                    fields["induced"][1])
            assert max(moved.values()) > 1e-10, moved
            envelope = {name: max(1e-10, 10 * moved[name])
                        for name in fields}
        for name, (got, ref) in fields.items():
            if np.abs(ref).max() > 0:
                assert _rel(got, ref) < envelope[name], (b, name)
            else:
                assert np.abs(got).max() < 1e-12, (b, name)


@pytest.mark.parametrize("film", list(FILMS))
def test_ghost_steps_run_no_fixed_point_iteration(sweeps, film):
    """(c) The port evaluates the induced potential once per iteration
    for the whole batch, and, per step slot, exactly as often as the
    largest iteration count among the live members: once the 600 uT
    member has failed (step 13) it adds none. (The JAX ELL loop does not
    test ``done``, so under ``vmap`` that member would spin ``CAP + 1``
    iterations on every later slot.)"""
    t, t_out, per_step = sweeps[(film, "torch")]
    its = _steps_of(t_out, "screening_iterations")
    valid = _steps_of(t_out, "valid") > 0
    slot_max = np.where(valid, its, 0).max(axis=0)
    live = valid.any(axis=0)
    if film == "box":
        # The structured chunk calls the step at every slot.
        assert len(per_step) == len(slot_max)
        called = slice(None)
    else:
        # The ELL chunk skips a slot once every member is done.
        assert len(per_step) == int(live.sum())
        called = live
    np.testing.assert_array_equal(per_step, slot_max[called])
    after = slice(int(t.steps[2]), int(t.steps.max()))
    cap = CAP[film]
    assert slot_max[after].max() < cap + 1
    assert slot_max[12] == cap + 1 and per_step[12] == cap + 1


def _sweep_chunk(solver, state):
    if solver.structured:
        return solver._raw_chunk_fn(solver.sten, solver.amg, state,
                                    solver._screening)
    return solver._raw_chunk_fn(solver.op, solver._screening, solver.amg,
                                state)


@pytest.mark.parametrize("case", ["ell", "fft", "fft site", "xla"])
def test_screened_batched_chunk_equals_single_chunks(case):
    """(b) One 12-step screened chunk of a 3-member field batch against 3
    single robust chunks, each started from its member's scaled applied
    potential (150, 300 and 600 uT), whose fixed points take different
    iteration counts. The chunk ends before the dt jump at step 12 (index
    12), whose fixed-point burst (~100 iterations) grows the batch's
    rounding-order differences (the multigrid's and AMG's coarse solve is
    one matmul for the batch and a matvec alone) past 1e-12 by step 20 on
    ELL, with equal iteration counts throughout. The two psi components
    are held on the scale of ``|psi|``. The structured ``"xla"`` case sums
    over every padded-grid site pair, so it runs 1 step."""
    extra = {"fft site": dict(screening_site_eval=True),
             "xla": dict(screening_kernel="xla")}.get(case, {})
    film = _bridge if case == "ell" else _box
    solver = ttdgl.TDGLSolver(
        film(ttdgl), _options(ttdgl, save_every=1 if case == "xla" else 12,
                              **extra),
        applied_vector_potential=300.0, torch_device="cpu")
    assert solver.structured == (case != "ell")
    assert solver.cfg.screening_use_fft == case.startswith("fft")
    assert solver.cfg.screening_site_eval == (case == "fft site")
    base = solver._initial_state()
    s = torch.tensor(SCALES, dtype=torch.float64)
    A = base.A_applied[None] * s.reshape((3,) + (1,) * base.A_applied.dim())
    per_member = ("psi_r", "psi_i", "psi", "mu", "mu_prev", "supercurrent",
                  "normal_current", "A_induced", "dpsi_window")
    batch = tsweep._member_axis(base, 3, per_member, {"A_applied": A})
    b_state, b_out, _ = _sweep_chunk(solver, batch)
    its = b_out.screening_iterations
    assert bool((its != its[:1]).any()), its
    for m in range(3):
        state, out, _ = _sweep_chunk(solver, base._replace(A_applied=A[m]))
        psi = (torch.sqrt(state.psi_r**2 + state.psi_i**2) if
               solver.structured else state.psi)
        for name in state._fields:
            ref = getattr(state, name)
            got = getattr(b_state, name)
            got = got[m] if got.dim() > ref.dim() else got
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (m, name)
                continue
            scale = (1.0 if name == "dpsi_window"
                     else float(psi.abs().max()) if name.startswith("psi")
                     else max(float(ref.abs().max()), 1e-300))
            assert float((got - ref).abs().max()) <= 1e-12 * scale, (
                m, name)
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


LAYOUTS = {"grid": (3, 4, 8), "ell": (40,)}


def _fields(layout, seed):
    """Three members' potentials of one layout (x/y pair last), with
    per-member magnitudes that differ by orders."""
    rng = np.random.default_rng(seed)
    shape = (3,) + LAYOUTS[layout] + (2,)
    mag = np.array([1e-3, 1.0, 30.0]).reshape((3,) + (1,) * (len(shape) - 1))
    return [torch.tensor(rng.normal(size=shape) * mag) for _ in range(4)]


@pytest.fixture(scope="module")
def box_solver():
    return ttdgl.TDGLSolver(_box(ttdgl), _options(ttdgl),
                            applied_vector_potential=100.0,
                            torch_device="cpu")


@pytest.mark.parametrize("norm", ["global", "per_edge"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_screening_error_is_per_member(box_solver, layout, norm):
    """(d) ``screening_error`` (with each member's applied-potential scale)
    of a batch equals each member's own."""
    c = dataclasses.replace(box_solver.cfg, screening_global_error_norm=(
        norm == "global"))
    nd = len(LAYOUTS[layout]) + 1
    dA, A, A_app, _ = _fields(layout, 1)
    app = tstep.vector_scale(A_app, nd)
    assert app.shape == (3,)
    err = tstep.screening_error(c, dA, A, app, nd)
    assert err.shape == (3,)
    for m in range(3):
        one = tstep.screening_error(c, dA[m], A[m], tstep.vector_scale(
            A_app[m], nd), nd)
        assert one.dim() == 0
        assert float(abs(err[m] - one)) <= 1e-15 * float(one)


@pytest.mark.parametrize("solver", ["anderson", "polyak"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_induced_potential_update_is_per_member(box_solver, layout,
                                                solver):
    """(d) The fixed point's update of a batch (Anderson's secant
    coefficient from per-member sums; Polyak's heavy ball) equals each
    member's own, at the first and a later iteration."""
    c = dataclasses.replace(box_solver.cfg, screening_anderson=(
        solver == "anderson"))
    nd = len(LAYOUTS[layout]) + 1
    A, A_new, velocity, x_prev = _fields(layout, 2)
    for s in (0, 3):
        got = tstep.induced_potential_update(c, s, A, A_new, velocity,
                                             x_prev, nd)
        for m in range(3):
            one = tstep.induced_potential_update(c, s, A[m], A_new[m],
                                                 velocity[m], x_prev[m], nd)
            for g, r in zip(got, one):
                scale = max(float(r.abs().max()), 1e-300)
                assert float((g[m] - r).abs().max()) <= 1e-14 * scale


@pytest.mark.parametrize("kernel", ["pairwise", "fft", "fft site"])
def test_batched_induced_potential_equals_members(box_solver, kernel):
    """(d) One batched evaluation of the induced potential (three members
    of weighted site currents, zero at masked sites) equals each member's
    single evaluation."""
    sten = box_solver.sten
    weights, fft_data = box_solver._screening
    rng = np.random.default_rng(3)
    valid = sten.valid.to(torch.float64)[..., None]
    Jw = torch.tensor(rng.normal(size=(3,) + tuple(valid.shape[:2]) + (2,)),
                      dtype=torch.float64) * valid * weights[..., None]
    if kernel == "pairwise":
        ec = torch.stack([sten.ec_x, sten.ec_y], dim=-1).reshape(-1, 2)
        xy = torch.stack([sten.site_x, sten.site_y], dim=-1).reshape(-1, 2)

        def evaluate(J):
            return induced_vector_potential(ec, xy, J.reshape(
                J.shape[:-3] + (-1, 2)), block_size=100)
    elif kernel == "fft":
        def evaluate(J):
            return fs.induced_vector_potential_fft(fft_data, sten, J)
    else:
        def evaluate(J):
            return fs.induced_vector_potential_fft_site(
                fft_data, sten, J, box_solver._site_taps)
    got = evaluate(Jw)
    for m in range(3):
        ref = evaluate(Jw[m])
        assert got.shape == (3,) + ref.shape
        assert float((got[m] - ref).abs().max()) <= 1e-13 * float(
            ref.abs().max())


def test_ell_edge_average_is_per_member():
    """(d) ``gtdgl.edge_quantity_to_sites`` of a ``(B, E)`` batch equals
    each member's ``(E,)`` average, bit for bit."""
    solver = ttdgl.TDGLSolver(_bridge(ttdgl), _options(
        ttdgl, include_screening=False), torch_device="cpu")
    op = solver.op
    n = op.areas.shape[0]
    F = torch.tensor(np.random.default_rng(4).normal(
        size=(3, op.edges.shape[0])))
    got = gtdgl.edge_quantity_to_sites(op, F, n)
    assert got.shape == (3, n, 2)
    for m in range(3):
        assert torch.equal(got[m], gtdgl.edge_quantity_to_sites(op, F[m], n))


@pytest.mark.parametrize("film", list(FILMS))
def test_batched_screened_jax_state_converts(film):
    """(e) The JAX package's batched screened state (every field with a
    leading member axis, ``A_induced`` per member) converts into the
    port's, as a state and as an export completed from a batched
    template."""
    from tdgl_tpu.solver.grid_step import export_grid_state_arrays
    from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
    from tdgl_tpu.solver.step import export_state_arrays

    js = JaxSolver(FILMS[film](jtdgl), _options(
        jtdgl, poisson_preconditioner="jacobi"),
        applied_vector_potential=100.0)
    base = jax.tree.map(np.asarray, js._initial_state())
    B = len(SCALES)
    batched = jax.tree.map(
        lambda leaf: np.broadcast_to(leaf, (B,) + leaf.shape), base)
    rng = np.random.default_rng(5)
    A_ind = rng.normal(size=(B,) + base.A_induced.shape) * 1e-3
    batched = batched._replace(
        A_applied=batched.A_applied * SCALES.reshape(
            (B,) + (1,) * base.A_applied.ndim),
        A_induced=A_ind, time=np.asarray(SCALES),
        step=np.arange(B, dtype=np.int32),
        done=np.array([False, True, False]))
    if js.structured:
        to_torch, export = convert.grid_state_to_torch, \
            export_grid_state_arrays
    else:
        to_torch, export = convert.solver_state_to_torch, export_state_arrays
    state = to_torch(batched, "cpu")
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(batched, name)),
                                      err_msg=name)
    exported = jax.tree.map(np.asarray, jax.vmap(export)(batched))
    assert exported["induced_vector_potential"].shape == A_ind.shape
    again = to_torch(exported, "cpu", template=state)
    np.testing.assert_array_equal(again.A_induced.numpy(), A_ind)
    for name in ("A_applied", "mu", "time", "step", "done"):
        np.testing.assert_array_equal(getattr(again, name).numpy(),
                                      getattr(state, name).numpy(),
                                      err_msg=name)
