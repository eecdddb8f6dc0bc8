"""Row sharding of one structured solve
(``tdgl_tpu_torch.parallel.spatial``) and sweeps over a device list, on
the CPU: every shard runs on ``cpu``.

The JAX package's sharded solve is held to its unsharded one by
``tests/test_parallel.py`` on the tests' 8 virtual devices; here the
port's sharded chunk is held to the port's unsharded chunk and to the
JAX package's unsharded chunk, which is cheaper to run. Each
comparison runs one solver unsharded and then sharded, and each package
builds one film's multigrid hierarchy once (a module fixture).

* ``spatial_spec`` equals the JAX function's partition specs.
* The operations ``RowBlocks`` defines for the solver modules (a split
  of an unsharded operand, roll, sum, the zero pad of the rows and its
  windows, the 2x2 restriction and its transpose, a flat index, movedim,
  stack, and the FFT and reshape that gather) equal them on whole
  tensors.
* The refusals of ``tests/test_parallel.py``: a grid too small to give
  every device an 8-row tile raises "REPLICATED" (``allow_replicated``
  runs a chunk on the first device), and an ELL solver raises
  "structured".
* float64 at fixed dt (10 steps) over 4 row blocks, on the 2,500-point
  film of ``test_parallel.py``: against the port's unsharded chunk to
  1e-12
  (only the order of the reductions' partial sums differs; about 3e-13
  observed), and against the JAX unsharded chunk to that test's pins
  (psi 1e-9, mu 1e-7).
* Screening (the FFT convolution as the pencil decomposition of
  ``parallel/fft_sharded.py``: engaged, with each block's spectrum shard
  ``cpad / 2`` bins), 2 steps (51 fixed-point iterations) over 2 row
  blocks of a 300-point film (a 32-row grid): psi and the induced
  potential against the port's unsharded run and against the JAX
  package's sharded chunk on 2 devices to 1e-8 (the pins of
  ``tests/test_parallel.py``).
* Terminals, adaptive dt, float32 (the default fast program with its
  failover), 2 chunks of 20 steps over 2 row blocks, on the bridge of
  ``test_parallel.py`` meshed with 1,281 points instead of 2,672 (a
  (32, 128) grid, whose coarsest multigrid level has 1,024 sites
  instead of 2,048: its dense pseudo-inverse was most of the test's
  time): the same step count, the state still row-sharded, and the mean
  probe voltage of the last chunk within 5e-2 of the unsharded run's.
* ``solve_sweep(mesh=[cpu, cpu])`` equals ``mesh=None`` member by member
  at float64 to 1e-12 relative, with equal steps and times (about 1.4e-13
  observed, not bit for bit: the multigrid's coarsest level is one matrix
  product per batch, whose rounding depends on the number of members; a
  product per member makes the two bitwise equal), and a batch that does
  not divide over the mesh raises.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.parallel import spatial as jspatial
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import testing
from tdgl_tpu_torch.ops import rowblocks
from tdgl_tpu_torch.ops.rowblocks import RowBlocks
from tdgl_tpu_torch.parallel import (shard_solver_spatially, solve_sweep,
                                     spatial_device_mesh, spatial_spec)

torch.set_num_threads(1)

FOUR = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for this module's solver set-ups (see
    ``tests/test_torch_solve.py``)."""
    with threadpool_limits(limits=1):
        yield


def _film(pkg, side=18, min_points=2500):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1)
    film = pkg.Polygon("film", points=pkg.box(side)).resample(250)
    device = pkg.Device("sp", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=min_points, structured=True)
    return device


@pytest.fixture(scope="module", autouse=True)
def one_hierarchy():
    """Each package builds one film's multigrid hierarchy once, with its
    own ``build_hexmg``, for all of its solvers on that film."""
    from tdgl_tpu.ops import hexmg as jhexmg
    from tdgl_tpu_torch.solver import solver as tsolver

    with testing.one_hierarchy_per_mesh((jhexmg, "build_hexmg"),
                                        (tsolver, "build_hexmg")):
        yield


def _runs(device, options, chunks=1, mesh=FOUR, **kwargs):
    """One solver's chunks from its initial state, unsharded and then
    sharded over ``mesh``: ``[(state, outputs, exported), ...]``."""
    solver = ttdgl.TDGLSolver(device, ttdgl.SolverOptions(**options),
                              torch_device="cpu", **kwargs)
    out = []
    for shard in (False, True):
        state = solver._initial_state()
        if shard:
            state = shard_solver_spatially(
                solver, spatial_device_mesh(mesh))(state)
        for _ in range(chunks):
            state, outputs, exported = solver.chunk_fn(state)
        out.append((state, outputs,
                    {k: v.numpy() for k, v in exported.items()}))
    return solver, out


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_spatial_spec_matches_jax():
    from jax.sharding import PartitionSpec as P

    for n_dev in (1, 2, 4, 8):
        for Rp, Cp in ((32, 64), (64, 128), (256, 384), (8, 32)):
            for shape in ((Rp, Cp), (3, Rp, Cp), (3, Rp, Cp, 2),
                          (5, 3, Rp, Cp), (Rp,), (3, Rp), (Cp, Rp),
                          (Rp * Cp, Rp * Cp), ()):
                ref = jspatial.spatial_spec(shape, Rp, Cp, n_dev)
                got = spatial_spec(shape, Rp, Cp, n_dev)
                want = (P() if got is None else
                        P(*[("rows" if i == got else None)
                            for i in range(len(shape))]))
                assert ref == want, (shape, Rp, Cp, n_dev, ref, got)


def test_row_block_ops_match_tensors():
    """The operations ``RowBlocks`` defines so that the solver modules run
    unchanged on row blocks equal them on whole tensors, bit for bit,
    over 3 uneven blocks (sums to 1e-15: their partials add in block
    order)."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(2, 64, 16, dtype=torch.float64, generator=gen)
    w = torch.randn(64, 16, dtype=torch.float64, generator=gen)
    layout = rowblocks.row_layout(64, ["cpu"] * 3)
    xb = rowblocks.split(x, layout, -2)
    g = rowblocks.gather

    def same(got, want):
        assert torch.equal(g(got), want)

    # Elementwise work with an unsharded operand that spans the rows (it
    # splits into the same blocks), the halo-exchanging roll, a sum.
    same(xb * w + 1.0, x * w + 1.0)
    same(torch.roll(xb, (3, -2), dims=(-2, -1)), torch.roll(x, (3, -2),
                                                           dims=(-2, -1)))
    assert abs(float(torch.sum(xb * xb) - torch.sum(x * x))) < 1e-15 * float(
        torch.sum(x * x))
    # The multigrid level stencil: a zero pad of the rows, then windows.
    xp, pp = F.pad(xb, (1, 1, 2, 2)), F.pad(x, (1, 1, 2, 2))
    for r, c in ((0, 0), (2, 1), (4, 2)):
        same(xp[..., r:r + 64, c:c + 16], pp[..., r:r + 64, c:c + 16])
    # The 2x2 restriction onto the coarsened blocks, and its transpose.
    cb = xb.reshape(xb.shape[:-2] + (32, 2, 8, 2)).sum(dim=(-3, -1))
    assert cb.layout == layout.coarsened()
    same(cb, x.reshape(2, 32, 2, 8, 2).sum(dim=(-3, -1)))
    up = torch.repeat_interleave(torch.repeat_interleave(cb, 2, dim=-2), 2,
                                 dim=-1)
    assert up.layout == layout
    same(up, torch.repeat_interleave(torch.repeat_interleave(
        g(cb), 2, dim=-2), 2, dim=-1))
    # Probes: a flat index tensor, read from the blocks that hold it.
    ix = torch.tensor([5, 700, 1023, 0, 383, 384])
    assert torch.equal(xb.flatten(-2)[..., ix], x.flatten(-2)[..., ix])
    # A move of the other dims, a stack with an unsharded tensor, and
    # what gathers: an FFT over the rows and a reshape merging them.
    same(xb.movedim(0, -1), x.movedim(0, -1))
    same(torch.stack([xb, x], dim=-1), torch.stack([x, x], dim=-1))
    assert torch.equal(torch.fft.rfft2(xb, s=(128, 32)),
                       torch.fft.rfft2(x, s=(128, 32)))
    assert torch.equal(xb.reshape(2, -1), x.reshape(2, -1))


def test_refusals():
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1)
    film = ttdgl.Polygon("film", points=ttdgl.box(8)).resample(80)
    device = ttdgl.Device("tiny", layer=layer, film=film,
                          length_units="um")
    device.make_mesh(min_points=150, structured=True)
    options = ttdgl.SolverOptions(solve_time=1.0, dt_init=1e-4,
                                  save_every=10, field_units="mT",
                                  current_units="uA")
    solver = ttdgl.TDGLSolver(device, options,
                              applied_vector_potential=0.05,
                              torch_device="cpu")
    Rp, _ = solver.maps.shape
    mesh = spatial_device_mesh(["cpu"] * 8)
    assert Rp < 8 * 8, "fixture grid unexpectedly large enough to shard"
    with pytest.raises(ValueError, match="REPLICATED"):
        shard_solver_spatially(solver, mesh)
    place = shard_solver_spatially(solver, mesh, allow_replicated=True)
    state = place(solver._initial_state())
    state, outputs, _ = solver.chunk_fn(state)
    assert not isinstance(state.psi_r, RowBlocks)
    assert int(state.step) == 10 and not bool(state.failed)

    device.make_mesh(min_points=150)
    ell = ttdgl.TDGLSolver(device, options, applied_vector_potential=0.05,
                           torch_device="cpu")
    with pytest.raises(ValueError, match="structured"):
        shard_solver_spatially(ell, mesh)


F64 = dict(solve_time=1e9, dt_init=1e-3, adaptive=False, save_every=10,
           steps_per_chunk=10, dtype="float64", field_units="mT",
           current_units="uA", poisson_tolerance=1e-12)


def test_float64_parity_port_and_jax():
    _, ((_, _, a), (st_b, _, b)) = _runs(_film(ttdgl), F64,
                                         applied_vector_potential=0.3)
    assert isinstance(st_b.psi_r, RowBlocks) and len(st_b.psi_r.blocks) == 4
    assert int(b["diagnostics"][3]) == 10 and not b["diagnostics"][5]
    scale = np.abs(a["psi_real"]).max()
    errs = {k: np.abs(a[k] - b[k]).max() / (scale if k.startswith("psi")
                                            else np.abs(a[k]).max())
            for k in ("psi_real", "psi_imag", "mu", "supercurrent")}
    assert max(errs.values()) < 1e-12, errs

    jsolver = JaxSolver(_film(jtdgl), jtdgl.SolverOptions(**F64),
                        applied_vector_potential=0.3)
    _, _, jexp = jsolver.chunk_fn(jsolver._initial_state())
    j = jax.tree.map(np.asarray, jexp)
    jscale = np.abs(j["psi_real"]).max()
    assert np.abs(j["psi_real"] - b["psi_real"]).max() / jscale < 1e-9
    assert np.abs(j["psi_imag"] - b["psi_imag"]).max() / jscale < 1e-9
    assert _rel(b["mu"], j["mu"]) < 1e-7


def test_screened_parity():
    small = _film(ttdgl, side=8, min_points=300)
    options = dict(F64, save_every=2, steps_per_chunk=2,
                   poisson_tolerance=1e-7, include_screening=True,
                   screening_tolerance=1e-4)
    solver, ((_, _, a), (st, _, b)) = _runs(small, options,
                                            mesh=["cpu"] * 2,
                                            applied_vector_potential=0.3)
    assert solver.maps.shape[0] == 32
    assert isinstance(st.A_induced, RowBlocks)
    # The pencil form engaged: both programs evaluate through it, and each
    # block's device holds cpad / 2 bins of the spectra.
    assert solver.cfg.screening_eval_fn is not None
    assert solver._fast_cfg.screening_eval_fn is solver.cfg.screening_eval_fn
    Cp = solver.maps.shape[1]
    cpad = -(-(Cp + 1) // 2) * 2
    shards = solver._screening[1].Ghat
    assert [tuple(t.shape) for t in shards] == [(3, 64, cpad // 2)] * 2
    assert int(b["diagnostics"][3]) == 2 and not b["diagnostics"][5]
    A_a = a["induced_vector_potential"]
    assert np.abs(A_a).max() > 0

    jsolver = JaxSolver(_film(jtdgl, side=8, min_points=300),
                        jtdgl.SolverOptions(**options),
                        applied_vector_potential=0.3)
    place = jspatial.shard_solver_spatially(
        jsolver, jspatial.spatial_device_mesh(jax.devices()[:2]))
    assert jsolver.cfg.screening_eval_fn is not None
    _, _, jexp = jsolver.chunk_fn(place(jsolver._initial_state()))
    j = jax.tree.map(np.asarray, jexp)
    for ref in (a, j):
        scale = np.abs(ref["psi_real"]).max()
        assert np.abs(ref["psi_real"] - b["psi_real"]).max() / scale < 1e-8
        assert np.abs(ref["psi_imag"] - b["psi_imag"]).max() / scale < 1e-8
        assert _rel(b["induced_vector_potential"],
                    ref["induced_vector_potential"]) < 1e-8


def test_terminals_adaptive_float32():
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(40, 20)).resample(400)
    source = ttdgl.Polygon(points=ttdgl.box(2, 20, center=(-19, 0))
                           ).set_name("source")
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = ttdgl.Device("bridge", layer=layer, film=film,
                          terminals=[source, drain],
                          probe_points=[(-12, 0), (12, 0)])
    device.make_mesh(min_points=1200, structured=True)
    options = dict(solve_time=1e9, dt_init=1e-4, dt_max=1e-2,
                   save_every=20, steps_per_chunk=20, dtype="float32",
                   field_units="mT", current_units="uA")
    _, runs = _runs(device, options, chunks=2, mesh=["cpu"] * 2,
                    terminal_currents=dict(source=20, drain=-20))
    (_, out_a, a), (st_b, out_b, b) = runs
    v_a, v_b = (np.abs(mu[:, 0] - mu[:, 1]).mean() for mu in (
        out_a.mu_probe.numpy(), out_b.mu_probe.numpy()))
    assert not a["diagnostics"][5] and not b["diagnostics"][5]
    assert int(a["diagnostics"][3]) == int(b["diagnostics"][3]) == 40
    assert isinstance(st_b.psi_r, RowBlocks)
    assert v_a > 0
    assert abs(v_a - v_b) / v_a < 5e-2, (v_a, v_b)


def test_sweep_over_device_list():
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = ttdgl.Polygon("film", points=ttdgl.box(8)).resample(100)
    device = ttdgl.Device("film", layer=layer, film=film,
                          probe_points=[(-3, 0), (3, 0)])
    device.make_mesh(min_points=300, structured=True)
    options = ttdgl.SolverOptions(solve_time=0.3, dt_init=1e-4,
                                  save_every=25, field_units="uT",
                                  current_units="uA", dtype="float64")
    kwargs = dict(applied_vector_potential=ttdgl.ConstantField(
        1.0, field_units="uT"), field_scales=[0, 200, 400, 600],
        torch_device="cpu")
    one = solve_sweep(device, options, **kwargs)
    two = solve_sweep(device, options, mesh=spatial_device_mesh(
        ["cpu", "cpu"]), **kwargs)
    assert np.array_equal(one.steps, two.steps)
    assert np.array_equal(one.times, two.times)
    for name in ("psi", "mu", "supercurrent", "normal_current",
                 "dynamics_dt", "dynamics_mu"):
        assert _rel(getattr(two, name), getattr(one, name)) < 1e-12, name
    with pytest.raises(ValueError, match="divide"):
        solve_sweep(device, options, mesh=["cpu"] * 3, **kwargs)
