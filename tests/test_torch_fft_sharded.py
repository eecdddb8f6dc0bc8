"""The pencil-decomposed FFT screening of a row-sharded solve
(``tdgl_tpu_torch.parallel.fft_sharded``) against the whole-grid FFT and
the JAX package's ``parallel.fft_sharded``, on the CPU.

Both packages run on the CPU: JAX on ``jax.devices()[:n]`` (the tests'
virtual devices), the port on ``["cpu"] * n``. Inputs are seeded numpy
arrays.

* Function parity, n = 2 and 4, float64, 1e-12 relative: the port's
  pencil ``eval_fn`` on row blocks (the solver's uneven layout of 8-row
  tiles) and on a whole tensor (equal blocks), against the port's
  whole-grid ``induced_vector_potential_fft`` and against JAX's
  ``make_sharded_fft_screening`` with ``pad_fft_data_for_sharding``. The
  kernel spectra are the ``rfft2`` of a seeded real kernel.
* Padding: ``cpad`` equals JAX's ``_cpad``, each shard holds ``cpad / n``
  bins on its device, the shards equal JAX's padded spectra and the pad
  is zero.
* No decomposition: both packages return None for ``Rp % n != 0`` (Rp =
  40 over 3) and for one device; a screened solver on a 32-row grid
  sharded over 3 blocks logs the JAX warning, keeps the gathered form and
  matches its unsharded chunk to 1e-8 (psi and the induced potential, 2
  steps).
* Site evaluation: a sharded screened chunk with
  ``screening_site_eval=True`` runs the exact edge-class convolution
  (``screening_eval_fn`` ahead of the site form) in both packages: the
  port's and the JAX package's sharded chunks against the port's
  unsharded exact chunk to 1e-8, where the site form differs by ~1e-4.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.ops import fft_screening as jfs
from tdgl_tpu.parallel import fft_sharded as jsharded
from tdgl_tpu.parallel import spatial as jspatial
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import testing
from tdgl_tpu_torch.ops import fft_screening as fs
from tdgl_tpu_torch.ops import rowblocks
from tdgl_tpu_torch.parallel import (fft_sharded, shard_solver_spatially,
                                     spatial_device_mesh)

torch.set_num_threads(1)

RP, CP = 40, 40


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for this module's solver set-ups (see
    ``tests/test_torch_solve.py``)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_hierarchy():
    """Each package builds the film's multigrid hierarchy once."""
    from tdgl_tpu.ops import hexmg as jhexmg
    from tdgl_tpu_torch.solver import solver as tsolver

    with testing.one_hierarchy_per_mesh((jhexmg, "build_hexmg"),
                                        (tsolver, "build_hexmg")):
        yield


def _inputs(seed=13):
    """Seeded spectra of a real kernel, an edge mask and a current."""
    rng = np.random.default_rng(seed)
    Ghat = np.fft.rfft2(rng.normal(size=(3, 2 * RP, 2 * CP)), axes=(1, 2))
    G0hat = np.fft.rfft2(rng.normal(size=(2 * RP, 2 * CP)))
    edge_valid = (rng.uniform(size=(3, RP, CP)) > 0.2).astype(np.float64)
    J = rng.normal(size=(RP, CP, 2))
    return Ghat, G0hat, edge_valid, J


def _jax_mesh(n):
    return jspatial.spatial_device_mesh(jax.devices()[:n])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n", [2, 4])
def test_pencil_matches_whole_grid_and_jax(n):
    Ghat, G0hat, edge_valid, J = _inputs()
    fft_data = fs.FFTScreeningData(Ghat=torch.tensor(Ghat),
                                   G0hat=torch.tensor(G0hat))
    sten = types.SimpleNamespace(edge_valid=torch.tensor(edge_valid))
    Jt = torch.tensor(J)
    whole = fs.induced_vector_potential_fft(fft_data, sten, Jt).numpy()

    mesh = spatial_device_mesh(["cpu"] * n)
    eval_fn = fft_sharded.make_sharded_fft_screening(mesh, RP, CP)
    padded = fft_sharded.pad_fft_data_for_sharding(fft_data, n, mesh)
    # Row blocks as the solver holds them (whole 8-row tiles; 40 rows
    # give 24 + 16 over 2 and 16 + 8 + 8 + 8 over 4), and a whole tensor.
    layout = rowblocks.row_layout(RP, mesh.devices)
    got_blocks = eval_fn(padded, types.SimpleNamespace(
        edge_valid=rowblocks.split(sten.edge_valid, layout, -2)),
        rowblocks.split(Jt, layout, -3))
    assert got_blocks.layout == layout and got_blocks.axis == -3
    got_whole = eval_fn(padded, sten, Jt)
    assert [b.shape[-3] for b in got_whole.blocks] == [RP // n] * n

    jmesh = _jax_mesh(n)
    jdata = jfs.FFTScreeningData(Ghat_re=jnp.asarray(Ghat.real),
                                 Ghat_im=jnp.asarray(Ghat.imag))
    jeval = jsharded.make_sharded_fft_screening(jmesh, RP, CP)
    jgot = np.asarray(jeval(
        jsharded.pad_fft_data_for_sharding(jdata, n, jmesh),
        types.SimpleNamespace(edge_valid=jnp.asarray(edge_valid)),
        jnp.asarray(J)))
    assert _rel(jgot, whole) < 1e-12
    for got in (got_blocks, got_whole):
        got = rowblocks.gather(got)
        assert got.dtype == torch.float64 and got.shape == (3, RP, CP, 2)
        assert _rel(got, whole) < 1e-12
        assert _rel(got, jgot) < 1e-12
    # One run only: a leading member axis raises.
    with pytest.raises(ValueError, match="one run"):
        eval_fn(padded, sten, Jt[None])


def test_padded_spectra_match_jax():
    Ghat, G0hat, _, _ = _inputs()
    fft_data = fs.FFTScreeningData(Ghat=torch.tensor(Ghat),
                                   G0hat=torch.tensor(G0hat))
    for n in (2, 3, 4, 5):
        cpad = fft_sharded._cpad(CP, n)
        assert cpad == jsharded._cpad(CP, n)
        assert cpad % n == 0 and CP + 1 <= cpad < CP + 1 + n
        mesh = spatial_device_mesh(["cpu"] * n)
        padded = fft_sharded.pad_fft_data_for_sharding(fft_data, n, mesh)
        assert len(padded.Ghat) == n
        for shard in padded.Ghat:
            assert shard.shape == (3, 2 * RP, cpad // n)
            assert shard.device == torch.device("cpu")
        full = torch.cat(padded.Ghat, dim=-1).numpy()
        assert np.array_equal(full[..., :CP + 1], Ghat)
        assert not full[..., CP + 1:].any()
        assert torch.equal(padded.G0hat, fft_data.G0hat)
        jmesh = _jax_mesh(n)
        jpad = jsharded.pad_fft_data_for_sharding(jfs.FFTScreeningData(
            Ghat_re=jnp.asarray(Ghat.real), Ghat_im=jnp.asarray(Ghat.imag)),
            n, jmesh)
        assert np.array_equal(np.asarray(jpad.Ghat_re), full.real)
        assert np.array_equal(np.asarray(jpad.Ghat_im), full.imag)
        assert (jpad.Ghat_re.addressable_shards[0].data.shape[-1]
                == cpad // n)


def _film(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1)
    film = pkg.Polygon("film", points=pkg.box(8)).resample(250)
    device = pkg.Device("sp", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=300, structured=True)
    return device


SCREENED = dict(solve_time=1e9, dt_init=1e-3, adaptive=False, save_every=2,
                steps_per_chunk=2, dtype="float64", field_units="mT",
                current_units="uA", poisson_tolerance=1e-7,
                include_screening=True, screening_tolerance=1e-4)


def _chunk(solver, mesh=None):
    """One chunk from the initial state (sharded over ``mesh``), its
    export as numpy."""
    state = solver._initial_state()
    if mesh is not None:
        state = shard_solver_spatially(solver, spatial_device_mesh(mesh))(
            state)
    _, _, exported = solver.chunk_fn(state)
    return {k: v.numpy() for k, v in exported.items()}


def _close(got, ref, tol=1e-8):
    scale = np.abs(ref["psi_real"]).max()
    errs = {k: np.abs(got[k] - ref[k]).max() / scale
            for k in ("psi_real", "psi_imag")}
    errs["A"] = _rel(got["induced_vector_potential"],
                     ref["induced_vector_potential"])
    assert np.abs(ref["induced_vector_potential"]).max() > 0
    assert max(errs.values()) < tol, errs
    return errs


def test_no_decomposition_gathers(caplog):
    # 40 rows over 3 devices, and a single device.
    for n in (3, 1):
        mesh = spatial_device_mesh(["cpu"] * n)
        assert fft_sharded.make_sharded_fft_screening(mesh, RP, CP) is None
        assert jsharded.make_sharded_fft_screening(_jax_mesh(n), RP,
                                                   CP) is None

    solver = ttdgl.TDGLSolver(_film(ttdgl), ttdgl.SolverOptions(**SCREENED),
                              applied_vector_potential=0.3,
                              torch_device="cpu")
    assert solver.maps.shape[0] == 32
    ref = _chunk(solver)
    with caplog.at_level(logging.WARNING):
        got = _chunk(solver, ["cpu"] * 3)
    assert "do not pencil-decompose over 3 devices" in caplog.text
    assert solver.cfg.screening_eval_fn is None
    assert isinstance(solver._screening[1].Ghat, torch.Tensor)
    _close(got, ref)


def test_site_eval_runs_the_exact_convolution():
    site = dict(SCREENED, screening_site_eval=True)
    exact = ttdgl.TDGLSolver(_film(ttdgl), ttdgl.SolverOptions(**SCREENED),
                             applied_vector_potential=0.3,
                             torch_device="cpu")
    ref = _chunk(exact)
    solver = ttdgl.TDGLSolver(_film(ttdgl), ttdgl.SolverOptions(**site),
                              applied_vector_potential=0.3,
                              torch_device="cpu")
    assert solver.cfg.screening_site_eval
    approx = _chunk(solver)
    got = _chunk(solver, ["cpu"] * 2)
    assert solver.cfg.screening_eval_fn is not None
    assert len(solver._screening[1].Ghat) == 2
    _close(got, ref)
    # The site form itself is ~1e-4 away: the check can tell them apart.
    assert _rel(approx["induced_vector_potential"],
                ref["induced_vector_potential"]) > 1e-6

    jsolver = JaxSolver(_film(jtdgl), jtdgl.SolverOptions(**site),
                        applied_vector_potential=0.3)
    assert jsolver.cfg.screening_site_eval
    place = jspatial.shard_solver_spatially(jsolver, _jax_mesh(2))
    assert jsolver.cfg.screening_eval_fn is not None
    _, _, jexp = jsolver.chunk_fn(place(jsolver._initial_state()))
    _close(jax.tree.map(np.asarray, jexp), ref)
