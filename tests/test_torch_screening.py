"""Structured screening in the port against the JAX package.

* ``build_fft_screening``'s spectra and ``build_site_interp_taps``'s taps
  equal the JAX package's exactly (float32 and float64).
* The induced potential: ``induced_vector_potential_fft``, the site-
  evaluated form and the pairwise sum against the JAX package's, and the
  FFT path against the pairwise oracle, in float64 at 1e-12 relative and
  in float32 at the pins of ``tests/test_stencil.py:336-557`` (1e-5 for
  the exact paths, 1e-3 for the site-evaluated one against the exact).
* Screened trajectories on the ~700-site transport device, float64 at a
  fixed dt, 10 steps: the robust program (``chunk_failover="off"``) and
  the fast program with failover match ``tdgl_tpu`` to 1e-10 in psi, mu
  and ``A_induced``, with equal screening iterations and failovers; the
  fast chunk program alone, too.
* A float32 screened run with the default options at a fixed dt: psi to
  5e-4 and mu to 5e-3 relative (the pins of
  ``tests/test_torch_grid_step.py``), equal failover counts. The dt is
  fixed because adaptive float32 runs part ways in both packages: their
  fixed-point iteration counts at the float32 tolerance floor differ by
  rounding, and each extra iteration advances psi by another dt (the
  reference's fixed-point semantics).
* The fluxoid quantization check of ``tests/test_solve.py:210-262`` on a
  structured mesh (``solve_time`` cut from 1 to 0.03, the robust program
  only), both packages through ``solve()`` on the same mesh: the port's
  fluxoid errors equal the JAX package's to 1e-6.

This module keeps 7 of the cases, and
``tests/test_torch_screening_runs.py`` holds the others, so that
pytest-xdist's ``--dist loadfile`` queues both files behind the long JAX
files (ROADMAP "Test-time budget"); the other imports this module's
fixtures and helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.fv.stencil_operators import (
    build_stencil_operators as j_build_stencil)
from tdgl_tpu.ops import fft_screening as jfs
from tdgl_tpu.ops.screening import induced_vector_potential as j_pairwise
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.fv.stencil_operators import (
    build_stencil_operators as t_build_stencil)
from tdgl_tpu_torch.ops import fft_screening as tfs
from tdgl_tpu_torch.ops.screening import induced_vector_potential as t_pairwise

torch.set_num_threads(1)


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


def _options(**kw):
    opts = dict(solve_time=1e9, dt_init=1e-4, adaptive=False, save_every=20,
                dtype="float64", field_units="mT", current_units="uA",
                include_screening=True, screening_tolerance=1e-4,
                screening_error_norm="global")
    opts.update(kw)
    return opts


@pytest.fixture(scope="module", params=["float32", "float64"])
def kernels(request, devices):
    """Both packages' stencils and screening data for one dtype, built on
    the host from the same mesh, and seeded currents."""
    dtype = request.param
    npd = np.float32 if dtype == "float32" else np.float64
    out = dict(dtype=dtype, npd=npd)
    for name, build in (("jax", j_build_stencil), ("torch", t_build_stencil)):
        mesh = devices[name].mesh
        host, maps = build(mesh, dtype=npd)
        out[name] = dict(host=host, maps=maps, grid=mesh.grid)
    j, t = out["jax"], out["torch"]
    j["sten"] = jax.tree.map(jnp.asarray, j["host"])
    t["sten"] = convert.stencil_to_torch(t["host"], "cpu")
    j["fft"] = jfs.build_fft_screening(j["host"], j["maps"], j["grid"],
                                      dtype=npd, with_dft=False)
    t["fft"] = tfs.build_fft_screening(t["host"], t["maps"], t["grid"],
                                      dtype=npd)
    for pkg, fs in ((j, jfs), (t, tfs)):
        pkg["taps"] = fs.build_site_interp_taps(pkg["host"], pkg["maps"],
                                                pkg["grid"])
    valid = np.asarray(j["host"].valid)
    rng = np.random.default_rng(5)
    out["Jw"] = (rng.normal(size=valid.shape + (2,))
                 * valid[..., None]).astype(npd)
    # The smooth current of tests/test_stencil.py:537-541.
    Rp, Cp = valid.shape
    yy, xx = np.mgrid[0:Rp, 0:Cp]
    smooth = np.stack(
        [np.sin(2 * np.pi * xx / Cp) * np.cos(2 * np.pi * yy / Rp),
         np.cos(4 * np.pi * xx / Cp) * np.sin(2 * np.pi * yy / Rp)], -1)
    out["smooth"] = (smooth * valid[..., None]).astype(npd)
    return out


def test_build_functions_equal_jax(kernels):
    j, t, npd = kernels["jax"], kernels["torch"], kernels["npd"]
    for name in ("Ghat", "G0hat"):
        got = getattr(t["fft"], name)
        assert got.dtype == np.result_type(npd, np.complex64)
        assert np.array_equal(got.real,
                              np.asarray(getattr(j["fft"], name + "_re")))
        assert np.array_equal(got.imag,
                              np.asarray(getattr(j["fft"], name + "_im")))
    assert t["taps"] == j["taps"] == convert.site_taps(j["taps"])
    assert len(t["taps"]) == 3 and all(len(c) >= 12 for c in t["taps"])


def test_induced_potential_matches_jax(kernels):
    j, t, Jw = kernels["jax"], kernels["torch"], kernels["Jw"]
    f64 = kernels["dtype"] == "float64"
    exact_tol = 1e-12 if f64 else 1e-5
    jd = j["fft"]
    td = convert.fft_screening_to_torch(jd, "cpu")
    assert torch.equal(td.Ghat, torch.from_numpy(t["fft"].Ghat))
    taps, tsten, jsten = t["taps"], t["sten"], j["sten"]
    J_j, J_t = jnp.asarray(Jw), torch.from_numpy(Jw.copy())
    A_fft = tfs.induced_vector_potential_fft(td, tsten, J_t)
    A_fft_j = jax.jit(jfs.induced_vector_potential_fft)(jd, jsten, J_j)
    assert A_fft.dtype == J_t.dtype
    assert _rel(A_fft, A_fft_j) < exact_tol
    A_site = tfs.induced_vector_potential_fft_site(td, tsten, J_t, taps)
    A_site_j = jax.jit(jfs.induced_vector_potential_fft_site,
                       static_argnums=3)(jd, jsten, J_j, j["taps"])
    assert _rel(A_site, A_site_j) < exact_tol
    # The site-evaluated residual for a smooth current: the float32
    # screening floor's order.
    J_s = torch.from_numpy(kernels["smooth"].copy())
    assert _rel(tfs.induced_vector_potential_fft_site(td, tsten, J_s, taps),
                tfs.induced_vector_potential_fft(td, tsten, J_s)) < 1e-3
    # The pairwise oracle (the "xla" kernel), as tests/test_stencil.py
    # builds it (masked sites moved far away), on every 8th real edge.
    hs = t["host"]
    far = 1e6 * (1.0 - np.asarray(hs.valid))
    sites = np.stack([np.asarray(hs.site_x) + far,
                      np.asarray(hs.site_y) + far], -1).reshape(-1, 2)
    ec = np.stack([np.asarray(hs.ec_x), np.asarray(hs.ec_y)],
                  -1).reshape(-1, 2)
    edges = np.flatnonzero(np.asarray(hs.edge_valid).ravel())[::8]
    A_pair = t_pairwise(torch.from_numpy(ec[edges]), torch.from_numpy(sites),
                        J_t.reshape(-1, 2)).numpy()
    A_pair_j = np.asarray(jax.jit(j_pairwise)(
        jnp.asarray(ec[edges]), jnp.asarray(sites), J_j.reshape(-1, 2)))
    assert _rel(A_pair, A_pair_j) < exact_tol
    assert _rel(A_fft.reshape(-1, 2)[edges], A_pair) < exact_tol


@pytest.fixture(scope="module")
def screened_runs(devices):
    """Both packages' screened solvers (float64, fixed dt, 0.5 mT), robust
    and fast with failover, each run for one chunk of 10 steps from the
    same initial state."""
    out = {}
    for failover in ("off", "auto"):
        opts = _options(chunk_failover=failover, save_every=10)
        js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts),
                       applied_vector_potential=0.5)
        ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**opts),
                              applied_vector_potential=0.5,
                              torch_device="cpu")
        jstate, tstate = _start(js)
        jstate, jout, _ = js.chunk_fn(jstate)
        tstate, tout, texp = ts.chunk_fn(tstate)
        out[failover] = dict(
            js=js, ts=ts, jstate=jstate, tstate=tstate, texp=texp,
            j_its=np.asarray(jout.screening_iterations).tolist(),
            t_its=tout.screening_iterations.tolist())
    return out


def _start(js):
    jstate = js._initial_state()
    return jstate, convert.grid_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")


@pytest.mark.parametrize("failover", ["off", "auto"])
def test_screened_trajectory_matches_jax(screened_runs, failover):
    run = screened_runs[failover]
    js, ts = run["js"], run["ts"]
    jstate, tstate = run["jstate"], run["tstate"]
    assert ts.cfg.include_screening and ts.cfg.screening_use_fft
    assert ts.cfg.screening_cg_iters == js.cfg.screening_cg_iters == 8
    # The solver's screening data are the build functions' numbers.
    assert ts._site_taps == convert.site_taps(js._site_taps)
    assert np.array_equal(ts._screening[1].G0hat.real.numpy(),
                          np.asarray(js._screening_weights[1].G0hat_re))
    assert int(tstate.step) == int(jstate.step) == 10
    assert not bool(tstate.failed) and not bool(jstate.failed)
    assert run["t_its"] == run["j_its"] and max(run["t_its"]) > 1
    assert ts._failover_count == getattr(js, "_failover_count", 0)
    for name in ("psi_r", "psi_i", "mu", "A_induced", "supercurrent",
                 "normal_current"):
        assert _rel(getattr(tstate, name), getattr(jstate, name)) < 1e-10, \
            name
    assert float(tstate.A_induced.abs().max()) > 0
    # The exported view carries the induced potential.
    assert np.abs(ts._state_to_arrays(run["texp"])[
        "induced_vector_potential"]).max() > 0


def test_fast_screened_chunk_matches_jax(screened_runs):
    """The fast program alone (one inline fixed-point iteration per step,
    the gates on the device), from the state one chunk in."""
    run = screened_runs["auto"]
    js, ts = run["js"], run["ts"]
    jout = js._fast_chunk_fn(js.sten, js._screening_weights, js.amg,
                             run["jstate"])
    tout = ts._fast_chunk_fn(ts.sten, ts.amg, run["tstate"], ts._screening)
    assert (np.asarray(jout[1].screening_iterations).tolist()
            == tout[1].screening_iterations.tolist() == [1] * 10)
    assert bool(tout[0].failed) == bool(jout[0].failed)
    for name in ("psi_r", "psi_i", "mu", "A_induced"):
        assert _rel(getattr(tout[0], name), getattr(jout[0], name)) < 1e-10
