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

This module keeps 7 of the cases, and ``tests/test_torch_ell_*.py`` hold
the others, 7 or fewer to a file, so that pytest-xdist's ``--dist
loadfile`` queues each file behind the long JAX files (ROADMAP
"Test-time budget"); they import this module's fixtures and helpers.
"""

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
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.fv.operators import build_operators as t_build_operators
from tdgl_tpu_torch.models import gtdgl as tg
from tdgl_tpu_torch.ops.amg import build_amg as t_build_amg

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


# The last three are the cases of ``test_gtdgl_function_matches_jax`` in
# test_torch_ell_ops.py.
GTDGL_FUNCTIONS = [
    "edge_link_phases", "covariant_laplacian", "scalar_laplacian_sym",
    "gradient_on_edges", "supercurrent_on_edges", "divergence_on_sites",
    "neumann_boundary_term", "edge_quantity_to_sites", "poisson_rhs"]


def gtdgl_function_matches_jax(tables, name):
    """``gtdgl.<name>`` equals the JAX package's on the same inputs."""
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


@pytest.mark.parametrize("name", GTDGL_FUNCTIONS[:6])
def test_gtdgl_function_matches_jax(tables, name):
    gtdgl_function_matches_jax(tables, name)
