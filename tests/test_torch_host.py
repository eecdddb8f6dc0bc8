"""The port's jax-free host path builds bit-identical tables.

Both packages mesh the same structured devices and construct a solver;
the stencil tables, grid maps, multigrid hierarchy, full-grid applied
potential and unit scales must be exactly equal (np.array_equal), since
the port carries verbatim copies of the JAX package's host modules.

This module keeps 7 of the cases, and
``tests/test_torch_host_solvers.py`` holds the others, so that
pytest-xdist's ``--dist loadfile`` queues both files behind the long JAX
files (ROADMAP "Test-time budget"); the other imports this module's
fixtures and helpers.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS and OpenMP thread: the multigrid set-up's dense
    pseudo-inverse (numpy's OpenBLAS) otherwise spins eight threads on a
    CPU the other test workers keep busy."""
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


def _box_device(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(10)).resample(100)
    device = pkg.Device("box", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=400, structured=True)
    return device


def _hole_device(pkg):
    """A film with one hole, two terminals and two probe points."""
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(14, 8)).resample(200)
    hole = pkg.Polygon("hole", points=pkg.circle(1.0, center=(2, 1)))
    source = pkg.Polygon("source", points=pkg.box(1, 6, center=(-7, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, 6, center=(7, 0)))
    device = pkg.Device("hole", layer=layer, film=film, holes=[hole],
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=700, structured=True)
    return device


def _options(pkg):
    return pkg.SolverOptions(solve_time=10.0, field_units="mT",
                             current_units="uA", dtype="float32")


CASES = {
    "box": (_box_device, {}),
    "hole_terminals": (_hole_device,
                       dict(terminal_currents=dict(source=2.0,
                                                   drain=-2.0))),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def solvers(request):
    make, kwargs = CASES[request.param]
    jax_solver = JaxSolver(make(jtdgl), _options(jtdgl),
                           applied_vector_potential=0.5, **kwargs)
    torch_solver = ttdgl.TDGLSolver(make(ttdgl), _options(ttdgl),
                                    applied_vector_potential=0.5,
                                    torch_device="cpu", **kwargs)
    return jax_solver, torch_solver


def test_meshes_equal(solvers):
    js, ts = solvers
    assert np.array_equal(js.mesh.sites, ts.mesh.sites)
    assert np.array_equal(js.mesh.elements, ts.mesh.elements)
    assert np.array_equal(js.mesh.areas, ts.mesh.areas)


def test_stencil_operators_equal(solvers):
    js, ts = solvers
    fields = js.host_sten._fields
    assert fields == ts.host_sten._fields and len(fields) == 19
    for name in fields:
        a = np.asarray(getattr(js.host_sten, name))
        b = np.asarray(getattr(ts.host_sten, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # The device copy holds the same values.
    for name in fields:
        assert np.array_equal(np.asarray(getattr(js.host_sten, name)),
                              getattr(ts.sten, name).numpy()), name


def test_grid_maps_equal(solvers):
    js, ts = solvers
    assert js.maps.shape == ts.maps.shape
    assert js.maps.n_sites == ts.maps.n_sites
    assert js.maps.n_edges == ts.maps.n_edges
    assert np.array_equal(js.maps.site_flat, ts.maps.site_flat)
    assert np.array_equal(js.maps.edge_flat, ts.maps.edge_flat)


def test_crossings_test_matches_matplotlib():
    """The port's matplotlib-free containment test classifies interior,
    exterior, vertex and on-edge points exactly as matplotlib does."""
    from matplotlib.path import Path

    from tdgl_tpu_torch.geometry import _crossings_test

    rng = np.random.default_rng(0)
    for poly in (ttdgl.box(10), ttdgl.circle(1.5, center=(2, 2)),
                 np.array([[0, 0], [3, 0], [3, 1], [1, 1], [1, 3], [0, 3.]])):
        poly = np.asarray(poly, float)
        h = 0.25
        r, c = np.meshgrid(np.arange(-60, 60), np.arange(-60, 60),
                           indexing="ij")
        pts = np.vstack([
            rng.uniform(poly.min(0) - 1, poly.max(0) + 1, size=(5000, 2)),
            poly,
            0.5 * (poly + np.roll(poly, -1, axis=0)),
            np.stack([(c + 0.5 * r) * h, r * h * np.sqrt(3) / 2],
                     -1).reshape(-1, 2),
        ])
        ref = Path(np.vstack([poly, poly[:1]])).contains_points(pts)
        assert np.array_equal(_crossings_test(pts, poly), ref)
