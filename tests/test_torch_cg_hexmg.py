"""Parity of the torch multigrid V-cycle and CG solvers with
``tdgl_tpu.ops.hexmg`` / ``tdgl_tpu.ops.cg``.

Both packages get the same hierarchy (built once by the JAX package and
converted), the same seeded ``rhs`` and warm start ``mu_prev``.
Tolerances: 1e-10 relative in float64 (same algorithm and summation order;
the coarsest dense matvec and the reductions round differently); in
float32 the JAX package's own CPU pins of ``tests/test_hexmg.py``: 1e-5
relative for ``level_apply`` and 1e-4 for the V-cycle.

This module keeps 7 of the cases, and
``tests/test_torch_cg_hexmg_mu.py`` holds the others, so that
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
from tdgl_tpu.fv.stencil_operators import build_stencil_operators
from tdgl_tpu.models.gtdgl_stencil import scalar_laplacian_sym as j_lap
from tdgl_tpu.ops import cg as jcg
from tdgl_tpu.ops.hexmg import build_hexmg
from tdgl_tpu.ops.hexmg import level_apply as j_level_apply
from tdgl_tpu.ops.hexmg import make_hexmg_apply as j_make_apply
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.models.gtdgl_stencil import scalar_laplacian_sym as t_lap
from tdgl_tpu_torch.ops import cg as tcg
from tdgl_tpu_torch.ops.hexmg import level_apply as t_level_apply
from tdgl_tpu_torch.ops.hexmg import make_hexmg_apply as t_make_apply

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for this module's set-up: the multigrid's dense
    pseudo-inverse otherwise spins eight OpenBLAS threads on a CPU that
    the other test workers keep busy (see ``tests/test_torch_solve.py``)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def problem():
    layer = jtdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = jtdgl.Polygon("film", points=jtdgl.box(25)).resample(200)
    device = jtdgl.Device("mg", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=3000, structured=True)
    sten64, maps = build_stencil_operators(device.mesh, dtype=np.float64)
    mg = build_hexmg(sten64, maps, device.mesh)
    # At least two stencil levels below the dense coarsest solve.
    assert len(mg.shapes) >= 3
    rng = np.random.default_rng(5)
    valid = np.asarray(sten64.valid)
    return dict(sten64=sten64, maps=maps, mg=mg, valid=valid,
                rhs=rng.normal(size=maps.shape) * valid,
                mu_prev=0.1 * rng.normal(size=maps.shape) * valid)


def _both(problem, dtype):
    npd, td = DTYPES[dtype]
    sten = problem["sten64"]._replace(**{
        f: np.asarray(getattr(problem["sten64"], f)).astype(npd)
        for f in problem["sten64"]._fields
        if np.asarray(getattr(problem["sten64"], f)).dtype.kind == "f"})
    jsten = jax.tree.map(jnp.asarray, sten)
    tsten = convert.stencil_to_torch(sten, "cpu")
    jmg = problem["mg"]
    tmg = convert.hexmg_to_torch(jax.tree.map(np.asarray, jmg), "cpu", td)
    return jsten, tsten, jmg, tmg, npd


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_level_apply(problem, dtype):
    jsten, tsten, jmg, tmg, npd = _both(problem, dtype)
    rng = np.random.default_rng(9)
    tol = 1e-10 if dtype == "float64" else 1e-5
    for lvl in range(len(jmg.shapes) - 1):
        x = rng.standard_normal(jmg.shapes[lvl]).astype(npd)
        got = t_level_apply(tmg, lvl, torch.from_numpy(x))
        ref = j_level_apply(jmg, lvl, jnp.asarray(x))
        assert _rel(got, ref) < tol, lvl


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_v_cycle(problem, dtype):
    jsten, tsten, jmg, tmg, npd = _both(problem, dtype)
    r = problem["rhs"].astype(npd)
    got = t_make_apply(0.8)(tmg, torch.from_numpy(r))
    ref = j_make_apply(0.8)(jmg, jnp.asarray(r))
    assert _rel(got, ref) < (1e-10 if dtype == "float64" else 1e-4)


def _cg_setup(problem):
    jsten, tsten, jmg, tmg, _ = _both(problem, "float64")
    valid = problem["valid"]
    n_valid = float(valid.sum())
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)

    def jproject(v):
        return (v - jnp.sum(v * jv) / n_valid) * jv

    def tproject(v):
        return (v - torch.sum(v * tv) / n_valid) * tv

    japply = j_make_apply(0.8)
    tapply = t_make_apply(0.8)
    jside = dict(apply_A=lambda x: -j_lap(jsten, x),
                 precond=lambda v: japply(jmg, v), project_fn=jproject)
    tside = dict(apply_A=lambda x: -t_lap(tsten, x),
                 precond=lambda v: tapply(tmg, v), project_fn=tproject)
    b = -np.asarray(problem["sten64"].area) * problem["rhs"]
    return jside, tside, b, problem["mu_prev"]


def _check_cg(got, ref):
    assert _rel(got.x, ref.x) < 1e-10
    assert int(got.iterations) == int(ref.iterations)
    # The final residual sits at the stopping tolerance, where rounding
    # differences of ~170 iterations (Jacobi) show at ~1e-7 relative.
    assert abs(float(got.residual_norm) - float(ref.residual_norm)) <= \
        1e-6 * max(float(ref.residual_norm), 1e-30)


@pytest.mark.parametrize("form", ["cg_solve", "cg_solve_fixed",
                                  "cg_solve_topup"])
def test_cg_forms(problem, form):
    jside, tside, b, x0 = _cg_setup(problem)
    extra = dict(cg_solve=dict(tol=1e-9, maxiter=100),
                 cg_solve_fixed=dict(n_iters=3),
                 cg_solve_topup=dict(base_iters=2, tol=1e-9, maxiter=100))[form]
    ref = getattr(jcg, form)(jside["apply_A"], jnp.asarray(b),
                             jnp.asarray(x0), precond=jside["precond"],
                             project_fn=jside["project_fn"], **extra)
    got = getattr(tcg, form)(tside["apply_A"], torch.from_numpy(b),
                             torch.from_numpy(x0), precond=tside["precond"],
                             project_fn=tside["project_fn"], **extra)
    _check_cg(got, ref)
    if form != "cg_solve_fixed":
        assert int(got.iterations) > 2  # the stopping test ran
