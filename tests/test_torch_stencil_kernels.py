"""The link-free stencils, and the kernels' plain versions against the JAX
package's Pallas kernels (interpret mode).

The fixtures are in ``tests/test_torch_stencil.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tdgl_tpu.models import gtdgl_stencil as jgs
from tdgl_tpu.ops import pallas_step
from tdgl_tpu_torch.models import gtdgl_stencil as tgs
from tdgl_tpu_torch.ops import step_kernels

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_stencil import (_j, _psi_args, _psi_tol, _rel, _t, _tol, case,
                                device, one_blas_thread)


def test_link_free_stencils(case):
    js, ts = case["jsten"], case["tsten"]
    tol = _tol(case)
    x_j, x_t = _j(case, "x"), _t(case, "x")
    assert _rel(tgs.scalar_laplacian_sym(ts, x_t),
                jgs.scalar_laplacian_sym(js, x_j)) < tol
    assert _rel(tgs.gradient_on_edges(ts, x_t),
                jgs.gradient_on_edges(js, x_j)) < tol
    F_j = jnp.stack([x_j, 2 * x_j, -x_j])
    F_t = torch.stack([x_t, 2 * x_t, -x_t])
    assert _rel(tgs.divergence_on_sites(ts, F_t),
                jgs.divergence_on_sites(js, F_j)) < tol
    assert _rel(tgs.poisson_rhs(ts, F_t, _t(case, "dA"), _t(case, "x")),
                jgs.poisson_rhs(js, F_j, _j(case, "dA"), x_j)) < tol
    mu_b = case["solver"]._mu_boundary(0.0)
    nb_t = tgs.neumann_boundary_term(ts, torch.from_numpy(mu_b))
    assert _rel(nb_t, jgs.neumann_boundary_term(js, jnp.asarray(mu_b))) < tol
    assert np.abs(nb_t.numpy()).max() > 0


def test_psi_kernel_plain_matches_pallas(case):
    """Raw links: the wrapper's plain version vs the Pallas kernel."""
    solver = case["solver"]
    g, u = solver.cfg.gamma, solver.cfg.u
    dt = 1e-2
    jd = case["arrays"]["pr"].dtype
    ref = pallas_step.fused_psi_update(
        g, u, case["jsten"], case["jU"]["raw"], _j(case, "pr"),
        _j(case, "pi"), _j(case, "mu"), _j(case, "eps"),
        jnp.asarray(dt, jd))
    got = step_kernels.fused_psi_update(
        g, u, case["tsten"], case["tU"]["raw"], *_psi_args(case),
        torch.tensor(dt, dtype=_t(case, "pr").dtype))
    for a, b in zip(got[:3], ref[:3]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < _psi_tol(case, b)
    assert bool(got[3]) == bool(ref[3])


def test_rhs_kernel_plain_matches_pallas(case):
    ref = pallas_step.fused_poisson_rhs(
        case["jsten"], case["jU"]["raw"], _j(case, "pr"), _j(case, "pi"),
        _j(case, "dA"), _j(case, "neumann"))
    got = step_kernels.fused_poisson_rhs(
        case["tsten"], case["tU"]["raw"], _t(case, "pr"), _t(case, "pi"),
        _t(case, "dA"), _t(case, "neumann"))
    scale = max(float(np.abs(np.asarray(ref)).max()), 1.0)
    tol = 1e-12 if case["dtype"] == "float64" else 3e-5
    assert np.abs(got.numpy() - np.asarray(ref)).max() < tol * scale
