"""The grid mu solve (``solve_mu_poisson_grid``: multigrid with a top-up,
fixed multigrid iterations, tolerance-stopped Jacobi) against the JAX
package's.

The fixtures are in ``tests/test_torch_cg_hexmg.py``.
"""

import jax.numpy as jnp
import pytest
import torch

from tdgl_tpu.ops import cg as jcg
from tdgl_tpu_torch.ops import cg as tcg

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_cg_hexmg import _both, _check_cg, one_blas_thread, problem


@pytest.mark.parametrize("mode", ["amg_topup", "amg_fixed", "jacobi_tol"])
def test_solve_mu_poisson_grid(problem, mode):
    jsten, tsten, jmg, tmg, _ = _both(problem, "float64")
    kw = dict(amg_topup=dict(fixed_iters=2, topup=True, tol=1e-8),
              amg_fixed=dict(fixed_iters=2),
              jacobi_tol=dict(tol=1e-6, maxiter=400))[mode]
    use_amg = mode.startswith("amg")
    ref = jcg.solve_mu_poisson_grid(
        jsten, jnp.asarray(problem["rhs"]), jnp.asarray(problem["mu_prev"]),
        amg=jmg if use_amg else None, amg_omega=0.8, **kw)
    got = tcg.solve_mu_poisson_grid(
        tsten, torch.from_numpy(problem["rhs"]),
        torch.from_numpy(problem["mu_prev"]),
        amg=tmg if use_amg else None, amg_omega=0.8, **kw)
    _check_cg(got, ref)
