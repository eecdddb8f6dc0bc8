"""The ELL mu solve (``solve_mu_poisson``: Jacobi and AMG preconditioning;
tolerance-stopped, fixed and topped-up forms) against the JAX package's.

The fixtures are in ``tests/test_torch_ell.py``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from tdgl_tpu.ops.cg import solve_mu_poisson as j_solve_mu
from tdgl_tpu_torch.ops.cg import solve_mu_poisson as t_solve_mu

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_ell import _rel, devices, one_blas_thread, tables


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
@pytest.mark.parametrize("form", ["stopped", "fixed", "topup"])
def test_solve_mu_poisson_matches_jax(tables, precond, form):
    x = tables["inputs"]
    fixed_iters, topup = {"stopped": (None, False), "fixed": (3, False),
                          "topup": (2, True)}[form]
    amg = precond == "amg"
    ref = jax.jit(lambda r, m: j_solve_mu(
        tables["jop"], r, m, tol=1e-8, amg=tables["jamg"] if amg else None,
        fixed_iters=fixed_iters, topup=topup))(
        jnp.asarray(x["rhs"]), jnp.asarray(x["mu"]))
    got = t_solve_mu(tables["top"], torch.from_numpy(x["rhs"]),
                     torch.from_numpy(x["mu"]), tol=1e-8,
                     amg=tables["tamg"] if amg else None,
                     fixed_iters=fixed_iters, topup=topup)
    assert int(got.iterations) == int(ref.iterations)
    if precond == "jacobi" and form != "fixed":
        # Jacobi-PCG stopped at 1e-8 takes ~100 iterations on this film,
        # over which the packages' different reduction orders part x to
        # ~1e-9; the final residual (a recurrence at the rounding scale)
        # agrees to a few percent, and both meet the tolerance.
        assert _rel(got.x, ref.x) < 1e-8
        assert float(got.residual_norm) < 1e-8
        assert float(ref.residual_norm) < 1e-8
        assert abs(float(got.residual_norm) / float(ref.residual_norm)
                   - 1.0) < 0.05
    else:
        assert _rel(got.x, ref.x) < 1e-13
        assert abs(float(got.residual_norm) - float(ref.residual_norm)) \
            <= 1e-10 * float(ref.residual_norm)
