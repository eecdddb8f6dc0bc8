"""The last three ELL stencil functions of ``gtdgl`` and the implicit
Euler psi update (a passing and a failing step) against the JAX
package's.

The fixtures are in ``tests/test_torch_ell.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdgl_tpu.models import gtdgl as jg
from tdgl_tpu_torch.models import gtdgl as tg

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_ell import (GTDGL_FUNCTIONS, _rel, devices,
                            gtdgl_function_matches_jax, one_blas_thread,
                            tables)


@pytest.mark.parametrize("name", GTDGL_FUNCTIONS[6:])
def test_gtdgl_function_matches_jax(tables, name):
    gtdgl_function_matches_jax(tables, name)


@pytest.mark.parametrize("dt", [1e-2, 40.0])
def test_implicit_euler_psi_matches_jax(tables, dt):
    """A passing and a failing (``ok`` False) time step."""
    x = tables["inputs"]
    n = len(x["mu"])
    sq = np.sum(x["psi"] ** 2, axis=-1)
    eps = np.ones(n)
    U = np.asarray(jg.edge_link_phases(jnp.asarray(x["A"]),
                                       tables["jop"].edge_directions))
    ref = jax.jit(lambda *a: jg.implicit_euler_psi(
        tables["jop"], *a, 0.5, 5.79, dt))(
        *(jnp.asarray(a) for a in (U, x["psi"], sq, x["mu"], eps)))
    got = tg.implicit_euler_psi(
        tables["top"], *(torch.tensor(a) for a in (U, x["psi"], sq,
                                                   x["mu"], eps)),
        0.5, 5.79, torch.tensor(dt, dtype=torch.float64))
    assert bool(got.ok) == bool(ref.ok) == (dt < 1)
    assert _rel(got.psi, ref.psi) < 1e-13
    assert _rel(got.abs_sq_psi, ref.abs_sq_psi) < 1e-13
