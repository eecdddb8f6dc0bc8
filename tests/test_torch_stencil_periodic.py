"""The kernels' plain versions in the factored link form against the
stencil functions, and on a periodic stencil (every edge live).

The fixtures are in ``tests/test_torch_stencil.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdgl_tpu.models import gtdgl_stencil as jgs
from tdgl_tpu.ops import pallas_step
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.device.hexmesh import EDGE_OFFSETS
from tdgl_tpu_torch.models import gtdgl_stencil as tgs
from tdgl_tpu_torch.ops import step_kernels
from tdgl_tpu_torch.testing import periodic_stencil

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_stencil import (DTYPES, _j, _psi_args, _psi_tol, _t, case,
                                device, one_blas_thread)


def test_kernels_plain_factored_match_gs(case):
    """Factored links (the Pallas kernels take raw planes only): the
    wrappers' plain versions vs the JAX stencil composition."""
    solver = case["solver"]
    g, u = solver.cfg.gamma, solver.cfg.u
    js, jU = case["jsten"], case["jU"]["factored"]
    pr_j, pi_j = _j(case, "pr"), _j(case, "pi")
    dt = 1e-2
    ref = jgs.implicit_euler_psi(js, jU, pr_j, pi_j, pr_j**2 + pi_j**2,
                                 _j(case, "mu"), _j(case, "eps"), g, u,
                                 jnp.asarray(dt, pr_j.dtype))
    got = step_kernels.fused_psi_update(
        g, u, case["tsten"], case["tU"]["factored"], *_psi_args(case), dt)
    for a, b in zip(got[:3], ref[:3]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < _psi_tol(case, b)
    assert bool(got[3]) == bool(ref.ok)
    rhs_ref = jgs.poisson_rhs(js, jgs.supercurrent_on_edges(js, jU, pr_j,
                                                            pi_j),
                              _j(case, "dA"), _j(case, "neumann"))
    rhs = step_kernels.fused_poisson_rhs(
        case["tsten"], case["tU"]["factored"], _t(case, "pr"),
        _t(case, "pi"), _t(case, "dA"), _t(case, "neumann"))
    scale = max(float(np.abs(np.asarray(rhs_ref)).max()), 1.0)
    tol = 1e-12 if case["dtype"] == "float64" else 3e-5
    assert np.abs(rhs.numpy() - np.asarray(rhs_ref)).max() < tol * scale


def _periodic_case(case):
    """The periodic stencil (every edge live, wrapped ones included) in
    both packages, from one set of numpy planes, with random raw and
    factored link phases and inputs that are nonzero on every site."""
    npd, _ = DTYPES[case["dtype"]]
    host = periodic_stencil(case["solver"].host_sten, seed=5)
    jsten = jax.tree.map(jnp.asarray, host)
    tsten = convert.stencil_to_torch(host, "cpu")
    shape = host.valid.shape
    rng = np.random.default_rng(17)
    a = rng.uniform(-np.pi, np.pi, (3,) + shape)
    ur, ui = np.cos(a).astype(npd), (-np.sin(a)).astype(npd)
    # The pre-shifted views, rolled as gtdgl_stencil.edge_link_phases does.
    urm, uim = (np.stack([np.roll(x[k], off, axis=(0, 1))
                          for k, off in enumerate(EDGE_OFFSETS)])
                for x in (ur, ui))
    f = rng.uniform(-np.pi, np.pi, (3, shape[0]))
    g = rng.uniform(-np.pi, np.pi, (3, shape[1]))
    fact = [x.astype(npd) for x in (np.cos(f), np.sin(f), np.cos(g),
                                    np.sin(g))]
    raw = (ur, ui, urm, uim)
    jU = {"raw": jgs.LinkPhases(*map(jnp.asarray, raw)),
          "factored": jgs.FactoredLinkPhases(*map(jnp.asarray, fact))}
    tU = {"raw": tgs.LinkPhases(*map(torch.from_numpy, raw)),
          "factored": tgs.FactoredLinkPhases(*map(torch.from_numpy, fact))}
    amp = rng.uniform(0.2, 1.0, shape)
    phase = rng.uniform(-np.pi, np.pi, shape)
    arrays = dict(pr=amp * np.cos(phase), pi=amp * np.sin(phase),
                  mu=rng.normal(size=shape) * 0.3,
                  eps=1.0 - 0.2 * rng.uniform(size=shape),
                  dA=rng.normal(size=(3,) + shape) * 0.05,
                  neumann=rng.normal(size=shape) * 0.1)
    arrays = {k: v.astype(npd) for k, v in arrays.items()}
    return jsten, tsten, jU, tU, arrays


@pytest.mark.parametrize("form", ["raw", "factored"])
def test_kernels_plain_periodic_stencil(case, form):
    """The wrap semantics the CUDA kernels' tiles must reproduce: on a
    stencil where every wrapped edge carries weight, the wrappers (plain
    versions on CPU tensors, through the public functions and through
    bound ``StepOperands``) match the Pallas kernels (raw links, interpret
    mode) or the JAX stencil composition (factored links, which Pallas
    does not take)."""
    jsten, tsten, jU, tU, arr = _periodic_case(case)
    solver = case["solver"]
    g, u, dt = solver.cfg.gamma, solver.cfg.u, 1e-2
    J = {k: jnp.asarray(v) for k, v in arr.items()}
    T = {k: torch.from_numpy(v.copy()) for k, v in arr.items()}
    jdt = jnp.asarray(dt, J["pr"].dtype)
    if form == "raw":
        ref = pallas_step.fused_psi_update(
            g, u, jsten, jU[form], J["pr"], J["pi"], J["mu"], J["eps"], jdt)
        rhs_ref = pallas_step.fused_poisson_rhs(
            jsten, jU[form], J["pr"], J["pi"], J["dA"], J["neumann"])
    else:
        res = jgs.implicit_euler_psi(
            jsten, jU[form], J["pr"], J["pi"], J["pr"]**2 + J["pi"]**2,
            J["mu"], J["eps"], g, u, jdt)
        ref = (res.psi_r, res.psi_i, res.abs_sq_psi, res.ok)
        rhs_ref = jgs.poisson_rhs(
            jsten, jgs.supercurrent_on_edges(jsten, jU[form], J["pr"],
                                             J["pi"]),
            J["dA"], J["neumann"])
    psi_in = (T["pr"], T["pi"], T["mu"], T["eps"],
              torch.tensor(dt, dtype=T["pr"].dtype))
    ops = step_kernels.StepOperands(tsten, tU[form], T["dA"], T["neumann"])
    results = [
        (step_kernels.fused_psi_update(g, u, tsten, tU[form], *psi_in),
         step_kernels.fused_poisson_rhs(tsten, tU[form], T["pr"], T["pi"],
                                        T["dA"], T["neumann"])),
        (ops.psi_update(g, u, *psi_in), ops.poisson_rhs(T["pr"], T["pi"])),
    ]
    scale = max(float(np.abs(np.asarray(rhs_ref)).max()), 1.0)
    rhs_tol = 1e-12 if case["dtype"] == "float64" else 3e-5
    for got, rhs in results:
        for a, b in zip(got[:3], ref[:3]):
            assert np.abs(a.numpy() - np.asarray(b)).max() < _psi_tol(case,
                                                                       b)
        assert bool(got[3]) == bool(ref[3])
        assert np.abs(rhs.numpy() - np.asarray(rhs_ref)).max() < (
            rhs_tol * scale)
