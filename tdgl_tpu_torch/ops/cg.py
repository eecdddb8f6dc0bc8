"""Device-resident conjugate-gradient solvers for the mu-Poisson equation.

Port of :mod:`tdgl_tpu.ops.cg` (the grid backend's solvers): deflated,
preconditioned CG on the symmetric form ``S mu = diag(a) rhs`` (``S`` = the
area-unscaled Neumann FV Laplacian, symmetric negative semidefinite with the
constants as null space), warm-started from the previous step's ``mu``.

``alpha``, ``beta``, ``rz`` and the residual stay 0-d tensors on the
device. The fixed-count solve (:func:`cg_solve_fixed`, and the fixed phase
of :func:`cg_solve_topup`) never reads a value back to the host; the
tolerance-stopped loops read their stopping test once per iteration, which
is what a data-dependent loop costs in eager PyTorch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # 0-d int32
    residual_norm: torch.Tensor  # 0-d: final ||r|| / ||b||


def _preconditioner(precond, precond_inv_diag, rdtype):
    # No deflation projection of z: with r kept deflated, any constant
    # component of z is invisible to rz, contributes nothing through A p,
    # and only shifts x by a constant — which the final projection removes.
    def M_inv(v):
        if precond is not None:
            return precond(v)
        if precond_inv_diag is None:
            return v
        return precond_inv_diag.to(rdtype) * v

    return M_inv


def _tol_sq(tol: float, b_norm_sq: torch.Tensor) -> torch.Tensor:
    # Don't chase tolerances below what the working precision can deliver.
    eps = torch.finfo(b_norm_sq.dtype).eps
    tol_eff = max(float(tol), 50.0 * eps)
    return torch.tensor(tol_eff, dtype=b_norm_sq.dtype).square().item() \
        * b_norm_sq


def _iteration(apply_A, M_inv, project, state, reproject=True):
    """One PCG iteration with breakdown freeze: in finite precision the
    curvature p^T A p can collapse to <= 0 once the residual stagnates;
    stepping with a clamped denominator would blow up x, so freeze."""
    x, r, z, p, rz = state
    tiny = torch.finfo(r.dtype).tiny
    Ap = apply_A(p)
    pAp = torch.sum(p * Ap)
    healthy = torch.logical_and(torch.isfinite(pAp), pAp > tiny)
    alpha = torch.where(healthy, rz / torch.where(healthy, pAp, 1.0), 0.0)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    if reproject:
        r_new = project(r_new)
    z_new = M_inv(r_new)
    rz_new = torch.sum(r_new * z_new)
    beta = torch.where(
        healthy, rz_new / torch.where(torch.abs(rz) > 0, rz, 1.0), 0.0
    )
    p_new = z_new + beta * p

    def keep(old, new):
        return torch.where(healthy, new, old)

    return (keep(x, x_new), keep(r, r_new), keep(z, z_new),
            keep(p, p_new), keep(rz, rz_new), healthy)


def _stopped_loop(apply_A, M_inv, project, state, tol_sq, k, maxiter):
    """Tolerance-stopped PCG iterations from ``state``, until
    ``||r||^2 <= tol_sq``, a breakdown, or ``maxiter`` total iterations."""
    ok = True
    x, r, z, p, rz = state
    while ok and k < maxiter and bool(torch.sum(r * r) > tol_sq):
        x, r, z, p, rz, healthy = _iteration(apply_A, M_inv, project,
                                             (x, r, z, p, rz))
        ok = bool(healthy)
        k += 1
    return x, r, k


def cg_solve(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    precond_inv_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-7,
    maxiter: int = 500,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    project_fn: Callable[[torch.Tensor], torch.Tensor],
) -> CGResult:
    """Preconditioned conjugate gradients with null-space deflation
    (``project_fn``), stopped at ``||r|| <= tol ||b||`` (floored at 50
    eps)."""
    rdtype = b.dtype
    M_inv = _preconditioner(precond, precond_inv_diag, rdtype)
    b = project_fn(b)
    x0 = project_fn(x0)
    b_norm_sq = torch.clamp(torch.sum(b * b), min=torch.finfo(rdtype).tiny)
    tol_sq = _tol_sq(tol, b_norm_sq)
    r0 = project_fn(b - apply_A(x0))
    z0 = M_inv(r0)
    rz0 = torch.sum(r0 * z0)
    x, r, k = _stopped_loop(apply_A, M_inv, project_fn, (x0, r0, z0, z0, rz0),
                            tol_sq, 0, maxiter)
    res = torch.sqrt(torch.sum(r * r) / b_norm_sq)
    return CGResult(project_fn(x), b.new_full((), k, dtype=torch.int32), res)


def cg_solve_fixed(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    n_iters: int,
    precond_inv_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    project_fn: Callable[[torch.Tensor], torch.Tensor],
) -> CGResult:
    """Fixed-iteration preconditioned CG: exactly ``n_iters`` iterations, no
    stopping test and no host read, so the solve is a smooth map of its
    inputs. Guards against breakdown (pAp <= 0) by freezing the step."""
    rdtype = b.dtype
    M_inv = _preconditioner(precond, precond_inv_diag, rdtype)
    b = project_fn(b)
    x0 = project_fn(x0)
    r0 = project_fn(b - apply_A(x0))
    z0 = M_inv(r0)
    state = (x0, r0, z0, z0, torch.sum(r0 * z0))
    for _ in range(n_iters):
        state = _iteration(apply_A, M_inv, project_fn, state)[:5]
    x, r = state[0], state[1]
    b_norm_sq = torch.clamp(torch.sum(b * b), min=torch.finfo(rdtype).tiny)
    res = torch.sqrt(torch.sum(r * r) / b_norm_sq)
    return CGResult(project_fn(x), b.new_full((), n_iters, dtype=torch.int32),
                    res)


def cg_solve_topup(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    base_iters: int,
    tol: float = 1e-6,
    maxiter: int = 200,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    precond_inv_diag: Optional[torch.Tensor] = None,
    *,
    project_fn: Callable[[torch.Tensor], torch.Tensor],
) -> CGResult:
    """Fixed-count CG with a tolerance-stopped top-up.

    Runs exactly ``base_iters`` iterations with no stopping test, then keeps
    iterating while the residual still exceeds ``tol``. The fixed phase
    skips the per-iteration re-projection of ``r`` (null-space deflation is
    stable over a few iterations; the final projection removes the O(eps)
    drift); the top-up phase keeps it.
    """
    rdtype = b.dtype
    M_inv = _preconditioner(precond, precond_inv_diag, rdtype)
    b = project_fn(b)
    x0 = project_fn(x0)
    b_norm_sq = torch.clamp(torch.sum(b * b), min=torch.finfo(rdtype).tiny)
    tol_sq = _tol_sq(tol, b_norm_sq)
    r0 = project_fn(b - apply_A(x0))
    z0 = M_inv(r0)
    state = (x0, r0, z0, z0, torch.sum(r0 * z0))
    for _ in range(base_iters):
        state = _iteration(apply_A, M_inv, project_fn, state,
                           reproject=False)[:5]
    x, r, k = _stopped_loop(apply_A, M_inv, project_fn, state, tol_sq,
                            base_iters, maxiter)
    res = torch.sqrt(torch.sum(r * r) / b_norm_sq)
    return CGResult(project_fn(x), b.new_full((), k, dtype=torch.int32), res)


def solve_mu_poisson_grid(
    sten,
    rhs: torch.Tensor,
    mu_prev: torch.Tensor,
    tol: float = 1e-7,
    maxiter: int = 1000,
    amg=None,
    amg_omega: float = 0.6,
    fixed_iters: Optional[int] = None,
    topup: bool = False,
) -> CGResult:
    """Solve the grid mu-Poisson problem on padded ``(Rp, Cp)`` tensors.

    The constant-mode deflation is a masked mean, so padding and masked
    sites stay exactly zero. ``amg`` (a :class:`HexMGData` of tensors)
    selects the deep-multigrid preconditioner, else Jacobi. ``fixed_iters``
    runs a fixed count (:func:`cg_solve_fixed`), with ``topup`` appending
    tolerance-stopped iterations (:func:`cg_solve_topup`).
    """
    from ..models.gtdgl_stencil import scalar_laplacian_sym

    rdtype = rhs.dtype
    valid = sten.valid.to(rdtype)
    n_valid = torch.clamp(torch.sum(valid), min=1.0)

    def project(v):
        return (v - torch.sum(v * valid) / n_valid) * valid

    def apply_A(x):
        return -scalar_laplacian_sym(sten, x)

    b = -(sten.area.to(rdtype) * rhs)
    precond = None
    inv_diag = None
    if amg is not None:
        from .hexmg import make_hexmg_apply

        apply_mg = make_hexmg_apply(amg_omega)

        def precond(v):
            return apply_mg(amg, v)
    else:
        inv_diag = torch.where(
            valid > 0,
            1.0 / torch.clamp(sten.sym_diag.to(rdtype),
                              min=torch.finfo(rdtype).tiny),
            0.0,
        )
    if fixed_iters is not None:
        if topup:
            return cg_solve_topup(
                apply_A, b, mu_prev, fixed_iters, tol=tol, maxiter=maxiter,
                precond_inv_diag=inv_diag, precond=precond,
                project_fn=project,
            )
        return cg_solve_fixed(
            apply_A, b, mu_prev, fixed_iters, precond_inv_diag=inv_diag,
            precond=precond, project_fn=project,
        )
    return cg_solve(
        apply_A, b, mu_prev, precond_inv_diag=inv_diag, tol=tol,
        maxiter=maxiter, precond=precond, project_fn=project,
    )
