"""Device-resident conjugate-gradient solvers for the mu-Poisson equation.

Port of :mod:`tdgl_tpu.ops.cg` (the grid backend's solvers): deflated,
preconditioned CG on the symmetric form ``S mu = diag(a) rhs`` (``S`` = the
area-unscaled Neumann FV Laplacian, symmetric negative semidefinite with the
constants as null space), warm-started from the previous step's ``mu``.

``alpha``, ``beta``, ``rz`` and the residual stay 0-d tensors on the
device. The fixed-count solve (:func:`cg_solve_fixed`, and the fixed phase
of :func:`cg_solve_topup`) never reads a value back to the host; the
tolerance-stopped loops read their stopping test once per iteration (and
once before the first), which is what a data-dependent loop costs in eager
PyTorch.

**Members.** Every solver also takes a batch of independent systems (the
members of a parameter sweep), vectors with a leading member axis, when
``dims`` names the per-member vector dims (``(-2, -1)`` on the grid,
``(-1,)`` on the ELL tables). Dot products, ``alpha``, ``beta``, ``rz``,
tolerances, residuals and iteration counts are then ``(B,)``, and the
stopping loop runs while any member continues, keeping a finished member's
``x, r, z, p, rz`` with ``torch.where`` (the semantics of a vmapped
``lax.while_loop``) at one host read per iteration for the whole batch.
:func:`solve_mu_poisson_grid` and :func:`solve_mu_poisson` batch when the
right-hand side has the member axis.

:func:`solve_mu_poisson_grid` solves on the padded grid of the structured
backend, :func:`solve_mu_poisson` on the ELL tables of the unstructured
one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32, 0-d or (B,)
    residual_norm: torch.Tensor  # 0-d or (B,): final ||r|| / ||b||


def _dot(a, b, dims):
    """``sum(a * b)``, per member over ``dims`` when given."""
    return torch.sum(a * b) if dims is None else torch.sum(a * b, dim=dims)


def member_view(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-member ``(B,)`` tensor shaped to broadcast against the
    member field ``x`` (a 0-d one as it is)."""
    return s if s.dim() == 0 else s.reshape(s.shape + (1,) * (x.dim() - 1))


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


def _iteration(apply_A, M_inv, project, state, reproject=True, dims=None):
    """One PCG iteration with breakdown freeze: in finite precision the
    curvature p^T A p can collapse to <= 0 once the residual stagnates;
    stepping with a clamped denominator would blow up x, so freeze."""
    x, r, z, p, rz = state
    tiny = torch.finfo(r.dtype).tiny
    Ap = apply_A(p)
    pAp = _dot(p, Ap, dims)
    healthy = torch.logical_and(torch.isfinite(pAp), pAp > tiny)
    alpha = torch.where(healthy, rz / torch.where(healthy, pAp, 1.0), 0.0)
    x_new = x + member_view(alpha, p) * p
    r_new = r - member_view(alpha, Ap) * Ap
    if reproject:
        r_new = project(r_new)
    z_new = M_inv(r_new)
    rz_new = _dot(r_new, z_new, dims)
    beta = torch.where(
        healthy, rz_new / torch.where(torch.abs(rz) > 0, rz, 1.0), 0.0
    )
    p_new = z_new + member_view(beta, p) * p

    def keep(old, new):
        return torch.where(member_view(healthy, new), new, old)

    return (keep(x, x_new), keep(r, r_new), keep(z, z_new),
            keep(p, p_new), keep(rz, rz_new), healthy)


def _stopped_loop(apply_A, M_inv, project, state, tol_sq, k, maxiter,
                  dims=None):
    """Tolerance-stopped PCG iterations from ``state``, until
    ``||r||^2 <= tol_sq``, a breakdown, or ``maxiter`` total iterations.
    Returns ``(x, r, k)``: ``k`` an int, or per member an int32 ``(B,)``
    tensor."""
    x, r, z, p, rz = state
    go = _dot(r, r, dims) > tol_sq
    if dims is not None:
        return _stopped_members(apply_A, M_inv, project, state, tol_sq, k,
                                maxiter, dims, go)
    # One host read per test: the residual test and the breakdown flag
    # are read together.
    while k < maxiter and bool(go):
        x, r, z, p, rz, healthy = _iteration(apply_A, M_inv, project,
                                             (x, r, z, p, rz))
        k += 1
        go = torch.logical_and(healthy, torch.sum(r * r) > tol_sq)
    return x, r, k


def _stopped_members(apply_A, M_inv, project, state, tol_sq, k, maxiter,
                     dims, go):
    """:func:`_stopped_loop` for a batch: iterate while any member
    continues; a member that has stopped keeps its state (``torch.where``
    on its ``go`` flag) and its count, so each member ends where it would
    alone. One host read of ``any(go)`` per iteration."""
    counts = torch.full(go.shape, k, dtype=torch.int32, device=go.device)
    while k < maxiter and bool(torch.any(go)):
        new = _iteration(apply_A, M_inv, project, state, dims=dims)
        state = tuple(torch.where(member_view(go, n), n, o)
                      for o, n in zip(state, new[:5]))
        counts = counts + go.to(torch.int32)
        k += 1
        r = state[1]
        go = go & new[5] & (_dot(r, r, dims) > tol_sq)
    return state[0], state[1], counts


def _count(b, k, dims):
    """An iteration count as the result's int32 tensor."""
    if isinstance(k, torch.Tensor):
        return k
    if dims is None:
        return b.new_full((), k, dtype=torch.int32)
    return torch.full(b.shape[:b.dim() - len(dims)], k, dtype=torch.int32,
                      device=b.device)


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
    dims=None,
) -> CGResult:
    """Preconditioned conjugate gradients with null-space deflation
    (``project_fn``), stopped at ``||r|| <= tol ||b||`` (floored at 50
    eps); per member when ``dims`` is given."""
    rdtype = b.dtype
    M_inv = _preconditioner(precond, precond_inv_diag, rdtype)
    b = project_fn(b)
    x0 = project_fn(x0)
    b_norm_sq = torch.clamp(_dot(b, b, dims), min=torch.finfo(rdtype).tiny)
    tol_sq = _tol_sq(tol, b_norm_sq)
    r0 = project_fn(b - apply_A(x0))
    z0 = M_inv(r0)
    rz0 = _dot(r0, z0, dims)
    x, r, k = _stopped_loop(apply_A, M_inv, project_fn, (x0, r0, z0, z0, rz0),
                            tol_sq, 0, maxiter, dims)
    res = torch.sqrt(_dot(r, r, dims) / b_norm_sq)
    return CGResult(project_fn(x), _count(b, k, dims), res)


def cg_solve_fixed(
    apply_A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    n_iters: int,
    precond_inv_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    project_fn: Callable[[torch.Tensor], torch.Tensor],
    dims=None,
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
    state = (x0, r0, z0, z0, _dot(r0, z0, dims))
    for _ in range(n_iters):
        state = _iteration(apply_A, M_inv, project_fn, state,
                           dims=dims)[:5]
    x, r = state[0], state[1]
    b_norm_sq = torch.clamp(_dot(b, b, dims), min=torch.finfo(rdtype).tiny)
    res = torch.sqrt(_dot(r, r, dims) / b_norm_sq)
    return CGResult(project_fn(x), _count(b, n_iters, dims), res)


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
    dims=None,
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
    b_norm_sq = torch.clamp(_dot(b, b, dims), min=torch.finfo(rdtype).tiny)
    tol_sq = _tol_sq(tol, b_norm_sq)
    r0 = project_fn(b - apply_A(x0))
    z0 = M_inv(r0)
    state = (x0, r0, z0, z0, _dot(r0, z0, dims))
    for _ in range(base_iters):
        state = _iteration(apply_A, M_inv, project_fn, state,
                           reproject=False, dims=dims)[:5]
    x, r, k = _stopped_loop(apply_A, M_inv, project_fn, state, tol_sq,
                            base_iters, maxiter, dims)
    res = torch.sqrt(_dot(r, r, dims) / b_norm_sq)
    return CGResult(project_fn(x), _count(b, k, dims), res)


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
    tolerance-stopped iterations (:func:`cg_solve_topup`). A ``(B, Rp,
    Cp)`` ``rhs`` solves B independent systems, one per member.
    """
    from ..models.gtdgl_stencil import scalar_laplacian_sym

    rdtype = rhs.dtype
    valid = sten.valid.to(rdtype)
    n_valid = torch.clamp(torch.sum(valid), min=1.0)
    dims = (-2, -1) if rhs.dim() == 3 else None

    def project(v):
        return (v - member_view(_dot(v, valid, dims), v) / n_valid) * valid

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
                project_fn=project, dims=dims,
            )
        return cg_solve_fixed(
            apply_A, b, mu_prev, fixed_iters, precond_inv_diag=inv_diag,
            precond=precond, project_fn=project, dims=dims,
        )
    return cg_solve(
        apply_A, b, mu_prev, precond_inv_diag=inv_diag, tol=tol,
        maxiter=maxiter, precond=precond, project_fn=project, dims=dims,
    )


def solve_mu_poisson(
    op,
    rhs: torch.Tensor,
    mu_prev: torch.Tensor,
    tol: float = 1e-7,
    maxiter: int = 1000,
    amg=None,
    amg_omega: float = 0.6,
    fixed_iters: Optional[int] = None,
    topup: bool = False,
) -> CGResult:
    """Solve the scalar-potential Poisson equation ``L mu = rhs`` with
    ``L = diag(1/a) S`` on the ELL tables (unstructured backend; port of
    :func:`tdgl_tpu.ops.cg.solve_mu_poisson`).

    Works on the symmetrized system ``(-S) mu = -diag(a) rhs`` with a
    Jacobi preconditioner, or the two-level AMG V-cycle when ``amg`` (an
    :class:`~tdgl_tpu_torch.ops.amg.AMGTensors`) is given, warm-started
    from ``mu_prev``; the constant mode is deflated with the plain mean.
    ``fixed_iters`` and ``topup`` select the solver as in
    :func:`solve_mu_poisson_grid`. A ``(B, N)`` ``rhs`` solves B
    independent systems, one per member.
    """
    from ..models.gtdgl import scalar_laplacian_sym

    rdtype = rhs.dtype
    areas = op.areas.to(rdtype)
    dims = (-1,) if rhs.dim() == 2 else None

    def project(v):
        if dims is None:
            return v - torch.mean(v)
        return v - torch.mean(v, dim=-1, keepdim=True)

    def apply_A(x):
        return -scalar_laplacian_sym(op, x)

    b = -(areas * rhs)
    precond = None
    inv_diag = None
    if amg is not None:
        from .amg import make_amg_apply

        apply_amg = make_amg_apply(amg_omega)

        def precond(v):
            return apply_amg(apply_A, amg, v)
    else:
        # Jacobi diagonal of -S: precomputed edge-weight row sums.
        diag = op.w_sym_rowsum.to(rdtype)
        inv_diag = 1.0 / torch.clamp(diag, min=torch.finfo(rdtype).tiny)
    if fixed_iters is not None:
        if topup:
            return cg_solve_topup(
                apply_A, b, mu_prev, fixed_iters, tol=tol, maxiter=maxiter,
                precond_inv_diag=inv_diag, precond=precond,
                project_fn=project, dims=dims,
            )
        return cg_solve_fixed(
            apply_A, b, mu_prev, fixed_iters, precond_inv_diag=inv_diag,
            precond=precond, project_fn=project, dims=dims,
        )
    return cg_solve(
        apply_A, b, mu_prev, precond_inv_diag=inv_diag, tol=tol,
        maxiter=maxiter, precond=precond, project_fn=project, dims=dims,
    )
