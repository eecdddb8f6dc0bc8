"""The generalized TDGL equations on the ELL tables (unstructured meshes),
in PyTorch.

Port of :mod:`tdgl_tpu.models.gtdgl` (same physics, same operation order),
for the tables of :mod:`tdgl_tpu_torch.fv.operators` on a device
(:func:`tdgl_tpu_torch.convert.operators_to_torch`: index tables as
``int64``). Every operator is a gather over the ``K`` neighbor slots of
each site, a multiply and a sum over the slots.

Conventions (as in the JAX package):

* ``psi`` is an ``(N, 2)`` re/im pair on sites, ``mu`` real on sites; no
  complex dtype is used, so the state matches the JAX package's field for
  field.
* Edge quantities (supercurrent, normal current, A) live on the canonical
  edge orientation ``r[edges[:,1]] - r[edges[:,0]]``.
* Every field may carry a leading member axis (a batch of runs of a
  parameter sweep): ``(B, N, 2)``, ``(B, N)``, ``(B, E)``; the tables are
  shared and the gathers index the site or edge axis. A per-member ``dt``
  is a ``(B,)`` vector and the psi update's ``ok`` is then ``(B,)``.
* ``U_e = exp(-i A.e_direction)`` is the spatial link variable, stored as
  the pair ``(cos, -sin)``; the directed phase from site i to neighbor j
  is ``U_e`` if the edge's canonical direction points i -> j, else
  ``conj(U_e)``.

The JAX package's three scatter-adds are gathers here, so no result
depends on the order in which atomics land (an ``index_add`` on the card
does): the Neumann term sums each boundary site's contributions in index
order through a host-built table
(:func:`~tdgl_tpu_torch.models.gtdgl_stencil.index_gather`), and the
edge-to-site average sums over the ELL slots, which list each site's
incident edges (those it starts, then those it ends, each in edge order:
the order of the JAX package's two scatters).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gtdgl_stencil import index_gather, ordered_scatter_sum


def edge_link_phases(A_edge: torch.Tensor,
                     edge_directions: torch.Tensor) -> torch.Tensor:
    """Link variables ``U_e = exp(-i A(r_e) . e)`` as ``(E, 2)`` pairs.

    Args:
        A_edge: ``(E, 2)`` vector potential at edge centers.
        edge_directions: ``(E, 2)`` unnormalized edge vectors.
    """
    a = torch.sum(A_edge * edge_directions, dim=-1)
    return torch.stack([torch.cos(a), -torch.sin(a)], dim=-1)


def covariant_laplacian(op, U: torch.Tensor, psi: torch.Tensor
                        ) -> torch.Tensor:
    """Covariant Laplacian ``(nabla - iA)^2 psi`` on sites, ``(N, 2)``.

    ``(L psi)_i = (1/a_i) sum_j (w_ij) (U_ij psi_j - psi_i)``; rows of
    fixed (terminal) sites become identity rows.
    """
    rdt = psi.dtype
    U_slot = U[..., op.nbr_edge, :]          # (N, K, 2) paired gather
    ur = U_slot[..., 0]
    # conj for slots whose canonical edge points j -> i: sign flips im.
    ui = U_slot[..., 1] * op.nbr_sign.to(rdt)
    psi_nbr = psi[..., op.nbr_site, :]       # (N, K, 2)
    pr_n = psi_nbr[..., 0]
    pi_n = psi_nbr[..., 1]
    w = op.w_lap.to(rdt)
    rowsum = op.w_lap_rowsum.to(rdt)
    pr = psi[..., 0]
    pi = psi[..., 1]
    lap_r = torch.sum(w * (ur * pr_n - ui * pi_n), dim=-1) - pr * rowsum
    lap_i = torch.sum(w * (ur * pi_n + ui * pr_n), dim=-1) - pi * rowsum
    fixed = op.fixed_mask.to(rdt)
    return torch.stack(
        [(1.0 - fixed) * lap_r + fixed * pr,
         (1.0 - fixed) * lap_i + fixed * pi],
        dim=-1,
    )


def scalar_laplacian_sym(op, x: torch.Tensor) -> torch.Tensor:
    """Symmetric (area-unscaled) Neumann Laplacian
    ``(S x)_i = sum_j w_ij (x_j - x_i)``; the mu-Poisson operator is
    ``L = diag(1/a) S`` and CG solves with ``S``."""
    w = op.w_sym.to(x.dtype)
    return (torch.sum(w * x[..., op.nbr_site], dim=-1)
            - x * op.w_sym_rowsum.to(x.dtype))


def gradient_on_edges(op, x: torch.Tensor) -> torch.Tensor:
    """Discrete gradient of a site scalar, on edges: ``(x_j - x_i)/e_ij``."""
    e0 = op.edges[:, 0]
    e1 = op.edges[:, 1]
    return (x[..., e1] - x[..., e0]) / op.edge_lengths.to(x.dtype)


def supercurrent_on_edges(op, U: torch.Tensor, psi: torch.Tensor
                          ) -> torch.Tensor:
    """Gauge-invariant supercurrent ``J_s = Im[psi_i^* (U psi_j - psi_i)]/e``
    on edges."""
    rdt = psi.dtype
    psi0 = psi[..., op.edges[:, 0], :]       # (E, 2) paired gathers
    psi1 = psi[..., op.edges[:, 1], :]
    ur, ui = U[..., 0], U[..., 1]
    inv_len = 1.0 / op.edge_lengths.to(rdt)
    grad_r = (ur * psi1[..., 0] - ui * psi1[..., 1] - psi0[..., 0]) * inv_len
    grad_i = (ur * psi1[..., 1] + ui * psi1[..., 0] - psi0[..., 1]) * inv_len
    return psi0[..., 0] * grad_i - psi0[..., 1] * grad_r


def divergence_on_sites(op, F_edge: torch.Tensor) -> torch.Tensor:
    """Divergence of an edge flux onto sites:
    ``(div F)_i = (1/a_i) sum_j F_ij s_ij``."""
    w = op.w_div.to(F_edge.dtype)
    return torch.sum(w * F_edge[..., op.nbr_edge], dim=-1)


def neumann_boundary_term(op, mu_boundary: torch.Tensor,
                          n_sites: int) -> torch.Tensor:
    """Inhomogeneous Neumann BC contribution to the mu-Poisson RHS:
    ``len_b/(2 a_i) * J_ext_b`` summed onto the boundary sites, in index
    order (deterministic; equal to ``np.add.at`` bit for bit)."""
    vals = op.nbl_vals.to(mu_boundary.dtype) * mu_boundary[..., op.nbl_cols]
    return ordered_scatter_sum(index_gather(op.nbl_rows), vals, n_sites)


def unit_edge_directions(op, dtype: torch.dtype) -> torch.Tensor:
    """``edge_directions / |edge_directions|`` in ``dtype``, ``(E, 2)``."""
    d = op.edge_directions
    return (d / torch.linalg.norm(d, dim=1, keepdim=True)).to(dtype)


def edge_quantity_to_sites(op, F_edge: torch.Tensor, n_sites: int,
                           unit_dirs: torch.Tensor = None) -> torch.Tensor:
    """Average an edge flux onto site vectors, in the reference's K0-unit
    convention: site value = (1/2) mean over incident edges of
    ``F_e e_hat``.

    Summed over each site's ELL slots (its incident edges), so no scatter
    is needed. ``unit_dirs`` (:func:`unit_edge_directions`) may be passed
    precomputed. A ``(B, E)`` batch of fluxes gives ``(B, N, 2)``.
    """
    del n_sites  # implied by the tables; kept for the JAX signature
    if unit_dirs is None:
        unit_dirs = unit_edge_directions(op, F_edge.dtype)
    mask = op.nbr_mask.to(F_edge.dtype)
    flux = (F_edge[..., None] * unit_dirs)[..., op.nbr_edge, :]  # (N, K, 2)
    sums = torch.sum(flux * mask[..., None], dim=-2)
    counts = torch.sum(mask, dim=1)
    return sums / (2.0 * torch.clamp(counts, min=1.0))[:, None]


class PsiUpdateResult(NamedTuple):
    psi: torch.Tensor          # (N, 2) re/im pair
    abs_sq_psi: torch.Tensor   # (N,)
    ok: torch.Tensor           # bool, 0-d or (B,): discriminant >= 0
                               # everywhere


def implicit_euler_psi(
    op,
    U: torch.Tensor,
    psi: torch.Tensor,
    abs_sq_psi: torch.Tensor,
    mu: torch.Tensor,
    epsilon: torch.Tensor,
    gamma: float,
    u: float,
    dt,
) -> PsiUpdateResult:
    """One implicit-Euler update of the order parameter (split complex);
    with a member axis, ``dt`` may be a ``(B,)`` vector and ``ok`` is per
    member.

    Solves the closed-form quadratic for ``|psi^{n+1}|^2``::

        |psi^{n+1}|^2 = 2|w|^2 / (2c+1 + sqrt((2c+1)^2 - 4|z|^2|w|^2))

    with ``z = exp(-i mu dt) (gamma^2/2) psi`` and
    ``w = z|psi|^2 + exp(-i mu dt)[psi + (dt/u) sqrt(1+gamma^2|psi|^2)
    ((eps - |psi|^2) psi + (nabla-iA)^2 psi)]``, then
    ``psi^{n+1} = w - z |psi^{n+1}|^2``. ``ok`` is False if the
    discriminant is negative anywhere (the caller retries with a smaller
    dt).
    """
    pr = psi[..., 0]
    pi = psi[..., 1]
    if isinstance(dt, torch.Tensor) and dt.dim() == 1:
        dt = dt[:, None]
    phase = mu * dt
    tr = torch.cos(phase)
    ti = -torch.sin(phase)   # U_t = tr + i ti
    half_g2 = 0.5 * gamma**2
    # z = U_t (gamma^2/2) psi
    zr = half_g2 * (tr * pr - ti * pi)
    zi = half_g2 * (tr * pi + ti * pr)
    lap = covariant_laplacian(op, U, psi)
    coeff = (dt / u) * torch.sqrt(1.0 + gamma**2 * abs_sq_psi)
    gr = pr + coeff * ((epsilon - abs_sq_psi) * pr + lap[..., 0])
    gi = pi + coeff * ((epsilon - abs_sq_psi) * pi + lap[..., 1])
    # w = z |psi|^2 + U_t g
    wr = zr * abs_sq_psi + tr * gr - ti * gi
    wi = zi * abs_sq_psi + tr * gi + ti * gr
    c = wr * zr + wi * zi
    two_c_1 = 2.0 * c + 1.0
    w2 = wr * wr + wi * wi
    # The textbook discriminant (2c+1)^2 - 4|z|^2|w|^2 cancels
    # catastrophically in float32; since c^2 - |z|^2|w|^2 =
    # -Im(conj(w) z)^2 it equals 1 + 4c - 4 Im(conj(w) z)^2 exactly.
    im_wz = wr * zi - wi * zr
    discriminant = 1.0 + 4.0 * c - 4.0 * im_wz**2
    ok = (torch.all(discriminant >= 0.0) if discriminant.dim() == 1
          else torch.all(discriminant >= 0.0, dim=-1))
    sqrt_disc = torch.sqrt(torch.clamp(discriminant, min=0.0))
    new_sq = (2.0 * w2) / (two_c_1 + sqrt_disc)
    new_psi = torch.stack([wr - zr * new_sq, wi - zi * new_sq], dim=-1)
    return PsiUpdateResult(new_psi, new_sq, ok)


def poisson_rhs(
    op,
    supercurrent: torch.Tensor,
    dA_dt: torch.Tensor,
    mu_boundary: torch.Tensor,
) -> torch.Tensor:
    """RHS of the mu-Poisson equation:
    ``div(J_s - dA/dt) - N_bl @ mu_boundary``."""
    n = op.areas.shape[0]
    return divergence_on_sites(op, supercurrent - dA_dt) - \
        neumann_boundary_term(op, mu_boundary, n)
