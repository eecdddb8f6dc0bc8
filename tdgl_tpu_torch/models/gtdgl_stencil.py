"""The generalized TDGL equations as hex-grid stencils (split complex), in
PyTorch.

Port of :mod:`tdgl_tpu.models.gtdgl_stencil` (same physics, same operation
order), for structured meshes (:mod:`tdgl_tpu_torch.fv.stencil_operators`):

* All site fields are dense ``(Rp, Cp)`` tensors; edge fields are
  ``(3, Rp, Cp)`` (one slab per direction class). Neighbor access is
  ``torch.roll`` — wrap-around reads are killed by zero weights at
  masked/padded entries.
* The order parameter is split into real/imaginary tensors, as in the JAX
  package, so the state layout matches it field for field.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device.hexmesh import EDGE_OFFSETS

_OFFS = tuple(EDGE_OFFSETS)


def shift_p(x: torch.Tensor, k: int) -> torch.Tensor:
    """Value at ``(r, c) + OFFSETS[k]`` (the positive-edge neighbor)."""
    dr, dc = _OFFS[k]
    return torch.roll(x, (-dr, -dc), dims=(0, 1))


def shift_m(x: torch.Tensor, k: int) -> torch.Tensor:
    """Value at ``(r, c) - OFFSETS[k]`` (the negative-edge origin)."""
    dr, dc = _OFFS[k]
    return torch.roll(x, (dr, dc), dims=(0, 1))


class LinkPhases(NamedTuple):
    """Link variables and their pre-shifted views.

    ``ur + i ui = U_k`` at the positive edge of each site; ``urm + i uim``
    is the same array shifted by ``-offset`` (the link of the negative
    incident edge, as seen from the head site).
    """

    ur: torch.Tensor   # (3, Rp, Cp)
    ui: torch.Tensor
    urm: torch.Tensor
    uim: torch.Tensor


def edge_link_phases(sten, A_edge: torch.Tensor,
                     shifted: bool = True) -> LinkPhases:
    """Link variables ``U_k = exp(-i A.e_k)`` (plus shifted views).

    Args:
        sten: :class:`StencilOperators` of tensors.
        A_edge: ``(3, Rp, Cp, 2)`` vector potential at edge centers.
        shifted: Also build the shifted views ``urm``/``uim`` (else they
            are None: the stencils and kernels here read ``ur``/``ui``
            only, so a step that rebuilds its links skips them).
    """
    a = edge_phase_angles(sten, A_edge)
    ur = torch.cos(a)
    ui = -torch.sin(a)
    if not shifted:
        return LinkPhases(ur, ui, None, None)
    urm = torch.stack([shift_m(ur[k], k) for k in range(3)])
    uim = torch.stack([shift_m(ui[k], k) for k in range(3)])
    return LinkPhases(ur, ui, urm, uim)


class FactoredLinkPhases(NamedTuple):
    """Link variables in separable (rank-structured) form.

    For a uniform applied field in the symmetric gauge the per-edge phase
    on the structured lattice is ``theta_k(r, c) = f_k(r) + g_k(c)``
    exactly, so the link planes rebuild from four row/column trig vectors
    by angle addition::

        ur_k = cos f ⊗ cos g - sin f ⊗ sin g     (= cos theta)
        ui_k = -(sin f ⊗ cos g + cos f ⊗ sin g)  (= -sin theta)

    The solver uses this form only after a float64 separability check of
    the static applied potential passes.
    """

    cf: torch.Tensor  # (3, Rp) — cos f_k(r)
    sf: torch.Tensor  # (3, Rp) — sin f_k(r)
    cg: torch.Tensor  # (3, Cp) — cos g_k(c)
    sg: torch.Tensor  # (3, Cp) — sin g_k(c)


def edge_phase_angles(sten, A_edge: torch.Tensor) -> torch.Tensor:
    """Per-edge link phase angles ``a_k = A . e_k`` as ``(3, Rp, Cp)``."""
    dirs = sten.edge_dirs.to(A_edge.dtype)
    return (A_edge[..., 0] * dirs[:, 0, None, None]
            + A_edge[..., 1] * dirs[:, 1, None, None])


def factor_link_phases(sten, A_edge: torch.Tensor) -> FactoredLinkPhases:
    """Build :class:`FactoredLinkPhases` from a separable applied potential.

    Splits ``a_k(r, c)`` into ``f_k(r) = a_k(r, 0)`` and ``g_k(c) =
    a_k(0, c) - a_k(0, 0)``. ONLY valid when the caller has verified
    separability (``a == f + g``); the solver checks in float64 at init.
    """
    a = edge_phase_angles(sten, A_edge)
    f = a[:, :, 0]                      # (3, Rp)
    g = a[:, 0, :] - a[:, 0, 0:1]      # (3, Cp)
    return FactoredLinkPhases(
        cf=torch.cos(f).contiguous(), sf=torch.sin(f).contiguous(),
        cg=torch.cos(g).contiguous(), sg=torch.sin(g).contiguous(),
    )


def _factored_u_k(U: FactoredLinkPhases, k: int, dt: torch.dtype):
    """Reconstruct the (Rp, Cp) link planes ``ur_k``, ``ui_k`` from the
    factored row/col vectors (angle addition — no transcendentals)."""
    cf = U.cf[k].to(dt)[:, None]
    sf = U.sf[k].to(dt)[:, None]
    cg = U.cg[k].to(dt)[None, :]
    sg = U.sg[k].to(dt)[None, :]
    ur = cf * cg - sf * sg
    ui = -(sf * cg + cf * sg)
    return ur, ui


def _u_k(U, k: int, dt: torch.dtype):
    if isinstance(U, FactoredLinkPhases):
        return _factored_u_k(U, k, dt)
    return U.ur[k].to(dt), U.ui[k].to(dt)


def covariant_laplacian(
    sten, U, pr: torch.Tensor, pi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariant Laplacian ``(nabla - iA)^2 psi``, split re/im, with
    identity rows at fixed sites. ``U`` is :class:`LinkPhases` or
    :class:`FactoredLinkPhases`.

    Negative-edge terms are the rolled positive-edge products:
    ``w_m[k] = roll(w[k])`` and ``urm[k] = roll(ur[k])`` by construction, so
    ``w_m*(urm*pr_m + uim*pi_m) == shift_m(w*(ur*pr + ui*pi), k)`` exactly.
    """
    dt = pr.dtype
    acc_r = torch.zeros_like(pr)
    acc_i = torch.zeros_like(pi)
    for k in range(3):
        pr_p = shift_p(pr, k)
        pi_p = shift_p(pi, k)
        wk = sten.w[k].to(dt)
        ur, ui = _u_k(U, k, dt)
        # positive edge: U_k psi_{+k}
        acc_r = acc_r + wk * (ur * pr_p - ui * pi_p)
        acc_i = acc_i + wk * (ur * pi_p + ui * pr_p)
        # negative edge: conj(U_k at -off) psi_{-off}
        acc_r = acc_r + shift_m(wk * (ur * pr + ui * pi), k)
        acc_i = acc_i + shift_m(wk * (ur * pi - ui * pr), k)
    diag = sten.sym_diag.to(dt)
    inv_a = sten.inv_area.to(dt)
    lap_r = (acc_r - pr * diag) * inv_a
    lap_i = (acc_i - pi * diag) * inv_a
    fixed = sten.fixed_mask.to(dt)
    return ((1.0 - fixed) * lap_r + fixed * pr,
            (1.0 - fixed) * lap_i + fixed * pi)


def scalar_laplacian_sym(sten, x: torch.Tensor) -> torch.Tensor:
    """Symmetric Neumann Laplacian ``(S x)_i = sum_j w_ij (x_j - x_i)``.

    The negative-edge term is derived from the positive-edge weights
    (``w_m[k] * shift_m(x, k) == shift_m(w[k] * x, k)`` exactly).
    """
    dt = x.dtype
    acc = torch.zeros_like(x)
    for k in range(3):
        wk = sten.w[k].to(dt)
        acc = acc + wk * shift_p(x, k)
        acc = acc + shift_m(wk * x, k)
    return acc - x * sten.sym_diag.to(dt)


def gradient_on_edges(sten, x: torch.Tensor) -> torch.Tensor:
    """Discrete gradient on positive edges: ``(x_{+k} - x)/len_k``."""
    inv_len = sten.inv_len.to(x.dtype)
    return torch.stack(
        [(shift_p(x, k) - x) * inv_len[k] for k in range(3)]
    )


def supercurrent_on_edges(
    sten, U, pr: torch.Tensor, pi: torch.Tensor
) -> torch.Tensor:
    """Gauge-invariant supercurrent ``Im[psi_i^* (U psi_j - psi_i)]/len``
    on the (3, Rp, Cp) edge classes."""
    dt = pr.dtype
    out = []
    for k in range(3):
        pr_p = shift_p(pr, k)
        pi_p = shift_p(pi, k)
        ur, ui = _u_k(U, k, dt)
        grad_r = ur * pr_p - ui * pi_p - pr
        grad_i = ur * pi_p + ui * pr_p - pi
        out.append((pr * grad_i - pi * grad_r) * sten.inv_len[k].to(dt))
    return torch.stack(out)


def divergence_on_sites(sten, F_edge: torch.Tensor) -> torch.Tensor:
    """Divergence of a (3, Rp, Cp) edge flux onto sites."""
    dt = F_edge.dtype
    acc = torch.zeros_like(F_edge[0])
    for k in range(3):
        dF = sten.dual[k].to(dt) * F_edge[k]
        acc = acc + dF - shift_m(dF, k)
    return acc * sten.inv_area.to(dt)


def edge_quantity_to_sites(sten, F_edge: torch.Tensor) -> torch.Tensor:
    """Average an edge flux onto site vectors in the reference's K0-unit
    convention (site value = mean over incident edges of ``F_e e_hat / 2``).

    Returns ``(Rp, Cp, 2)``.
    """
    dt = F_edge.dtype
    dirs = sten.edge_dirs.to(dt)
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=1, keepdim=True))
    sx = torch.zeros_like(F_edge[0])
    sy = torch.zeros_like(F_edge[0])
    for k in range(3):
        both = F_edge[k] + shift_m(F_edge[k], k)
        sx = sx + both * dirs[k, 0]
        sy = sy + both * dirs[k, 1]
    denom = 2.0 * sten.counts.to(dt)
    return torch.stack([sx / denom, sy / denom], dim=-1)


class NeumannGather(NamedTuple):
    """The Neumann scatter of a stencil as a padded gather table.

    ``targets`` are the distinct boundary sites (flat grid indices);
    ``table[t]`` lists, in increasing order, the positions ``j`` of the
    ``nbl_*`` entries that land on ``targets[t]``, padded with ``2B`` (a
    zero appended to the values). Summing a row left to right adds the
    contributions in the order ``np.add.at`` does, with no atomics.
    """

    targets: torch.Tensor  # (T,) int64
    table: torch.Tensor    # (T, M) int64


# One gather table per stencil: id(nbl_idx) -> (weakref to it, table).
_NEUMANN_GATHERS: Dict[int, tuple] = {}


def neumann_gather(sten) -> NeumannGather:
    """The :class:`NeumannGather` of ``sten``, built on the host from its
    static ``nbl_idx`` on first use and then reused."""
    key = id(sten.nbl_idx)
    ref, gather = _NEUMANN_GATHERS.get(key, (None, None))
    if ref is not None and ref() is sten.nbl_idx:
        return gather
    idx = sten.nbl_idx.detach().cpu().numpy().astype(np.int64)
    order = np.argsort(idx, kind="stable")
    targets, counts = np.unique(idx, return_counts=True)
    width = int(counts.max()) if len(counts) else 0
    table = np.full((len(targets), width), len(idx), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    for m in range(width):
        has = counts > m
        table[has, m] = order[starts[has] + m]
    dev = sten.nbl_idx.device
    gather = NeumannGather(torch.from_numpy(targets).to(dev),
                           torch.from_numpy(table).to(dev))
    _NEUMANN_GATHERS[key] = (weakref.ref(sten.nbl_idx,
                                         lambda _: _NEUMANN_GATHERS.pop(key,
                                                                        None)),
                             gather)
    return gather


def neumann_boundary_term(sten, mu_boundary: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous Neumann BC contribution to the mu-Poisson RHS
    (scatter of ``len_b/(2 a_i) * J_ext_b`` onto boundary sites).

    Deterministic on every device: the contributions to each site are
    gathered through :func:`neumann_gather` and summed in index order, so
    the result equals the host's ``np.add.at`` bit for bit and repeats
    from run to run (an ``index_add`` on the card runs as atomics).
    """
    shape = sten.valid.shape
    vals = (sten.nbl_vals.to(mu_boundary.dtype)
            * mu_boundary[sten.nbl_col.long()])
    flat = torch.zeros(shape[0] * shape[1], dtype=mu_boundary.dtype,
                       device=mu_boundary.device)
    gather = neumann_gather(sten)
    rows = torch.cat([vals, vals.new_zeros(1)])[gather.table]
    acc = vals.new_zeros(len(gather.targets))
    for m in range(rows.shape[1]):
        acc = acc + rows[:, m]
    return flat.index_copy(0, gather.targets, acc).reshape(shape)


class PsiUpdateResult(NamedTuple):
    psi_r: torch.Tensor
    psi_i: torch.Tensor
    abs_sq_psi: torch.Tensor
    ok: torch.Tensor  # 0-d bool: discriminant nonnegative on valid sites


def implicit_euler_psi(
    sten,
    U,
    pr: torch.Tensor,
    pi: torch.Tensor,
    abs_sq_psi: torch.Tensor,
    mu: torch.Tensor,
    epsilon: torch.Tensor,
    gamma: float,
    u: float,
    dt,
) -> PsiUpdateResult:
    """One implicit-Euler update of the order parameter (split complex):
    the closed-form quadratic with the cancellation-free discriminant."""
    rdt = pr.dtype
    phase = mu * dt
    tr = torch.cos(phase)
    ti = -torch.sin(phase)   # U_t = tr + i ti
    half_g2 = 0.5 * gamma**2
    # z = U_t (gamma^2/2) psi
    zr = half_g2 * (tr * pr - ti * pi)
    zi = half_g2 * (tr * pi + ti * pr)
    lap_r, lap_i = covariant_laplacian(sten, U, pr, pi)
    coeff = (dt / u) * torch.sqrt(1.0 + gamma**2 * abs_sq_psi)
    gr = pr + coeff * ((epsilon - abs_sq_psi) * pr + lap_r)
    gi = pi + coeff * ((epsilon - abs_sq_psi) * pi + lap_i)
    # w = z |psi|^2 + U_t g
    wr = zr * abs_sq_psi + tr * gr - ti * gi
    wi = zi * abs_sq_psi + tr * gi + ti * gr
    c = wr * zr + wi * zi
    two_c_1 = 2.0 * c + 1.0
    w2 = wr * wr + wi * wi
    im_wz = wr * zi - wi * zr
    discriminant = 1.0 + 4.0 * c - 4.0 * im_wz**2
    valid = sten.valid.to(rdt)
    ok = torch.all(torch.where(valid > 0, discriminant, 1.0) >= 0.0)
    sqrt_disc = torch.sqrt(torch.clamp(discriminant, min=0.0))
    new_sq = (2.0 * w2) / (two_c_1 + sqrt_disc)
    new_r = (wr - zr * new_sq) * valid
    new_i = (wi - zi * new_sq) * valid
    return PsiUpdateResult(new_r, new_i, new_sq * valid, ok)


def poisson_rhs(
    sten,
    supercurrent: torch.Tensor,
    dA_dt: torch.Tensor,
    neumann_term: torch.Tensor,
) -> torch.Tensor:
    """RHS of the mu-Poisson equation: ``div(J_s - dA/dt) - N_bl @
    mu_boundary``, with the Neumann term pre-scattered
    (:func:`neumann_boundary_term`)."""
    return divergence_on_sites(sten, supercurrent - dA_dt) - neumann_term
