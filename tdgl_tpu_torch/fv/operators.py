"""Finite-volume operators of the unstructured (ELL) backend.

Copy of :mod:`tdgl_tpu.fv.operators` (host numpy, verbatim): the operators
are static gather tables in padded-row (ELL) form, built once on the host.

* Every site stores up to ``K`` (max degree) neighbor slots, each holding the
  neighbor site index, the connecting edge index, an orientation sign, and
  fixed weights. Padding slots have zero weight and point at the site itself.
* The covariant psi-operators' only A-dependence is the per-edge link phase
  ``exp(-i A.e)``, an elementwise function evaluated every step, with the
  sparsity pattern untouched.

:func:`tdgl_tpu_torch.convert.operators_to_torch` moves the tables onto a
device (index tables as ``int64``, once); :mod:`tdgl_tpu_torch.models.gtdgl`
applies them (gather, multiply, sum over the K slots).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .mesh import Mesh


class FVOperators(NamedTuple):
    """Static finite-volume operator tables for one mesh.

    All arrays are NumPy on construction; the solver device-puts them. Shapes:
    ``N`` sites, ``E`` edges, ``K`` max site degree, ``B`` boundary edges.
    """

    # mesh arrays
    sites: np.ndarray              # (N, 2) dimensionless site positions
    edges: np.ndarray              # (E, 2) int — canonical (lo, hi) site pairs
    edge_directions: np.ndarray    # (E, 2) r[hi] - r[lo] (unnormalized)
    edge_centers: np.ndarray       # (E, 2)
    edge_lengths: np.ndarray       # (E,)
    dual_edge_lengths: np.ndarray  # (E,)
    areas: np.ndarray              # (N,)
    # neighbor tables (ELL)
    nbr_site: np.ndarray           # (N, K) int — neighbor site per slot
    nbr_edge: np.ndarray           # (N, K) int — connecting edge per slot
    nbr_sign: np.ndarray           # (N, K) float — +1 if site is edges[e, 0]
    nbr_mask: np.ndarray           # (N, K) float — 1 for real slots, 0 for pad
    w_lap: np.ndarray              # (N, K) — (dual/len)/area_i per slot
    w_lap_rowsum: np.ndarray       # (N,) — sum_k w_lap (Laplacian diagonal)
    w_sym: np.ndarray              # (N, K) — dual/len per slot (symmetric S)
    w_sym_rowsum: np.ndarray       # (N,) — sum_k w_sym (diag of -S)
    w_div: np.ndarray              # (N, K) — sign*dual/area_i per slot
    # Neumann boundary scatter: term_i = sum_b vals * mu_boundary[col]
    boundary_edge_indices: np.ndarray  # (B,) int — edge index of boundary edges
    nbl_rows: np.ndarray           # (2B,) int site indices
    nbl_cols: np.ndarray           # (2B,) int boundary-edge ordinals
    nbl_vals: np.ndarray           # (2B,) float len_b / (2 a_i)
    # Dirichlet handling for psi
    fixed_sites: np.ndarray        # (F,) int — terminal site indices
    fixed_mask: np.ndarray         # (N,) float — 1.0 at fixed sites


def build_operators(
    mesh: Mesh,
    fixed_sites: Optional[np.ndarray] = None,
    dtype=np.float64,
) -> FVOperators:
    """Build the static FV operator tables for a mesh.

    Args:
        mesh: The finite-volume :class:`Mesh` (dimensionless coordinates).
        fixed_sites: Site indices whose psi rows become identity rows
            (Dirichlet at current terminals; reference
            ``operators.py:120-185``).
        dtype: Floating-point dtype for the weight arrays.
    """
    em = mesh.edge_mesh
    edges = np.asarray(em.edges, dtype=np.int32)
    n_sites = len(mesh.sites)
    n_edges = len(edges)
    areas = np.asarray(mesh.areas, dtype=dtype)
    edge_lengths = np.asarray(em.edge_lengths, dtype=dtype)
    dual = np.asarray(em.dual_edge_lengths, dtype=dtype)

    # Per-site incidence lists -> padded slots.
    degree = np.bincount(edges.ravel(), minlength=n_sites)
    K = int(degree.max())
    nbr_site = np.tile(np.arange(n_sites, dtype=np.int32)[:, None], (1, K))
    nbr_edge = np.zeros((n_sites, K), dtype=np.int32)
    nbr_sign = np.zeros((n_sites, K), dtype=dtype)
    nbr_mask = np.zeros((n_sites, K), dtype=dtype)
    slot = np.zeros(n_sites, dtype=np.int32)
    # Vectorized fill: sort incidence by site.
    inc_site = np.concatenate([edges[:, 0], edges[:, 1]])
    inc_nbr = np.concatenate([edges[:, 1], edges[:, 0]])
    inc_edge = np.tile(np.arange(n_edges, dtype=np.int32), 2)
    inc_sign = np.concatenate(
        [np.ones(n_edges, dtype), -np.ones(n_edges, dtype)]
    )
    order = np.argsort(inc_site, kind="stable")
    inc_site, inc_nbr = inc_site[order], inc_nbr[order]
    inc_edge, inc_sign = inc_edge[order], inc_sign[order]
    starts = np.concatenate([[0], np.cumsum(degree)[:-1]])
    slot = np.arange(len(inc_site)) - starts[inc_site]
    nbr_site[inc_site, slot] = inc_nbr
    nbr_edge[inc_site, slot] = inc_edge
    nbr_sign[inc_site, slot] = inc_sign
    nbr_mask[inc_site, slot] = 1.0

    w_edge = dual / edge_lengths  # Laplacian edge weight
    w_lap = (w_edge[nbr_edge] / areas[:, None]) * nbr_mask
    w_sym = w_edge[nbr_edge] * nbr_mask
    w_div = (dual[nbr_edge] / areas[:, None]) * nbr_sign * nbr_mask

    # Neumann boundary scatter arrays.
    b_ix = np.asarray(em.boundary_edge_indices, dtype=np.int32)
    b_edges = edges[b_ix]
    b_lengths = edge_lengths[b_ix]
    nbl_rows = np.concatenate([b_edges[:, 0], b_edges[:, 1]])
    nbl_cols = np.tile(np.arange(len(b_ix), dtype=np.int32), 2)
    nbl_vals = np.concatenate(
        [b_lengths / (2 * areas[b_edges[:, 0]]),
         b_lengths / (2 * areas[b_edges[:, 1]])]
    ).astype(dtype)

    if fixed_sites is None:
        fixed_sites = np.array([], dtype=np.int32)
    fixed_sites = np.asarray(fixed_sites, dtype=np.int32)
    fixed_mask = np.zeros(n_sites, dtype=dtype)
    fixed_mask[fixed_sites] = 1.0

    return FVOperators(
        sites=np.asarray(mesh.sites, dtype=dtype),
        edges=edges,
        edge_directions=np.asarray(em.directions, dtype=dtype),
        edge_centers=np.asarray(em.centers, dtype=dtype),
        edge_lengths=edge_lengths,
        dual_edge_lengths=dual,
        areas=areas,
        nbr_site=nbr_site,
        nbr_edge=nbr_edge,
        nbr_sign=nbr_sign,
        nbr_mask=nbr_mask,
        w_lap=w_lap,
        w_lap_rowsum=w_lap.sum(axis=1),
        w_sym=w_sym,
        w_sym_rowsum=w_sym.sum(axis=1),
        w_div=w_div,
        boundary_edge_indices=b_ix,
        nbl_rows=nbl_rows,
        nbl_cols=nbl_cols,
        nbl_vals=nbl_vals,
        fixed_sites=fixed_sites,
        fixed_mask=fixed_mask,
    )


# ---------------------------------------------------------------------------
# SciPy reference implementations, used by tests to validate the ELL tables
# against the textbook sparse-matrix definitions.
# ---------------------------------------------------------------------------

def divergence_matrix(op: FVOperators):
    """SciPy CSR divergence (edges -> sites), for verification."""
    import scipy.sparse as sp

    e0, e1 = op.edges[:, 0], op.edges[:, 1]
    rows = np.concatenate([e0, e1])
    cols = np.tile(np.arange(len(op.edges)), 2)
    vals = np.concatenate(
        [op.dual_edge_lengths / op.areas[e0],
         -op.dual_edge_lengths / op.areas[e1]]
    )
    return sp.csr_array((vals, (rows, cols)),
                        shape=(len(op.areas), len(op.edges)))


def laplacian_matrix(op: FVOperators, link_phases: Optional[np.ndarray] = None,
                     fix_psi: bool = False):
    """SciPy CSR covariant Laplacian (sites -> sites), for verification."""
    import scipy.sparse as sp

    n = len(op.areas)
    e0, e1 = op.edges[:, 0], op.edges[:, 1]
    w = op.dual_edge_lengths / op.edge_lengths
    u = np.ones(len(op.edges), dtype=complex) if link_phases is None \
        else link_phases
    rows = np.concatenate([e0, e1, e0, e1])
    cols = np.concatenate([e1, e0, e0, e1])
    vals = np.concatenate([
        w * u / op.areas[e0],
        w * u.conjugate() / op.areas[e1],
        -w / op.areas[e0],
        -w / op.areas[e1],
    ])
    if fix_psi and len(op.fixed_sites):
        keep = ~np.isin(rows, op.fixed_sites)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        rows = np.concatenate([rows, op.fixed_sites])
        cols = np.concatenate([cols, op.fixed_sites])
        vals = np.concatenate([vals, np.ones(len(op.fixed_sites))])
    return sp.csr_array((vals, (rows, cols)), shape=(n, n))
