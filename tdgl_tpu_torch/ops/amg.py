"""Two-level aggregation multigrid preconditioner for the mu-Poisson solve
on the unstructured (ELL) backend.

Port of :mod:`tdgl_tpu.ops.amg`: an unsmoothed-aggregation two-level
preconditioner.

* **Set-up (host, once per mesh)**, :func:`build_amg`, copied verbatim:
  greedy aggregation of sites into clusters on the Laplacian graph; the
  coarse Galerkin operator ``Ac = P^T A P`` (piecewise-constant P) is
  formed and pseudo-inverted densely, which projects the coarse null space
  (the constants) out exactly.
* **Apply (device, inside CG)**, :func:`make_amg_apply`: the symmetric
  V-cycle ``Jacobi pre-smooth -> coarse correction -> Jacobi
  post-smooth``. The restriction sums each aggregate's members through a
  host-built table (:class:`AMGTensors`, ``members``), in site order, so
  no atomics are involved; the prolongation is a gather and the coarse
  solve a dense ``(nc, nc) @ (nc,)`` product. A ``(B, N)`` residual (the
  members of a sweep) runs the same cycle per member.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AMGData(NamedTuple):
    """Host arrays of the two-level preconditioner (:func:`build_amg`).

    The damped-Jacobi weight ``omega`` is not a field; it is passed to
    :func:`make_amg_apply`."""

    cluster_ids: np.ndarray   # (N,) int32 — aggregate of each site
    Ac_inv: np.ndarray        # (nc, nc) — dense pseudo-inverse of P^T A P
    inv_diag: np.ndarray      # (N,) — 1 / diag(A)


class AMGTensors(NamedTuple):
    """:class:`AMGData` on a device
    (:func:`tdgl_tpu_torch.convert.amg_to_torch`), plus the restriction's
    gather table."""

    cluster_ids: torch.Tensor  # (N,) int64
    Ac_inv: torch.Tensor       # (nc, nc), working dtype
    inv_diag: torch.Tensor     # (N,), working dtype
    members: torch.Tensor      # (nc, M) int64 — member sites in increasing
                               # order, padded with N (a zero appended)


def build_amg(op, coarsening: int = 32,
              dtype=np.float32) -> AMGData:
    """Build the two-level hierarchy for the operator ``A = -S`` (the
    symmetric Neumann FV Laplacian of :mod:`tdgl_tpu_torch.models.gtdgl`).

    Args:
        op: Host :class:`~tdgl_tpu_torch.fv.operators.FVOperators`.
        coarsening: Target fine-to-coarse size ratio (aggregate size).
    """
    import scipy.sparse as sp

    n = len(op.areas)
    e0 = np.asarray(op.edges[:, 0], dtype=np.int64)
    e1 = np.asarray(op.edges[:, 1], dtype=np.int64)
    w = np.asarray(op.dual_edge_lengths / op.edge_lengths, dtype=np.float64)
    rows = np.concatenate([e0, e1, e0, e1])
    cols = np.concatenate([e1, e0, e0, e1])
    vals = np.concatenate([-w, -w, w, w])  # A = -S (PSD)
    A = sp.csr_array((vals, (rows, cols)), shape=(n, n))

    # Greedy aggregation by strongest available connection, BFS-ordered so
    # aggregates are contiguous patches.
    indptr, indices = A.indptr, A.indices
    cluster = -np.ones(n, dtype=np.int64)
    next_cluster = 0
    order = np.argsort(-A.diagonal())  # seed from stiff regions first
    for seed in order:
        if cluster[seed] >= 0:
            continue
        members = [seed]
        cluster[seed] = next_cluster
        frontier = [seed]
        while frontier and len(members) < coarsening:
            new_frontier = []
            for u in frontier:
                for v in indices[indptr[u]:indptr[u + 1]]:
                    if cluster[v] < 0 and len(members) < coarsening:
                        cluster[v] = next_cluster
                        members.append(v)
                        new_frontier.append(v)
            frontier = new_frontier
        next_cluster += 1
    nc = next_cluster

    # Galerkin coarse operator Ac = P^T A P with piecewise-constant P.
    P = sp.csr_array(
        (np.ones(n), (np.arange(n), cluster)), shape=(n, nc)
    )
    Ac = np.asarray((P.T @ A @ P).todense())
    # Deflate the constant null space exactly, then pseudo-invert.
    Ac_inv = np.linalg.pinv(Ac, rcond=1e-12)

    diag = np.asarray(A.diagonal())
    inv_diag = 1.0 / np.maximum(diag, 1e-300)
    return AMGData(
        cluster_ids=cluster.astype(np.int32),
        Ac_inv=Ac_inv.astype(dtype),
        inv_diag=inv_diag.astype(dtype),
    )


def make_amg_apply(amg_omega: float):
    """Returns the V-cycle apply ``(apply_A, amg, r) -> z`` for an
    :class:`AMGTensors` ``amg`` in the dtype of ``r``."""

    def apply_amg(apply_A, amg, r):
        rdtype = r.dtype
        inv_diag = amg.inv_diag.to(rdtype)
        # Pre-smooth.
        x = amg_omega * inv_diag * r
        # Coarse correction.
        r2 = r - apply_A(x)
        if r.dim() == 1:
            rc = torch.sum(torch.cat([r2, r2.new_zeros(1)])[amg.members],
                           dim=1)
            xc = amg.Ac_inv.to(rdtype) @ rc
        else:
            # (B, N) members: the same gathers and one matmul for all.
            pad = torch.cat([r2, r2.new_zeros(r2.shape[0], 1)], dim=1)
            rc = torch.sum(pad[:, amg.members], dim=-1)
            xc = rc @ amg.Ac_inv.to(rdtype).T
        x = x + xc[..., amg.cluster_ids]
        # Post-smooth (symmetric cycle).
        r3 = r - apply_A(x)
        x = x + amg_omega * inv_diag * r3
        return x

    return apply_amg
