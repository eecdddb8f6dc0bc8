"""Deep smoothed-aggregation multigrid for the stencil (hex-grid) backend.

Port of :mod:`tdgl_tpu.ops.hexmg`. The hierarchy is built on the host
(numpy/scipy, :func:`build_hexmg`) by 2x2 piecewise-constant aggregation
with smoothed prolongation ``P = (I - omega D^+ A) P0``; every level's
Galerkin operator is a small offset stencil — a static list of (dr, dc)
offsets with one dense (R_l, C_l) weight plane each — and every transfer
is a reshape-sum / broadcast plus one stencil apply. The coarsest level is
a dense pseudo-inverse. :func:`convert.hexmg_to_torch` moves the level
arrays onto a device; :func:`make_hexmg_apply` is the V-cycle, run in the
working dtype, on one ``(R, C)`` grid or on a batch ``(B, R, C)`` of
independent right-hand sides (the members of a sweep) at once.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class HexMGData:
    """Multigrid hierarchy.

    Attributes:
        level_arrays: Per level ``dict(W=(K, R, C), inv_diag=(R, C))``; the
            coarsest level instead holds ``dict(Ainv=(nc, nc))``. numpy
            float32 from :func:`build_hexmg`, tensors after
            :func:`tdgl_tpu_torch.convert.hexmg_to_torch`.
        offsets: Per level, a static tuple of (dr, dc) stencil offsets
            matching ``W``'s leading axis.
        shapes: Per level, the (R, C) grid shape.
        p_omega: Per-level P-smoothing weight (0 = PWC).
    """

    def __init__(self, level_arrays: List[dict],
                 offsets: Tuple[Tuple[Tuple[int, int], ...], ...],
                 shapes: Tuple[Tuple[int, int], ...],
                 p_omega: Tuple[float, ...] = ()):
        self.level_arrays = level_arrays
        self.offsets = offsets
        self.shapes = shapes
        self.p_omega = p_omega


def _pwc_P(R: int, C: int):
    import scipy.sparse as sp

    r = np.arange(R * C) // C
    c = np.arange(R * C) % C
    coarse = (r // 2) * (C // 2) + (c // 2)
    return sp.csr_array(
        (np.ones(R * C), (np.arange(R * C), coarse)),
        shape=(R * C, (R // 2) * (C // 2)),
    )


def _extract_offset_stencil(A, R: int, C: int):
    """Sparse (R*C, R*C) operator -> (offsets, W[K, R, C]) offset stencil."""
    coo = A.tocoo()
    rows, cols, vals = coo.row, coo.col, coo.data
    dr = cols // C - rows // C
    dc = cols % C - rows % C
    # Wrap-free: offsets are genuine grid displacements only if no entry
    # crosses a row boundary "the wrong way"; Galerkin products of local
    # stencils guarantee |dc| small, so col-index arithmetic is exact.
    base = 100  # offsets are O(1); shift to positive for exact decoding
    assert np.abs(dr).max() < base and np.abs(dc).max() < base
    keys = (dr.astype(np.int64) + base) * (2 * base) + (
        dc.astype(np.int64) + base
    )
    uniq = np.unique(keys)
    offsets = []
    W = np.zeros((len(uniq), R, C), dtype=np.float32)
    for i, k in enumerate(uniq):
        sel = keys == k
        d_r = int(k) // (2 * base) - base
        d_c = int(k) % (2 * base) - base
        offsets.append((d_r, d_c))
        W[i].reshape(-1)[rows[sel]] = vals[sel]
    return tuple(offsets), W


def build_hexmg(
    sten,
    maps,
    mesh,
    p_omega: float = 0.67,
    min_coarse: int = 2048,
    max_levels: int = 8,
    smooth_levels: int = 3,
) -> HexMGData:
    """Build the smoothed-aggregation hierarchy for ``A = -S`` (numpy level
    arrays, float32).

    Args:
        sten: Host :class:`StencilOperators`.
        maps: :class:`GridMaps`.
        mesh: The structured mesh (edge graph source).
        p_omega: Prolongation-smoothing weight in ``(I - omega D^+ A) P0``.
        min_coarse: Solve directly (dense pseudo-inverse) once a level has
            at most this many grid nodes.
        smooth_levels: Smooth the prolongation only on the finest this-many
            levels; PWC below.
    """
    import scipy.sparse as sp

    Rp, Cp = maps.shape
    n_flat = Rp * Cp
    em = mesh.edge_mesh
    edges = np.asarray(em.edges, np.int64)
    wgt = np.asarray(em.dual_edge_lengths / em.edge_lengths, np.float64)
    gf = maps.site_flat
    e0, e1 = gf[edges[:, 0]], gf[edges[:, 1]]
    A = sp.csr_array(
        (np.concatenate([-wgt, -wgt, wgt, wgt]),
         (np.concatenate([e0, e1, e0, e1]),
          np.concatenate([e1, e0, e0, e1]))),
        shape=(n_flat, n_flat),
    )

    level_arrays: List[dict] = []
    offsets_all: List[Tuple[Tuple[int, int], ...]] = []
    shapes: List[Tuple[int, int]] = []
    p_omegas: List[float] = []
    R, C = Rp, Cp
    for lvl in range(max_levels):
        if R * C <= min_coarse or R % 2 or C % 2 or min(R, C) < 8:
            break
        d = A.diagonal()
        dinv = np.where(d > 1e-12, 1.0 / np.maximum(d, 1e-30), 0.0)
        offs, W = _extract_offset_stencil(A, R, C)
        level_arrays.append(dict(
            W=W,
            inv_diag=dinv.reshape(R, C).astype(np.float32),
        ))
        offsets_all.append(offs)
        shapes.append((R, C))
        om_l = p_omega if lvl < smooth_levels else 0.0
        p_omegas.append(om_l)
        P0 = _pwc_P(R, C)
        if om_l:
            P = P0 - om_l * (sp.diags_array(dinv) @ (A @ P0))
        else:
            P = P0
        A = (P.T @ A @ P).tocsr()
        A.eliminate_zeros()
        R //= 2
        C //= 2
    # Coarsest: dense pseudo-inverse (constant null space removed exactly).
    Ad = np.asarray(A.todense())
    level_arrays.append(dict(
        Ainv=np.linalg.pinv(Ad, rcond=1e-10).astype(np.float32),
    ))
    offsets_all.append(())
    shapes.append((R, C))
    return HexMGData(level_arrays, tuple(offsets_all), tuple(shapes),
                     p_omega=tuple(p_omegas))


def level_apply(mg: HexMGData, lvl: int, x: torch.Tensor) -> torch.Tensor:
    """Offset-stencil matvec at hierarchy level ``lvl``.

    Every level operator is symmetric (Galerkin products of the symmetric
    fine operator), so ``W_{-d}[r, c] = W_d[r - dr, c - dc]``: only the
    canonical half of the weight planes is read, and the mirrored term is
    ``y += shift_{-d}(W_d ⊙ x)`` (zero-filled shifts, one shared padded
    buffer), in the JAX package's summation order.
    """
    W = mg.level_arrays[lvl]["W"].to(x.dtype)
    offs = mg.offsets[lvl]
    R, C = x.shape[-2:]
    pr = max(max(abs(dr) for dr, _ in offs), 1)
    pc = max(max(abs(dc) for _, dc in offs), 1)
    xp = F.pad(x, (pc, pc, pr, pr))
    acc = torch.zeros_like(x)
    idx = {o: i for i, o in enumerate(offs)}
    if not all((-a, -b) in idx for (a, b) in offs):
        raise ValueError(f"level {lvl} stencil is not symmetric")
    if (0, 0) in idx:
        acc = acc + W[idx[(0, 0)]] * x
    canon = [d for d in offs if d > (0, 0)]
    # One stacked pad for all mirrored products.
    prods = torch.stack([W[idx[d]] * x for d in canon])
    pp = F.pad(prods, (pc, pc, pr, pr))
    for i, (dr, dc) in enumerate(canon):
        acc = acc + W[idx[(dr, dc)]] * xp[..., pr + dr:pr + dr + R,
                                          pc + dc:pc + dc + C]
        # y[r, c] += W_{-d}[r, c] x[r-dr, c-dc] = (W_d ⊙ x)[r-dr, c-dc]
        acc = acc + pp[i, ..., pr - dr:pr - dr + R, pc - dc:pc - dc + C]
    return acc


def make_hexmg_apply(amg_omega: float):
    """Returns the V-cycle apply ``(mg, r) -> z`` in ``r``'s dtype: one
    ``amg_omega``-damped Jacobi sweep before and after each coarse-grid
    correction.
    """

    def block_sum(mg, lvl, r):
        """2x2 block-sum restriction."""
        R, C = mg.shapes[lvl]
        return r.reshape(r.shape[:-2] + (R // 2, 2, C // 2, 2)).sum(
            dim=(-3, -1))

    def block_broadcast(mg, lvl, xc):
        """Transpose of :func:`block_sum` (2x2 broadcast)."""
        return torch.repeat_interleave(
            torch.repeat_interleave(xc, 2, dim=-2), 2, dim=-1)

    def smooth_P_T(mg, lvl, r):
        """P^T r = P0^T (r - omega_p A (D^+ r)) then 2x2 block sum."""
        om_p = mg.p_omega[lvl]
        if om_p:
            inv_diag = mg.level_arrays[lvl]["inv_diag"].to(r.dtype)
            r = r - om_p * level_apply(mg, lvl, inv_diag * r)
        return block_sum(mg, lvl, r)

    def smooth_P(mg, lvl, xc):
        """P xc = (I - omega_p D^+ A) (2x2 broadcast of xc)."""
        om_p = mg.p_omega[lvl]
        up = block_broadcast(mg, lvl, xc)
        if om_p:
            inv_diag = mg.level_arrays[lvl]["inv_diag"].to(xc.dtype)
            up = up - om_p * (inv_diag * level_apply(mg, lvl, up))
        return up

    omega = float(amg_omega)

    def cycle(mg: HexMGData, lvl: int, b: torch.Tensor) -> torch.Tensor:
        lev = mg.level_arrays[lvl]
        if "Ainv" in lev:
            R, C = mg.shapes[lvl]
            Ainv = lev["Ainv"].to(b.dtype)
            if b.dim() == 2:
                return (Ainv @ b.reshape(-1)).reshape(R, C)
            # One matmul for all members.
            return (b.reshape(b.shape[0], -1) @ Ainv.T).reshape(b.shape)
        inv_diag = lev["inv_diag"].to(b.dtype)
        x = omega * inv_diag * b
        r = b - level_apply(mg, lvl, x)
        xc = cycle(mg, lvl + 1, smooth_P_T(mg, lvl, r))
        x = x + smooth_P(mg, lvl, xc)
        r = b - level_apply(mg, lvl, x)
        return x + omega * inv_diag * r

    def apply_mg(mg: HexMGData, r: torch.Tensor) -> torch.Tensor:
        return cycle(mg, 0, r)

    return apply_mg
