"""Induced-vector-potential kernel for magnetic screening: the pairwise sum.

Port of :mod:`tdgl_tpu.ops.screening`. ``A_induced[e] = sum_s J[s] a_s /
|r_e - r_s|`` as a dense O(E x S) sum, blocked over edges so the
``(block, S)`` distance intermediate stays small. It is the ``"xla"``
screening kernel of the solver and the oracle of the FFT path
(:mod:`tdgl_tpu_torch.ops.fft_screening`). Distances are direct
differences (the Gram-matrix identity loses float32 precision on devices
much larger than the mesh spacing).
"""

from __future__ import annotations

import torch


def induced_vector_potential(
    edge_centers: torch.Tensor,
    sites: torch.Tensor,
    J_weighted: torch.Tensor,
    block_size: int = 256,
) -> torch.Tensor:
    """Compute ``A[e, c] = sum_s J_weighted[s, c] / |r_e - r_s|``.

    Args:
        edge_centers: ``(E, 2)`` edge-center positions.
        sites: ``(S, 2)`` site positions, all different from every edge
            center (true on a triangular mesh).
        J_weighted: ``(S, 2)`` current density times site area (and any
            physical prefactor).
        block_size: Edge-block size; bounds the (block, S) intermediate.

    Returns:
        ``(E, 2)`` induced vector potential, in ``J_weighted``'s dtype.
    """
    dtype = J_weighted.dtype
    edge_centers = edge_centers.to(dtype)
    sites = sites.to(dtype)
    tiny = torch.finfo(dtype).tiny
    out = []
    for start in range(0, edge_centers.shape[0], block_size):
        ec = edge_centers[start:start + block_size]
        dx = ec[:, 0, None] - sites[None, :, 0]
        dy = ec[:, 1, None] - sites[None, :, 1]
        inv_d = torch.rsqrt(torch.clamp(dx * dx + dy * dy, min=tiny))
        out.append(inv_d @ J_weighted)
    return torch.cat(out) if out else J_weighted.new_zeros((0, 2))
