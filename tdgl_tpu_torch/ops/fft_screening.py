"""Screening (induced vector potential) as an exact FFT convolution, in
PyTorch.

Port of :mod:`tdgl_tpu.ops.fft_screening` without its DFT-matmul (``mxu``)
variants. On a structured lattice mesh the pairwise sum
``A[e] = sum_s J_w[s] / |r_e - r_s|`` is a translation-invariant
convolution per edge class (the distance depends only on the index
displacement), computed exactly with zero-padded real FFTs
(``torch.fft``, cuFFT on the card) in O(N log N). Masked and padded sites
carry zero weight.

The kernels' spectra are built on the host once per mesh
(:func:`build_fft_screening`, a copy of the JAX package's function) and
kept as complex tensors: the JAX package splits them into real and
imaginary arrays because its TPU runtime faults on complex multiplies,
which this package has no reason to do. :func:`build_site_interp_taps` is
copied as it is, so both packages use the same tap tuple.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..device.hexmesh import EDGE_OFFSETS

logger = logging.getLogger(__name__)


class FFTScreeningData(NamedTuple):
    """Precomputed convolution kernels: the rfft2 spectra of the per-edge-
    class ``1/dist`` kernels on the zero-padding-doubled grid, ``Ghat``
    ``(3, 2*Rp, Cp + 1)``, and of the site-evaluation kernel (``1/dist``
    between lattice points, zero origin tap), ``G0hat`` ``(2*Rp, Cp + 1)``,
    as complex arrays (numpy from :func:`build_fft_screening`; tensors after
    :func:`tdgl_tpu_torch.convert.fft_screening_to_torch`)."""

    Ghat: object
    G0hat: object


def _displacements(Rp: int, Cp: int, h: float):
    """Cartesian displacement of every index displacement, in circular-
    convolution layout (bin i is displacement i for i < Rp and i - 2Rp
    for i >= Rp)."""
    R2, C2 = 2 * Rp, 2 * Cp
    dr = np.arange(R2)
    dr = np.where(dr >= Rp, dr - R2, dr).astype(np.float64)
    dc = np.arange(C2)
    dc = np.where(dc >= Cp, dc - C2, dc).astype(np.float64)
    DR, DC = np.meshgrid(dr, dc, indexing="ij")
    # Lattice map: pos(r, c) = origin + ((c + r/2) h, r (sqrt(3)/2) h).
    dx = (DC + 0.5 * DR) * h
    dy = DR * (np.sqrt(3) / 2) * h
    return dx, dy


def build_fft_screening(sten, maps, grid, dtype=np.float32
                        ) -> FFTScreeningData:
    """Build the per-edge-class convolution kernels for a structured mesh
    (host numpy, the JAX package's arithmetic).

    Args:
        sten: Host :class:`StencilOperators` (for ``edge_dirs``).
        maps: :class:`GridMaps` (padded shape).
        grid: The mesh's :class:`HexGrid` (dimensionless spacing).
        dtype: Real dtype of the solve (sets the spectrum precision).
    """
    Rp, Cp = maps.shape
    h = float(grid.spacing)
    dx, dy = _displacements(Rp, Cp, h)
    rdt = np.float64 if dtype == np.float64 else np.float32
    cdt = np.complex128 if rdt == np.float64 else np.complex64
    dirs = np.asarray(sten.edge_dirs, np.float64)  # (3, 2), length h
    G = np.empty((3,) + dx.shape, rdt)
    for k in range(3):
        # A[e] = sum_s G[e - s] Jw[s] with G[delta] =
        # 1/|L(delta) + e_k/2| (ec(e) - pos(s) for delta = e - s).
        ox, oy = 0.5 * dirs[k]
        dist = np.sqrt((ox + dx) ** 2 + (oy + dy) ** 2)
        # Never singular: edge centers are never lattice points.
        G[k] = (1.0 / dist).astype(rdt)
    Ghat = np.fft.rfft2(G, axes=(1, 2))
    # Site-evaluation kernel: distances between LATTICE POINTS, with a
    # zero origin tap (the near field is carried by the tap stencils).
    dist0 = np.sqrt(dx**2 + dy**2)
    dist0[0, 0] = np.inf
    G0hat = np.fft.rfft2((1.0 / dist0).astype(rdt))
    # Real and imaginary parts rounded separately, as the JAX package
    # stores them.
    return FFTScreeningData(Ghat=_split_round(Ghat, rdt, cdt),
                            G0hat=_split_round(G0hat, rdt, cdt))


def _split_round(spectrum, rdt, cdt) -> np.ndarray:
    out = np.empty(spectrum.shape, cdt)
    out.real = spectrum.real.astype(rdt)
    out.imag = spectrum.imag.astype(rdt)
    return out


def _convolve(spectrum: torch.Tensor, J_weighted: torch.Tensor
              ) -> torch.Tensor:
    """``irfft2(spectrum * rfft2(zero-padded J))`` cropped to the
    unaliased quadrant, for ``J_weighted`` ``(..., Rp, Cp, 2)`` (any
    leading member axes): ``(..., 3, 2, Rp, Cp)`` for the per-class
    spectrum ``(3, 2*Rp, Cp + 1)``, ``(..., 2, Rp, Cp)`` for the site
    spectrum ``(2*Rp, Cp + 1)``. The spectrum is shared by all members."""
    Rp, Cp = J_weighted.shape[-3:-1]
    s = (2 * Rp, 2 * Cp)
    # (..., 2, 2Rp, Cp+1)
    Jhat = torch.fft.rfft2(J_weighted.movedim(-1, -3), s=s)
    if spectrum.dim() == 3:
        Jhat = Jhat.unsqueeze(-4)
    A = torch.fft.irfft2(spectrum.unsqueeze(-3) * Jhat, s=s)
    return A[..., :Rp, :Cp]


def induced_vector_potential_fft(fft_data: FFTScreeningData, sten,
                                 J_weighted: torch.Tensor) -> torch.Tensor:
    """Induced vector potential on all edge classes via FFT convolution.

    Args:
        fft_data: :class:`FFTScreeningData` of tensors for this mesh.
        sten: :class:`StencilOperators` (tensors; for the edge mask).
        J_weighted: ``(Rp, Cp, 2)`` site current density times site area
            and physical prefactor (zero at masked sites), or a ``(B, Rp,
            Cp, 2)`` batch of members (one batched transform each way).

    Returns:
        ``(3, Rp, Cp, 2)`` (or ``(B, 3, Rp, Cp, 2)``) induced vector
        potential at edge centers (zero at masked edges), in
        ``J_weighted``'s dtype.
    """
    A = _convolve(fft_data.Ghat, J_weighted).movedim(-3, -1)
    return (A * sten.edge_valid[..., None].to(A.dtype)).to(J_weighted.dtype)


# Cubic midpoint-interpolation weights along the edge direction:
# value at s + off/2 from samples at s + j*off, j in {-1, 0, 1, 2}.
_CUBIC_W = ((-1, -1.0 / 16), (0, 9.0 / 16), (1, 9.0 / 16), (2, -1.0 / 16))


def build_site_interp_taps(sten, maps, grid, n_taps: int = 12):
    """Per-edge-class correction stencils for the site-evaluated path (a
    copy of the JAX package's function: the same tuple).

    The site path approximates the exact per-class convolution ``G_k * J``
    by ``H_k * J`` with ``H_k`` the cubic midpoint interpolation of the
    site kernel ``G0``. The ``n_taps`` largest-magnitude taps of ``D_k =
    G_k - H_k`` per class are kept exactly and the remaining tail's sum is
    folded onto the origin tap. Returns ``((((dr, dc), value), ...) x 3)``,
    or ``None`` when the valid region sits too close to the padded-grid
    boundary for the tap/interp rolls to be wrap-safe. Like the JAX
    function it scans only the ``4 * n_taps`` largest entries, so a tight
    mesh can keep fewer than ``n_taps`` taps; that is logged as a warning.
    """
    Rp, Cp = maps.shape
    h = float(grid.spacing)
    R2, C2 = 2 * Rp, 2 * Cp
    dx, dy = _displacements(Rp, Cp, h)
    dirs = np.asarray(sten.edge_dirs, np.float64)
    dist0 = np.sqrt(dx**2 + dy**2)
    dist0[0, 0] = np.inf
    G0 = 1.0 / dist0

    valid = np.asarray(sten.valid, bool)
    rows = np.where(valid.any(axis=1))[0]
    cols = np.where(valid.any(axis=0))[0]
    if len(rows) == 0:
        return None
    m_lo, m_hi = int(rows.min()), int(Rp - 1 - rows.max())
    m_cl, m_ch = int(cols.min()), int(Cp - 1 - cols.max())

    def tap_safe(a, b):
        # A wrap on an axis is harmful only when the offset exceeds both
        # margins of that axis.
        return (abs(a) <= max(m_lo, m_hi)) and (abs(b) <= max(m_cl, m_ch))

    def interp_safe(p, q):
        # Interpolation reads must stay in-grid for the whole valid region.
        return (((-p) <= m_lo if p < 0 else p <= m_hi)
                and ((-q) <= m_cl if q < 0 else q <= m_ch))

    taps = []
    for k, (orr, occ) in enumerate(EDGE_OFFSETS):
        for j, _w in _CUBIC_W:
            if not interp_safe(j * orr, j * occ):
                return None
        ox, oy = 0.5 * dirs[k]
        Gk = 1.0 / np.sqrt((ox + dx) ** 2 + (oy + dy) ** 2)
        Hk = np.zeros_like(G0)
        for j, w in _CUBIC_W:
            Hk += w * np.roll(G0, (-j * orr, -j * occ), axis=(0, 1))
        D = Gk - Hk
        order = np.argsort(np.abs(D).ravel())[::-1]
        chosen = []
        tail = float(D.sum())
        for flat in order[: 4 * n_taps]:
            if len(chosen) >= n_taps:
                break
            a = int(flat // C2)
            b = int(flat % C2)
            sa = a if a < Rp else a - R2
            sb = b if b < Cp else b - C2
            if not tap_safe(sa, sb):
                continue
            chosen.append(((sa, sb), float(D[a, b])))
            tail -= float(D[a, b])
        if len(chosen) < n_taps:
            logger.warning(
                "build_site_interp_taps: edge class %d keeps %d of %d taps"
                " (the others are not wrap-safe on this mesh); the site-"
                "evaluated screening residual grows accordingly.", k,
                len(chosen), n_taps)
        # Fold the uncorrected tail onto the origin tap (moment match).
        chosen = [((a, b), v + (tail if (a, b) == (0, 0) else 0.0))
                  for (a, b), v in chosen]
        if not any(ab == (0, 0) for ab, _ in chosen):
            chosen.append(((0, 0), tail))
        taps.append(tuple(chosen))
    return tuple(taps)


def _interp_site_to_edges(sten, A_site: torch.Tensor,
                          J_weighted: torch.Tensor, taps) -> torch.Tensor:
    """Cubic-interpolate site potentials ``(..., Rp, Cp, 2)`` onto the 3
    edge classes and add the exact near-field tap corrections
    (:func:`build_site_interp_taps`); same operation order as the JAX
    package. ``torch.roll`` shifts like ``jnp.roll``."""
    outs = []
    for k, (dr, dc) in enumerate(EDGE_OFFSETS):
        acc = None
        for j, w in _CUBIC_W:
            term = torch.roll(A_site, (-j * dr, -j * dc), dims=(-3, -2))
            acc = w * term if acc is None else acc + w * term
        for (a, b), v in taps[k]:
            acc = acc + v * torch.roll(J_weighted, (a, b), dims=(-3, -2))
        outs.append(acc)
    A = torch.stack(outs, dim=-4)                   # (..., 3, Rp, Cp, 2)
    return A * sten.edge_valid[..., None].to(A.dtype)


def induced_vector_potential_fft_site(fft_data: FFTScreeningData, sten,
                                      J_weighted: torch.Tensor, taps
                                      ) -> torch.Tensor:
    """Site-evaluated variant of :func:`induced_vector_potential_fft`:
    the induced potential at the lattice sites with one kernel, cubic-
    interpolated to the 3 edge classes and corrected in the near field
    with the static tap stencils ``taps`` (1/3 of the inverse transforms).
    Residual ~3e-4 relative for smooth currents (the JAX package's
    measurement), the float32 screening floor's order. Takes a batch as
    :func:`induced_vector_potential_fft` does."""
    A_site = _convolve(fft_data.G0hat, J_weighted).movedim(-3, -1)
    return _interp_site_to_edges(sten, A_site, J_weighted,
                                 taps).to(J_weighted.dtype)
