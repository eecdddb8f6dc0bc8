"""Electromagnetics utilities: field conversion, Biot-Savart, current loops.

Copied from :mod:`tdgl_tpu.em` (numpy and scipy only). API parity with the
reference ``tdgl/em.py`` (``convert_field:14``, ``biot_savart:113``,
``biot_savart_2d:252``, ``current_loop_vector_potential:339``,
``current_loop_field:390``, ``uniform_Bz_vector_potential:437``); the
pairwise sums are numpy computations chunked over evaluation points.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
from scipy import special

from .utils.units import Quantity, ureg

MU_0 = 1.25663706212e-06  # vacuum permeability [H/m]


def convert_field(
    value: Union[np.ndarray, float, str, Quantity],
    new_units: str,
    old_units: Optional[str] = None,
    ureg=ureg,
    with_units: bool = True,
):
    """Convert between magnetic field H ([current]/[length]) and flux density
    B = mu0*H ([mass]/([current][time]^2)) representations and units."""
    if isinstance(value, str):
        parts = value.split(maxsplit=1)
        if len(parts) == 2:
            value = float(parts[0]) * ureg(parts[1])
        else:
            value = ureg(value)
    if isinstance(value, Quantity):
        quantity = value
    else:
        if old_units is None:
            raise ValueError(
                "old_units must be given if value is not a str or Quantity."
            )
        quantity = value * ureg(old_units)
    target = ureg(new_units)
    if target.dims == quantity.dims:
        out = quantity.to(new_units)
    elif quantity.dims[0] < target.dims[0]:
        # quantity is H ([current]/[length], length exponent -1) and the
        # target is B (length exponent 0): B = mu0 * H
        out = (quantity * ureg("mu_0")).to(new_units)
    else:
        # quantity is B, target is H: H = B / mu0
        out = (quantity / ureg("mu_0")).to(new_units)
    if not with_units:
        return out.magnitude
    return out


def uniform_Bz_vector_potential(
    positions: np.ndarray,
    Bz: Union[float, Quantity],
) -> Quantity:
    """Vector potential ``A = (B x r)/2`` of a uniform field ``B = Bz z_hat``,
    evaluated at ``positions`` (in meters). Returns units of T*m."""
    positions = np.atleast_2d(positions)
    if isinstance(Bz, Quantity):
        Bz = Bz.to("T").magnitude
    A = 0.5 * np.stack(
        [-Bz * positions[:, 1], Bz * positions[:, 0],
         np.zeros(len(positions))],
        axis=1,
    )
    return Quantity.from_units(A, "T * m")


def biot_savart(
    eval_positions: np.ndarray,
    *,
    current_positions: np.ndarray,
    current_vectors: np.ndarray,
    currents: np.ndarray,
) -> Quantity:
    """Magnetic field (T) at ``eval_positions`` from 1D current elements.

    All inputs in meters / amperes. Vectorized over both axes.
    """
    r_eval = np.atleast_2d(eval_positions)[:, None, :]  # (n, 1, 3)
    r_cur = np.atleast_2d(current_positions)[None, :, :]  # (1, m, 3)
    I_dl = (np.atleast_1d(currents)[:, None]
            * np.atleast_2d(current_vectors))[None, :, :]  # (1, m, 3)
    r = r_eval - r_cur  # (n, m, 3)
    dr = np.linalg.norm(r, axis=2, keepdims=True)
    B = MU_0 / (4 * np.pi) * np.sum(np.cross(I_dl, r) / dr**3, axis=1)
    return Quantity.from_units(B, "tesla")


def _sheet_field_kernel(eval_positions, positions, current_densities, areas,
                        vector: bool):
    """B(r) = mu0/4pi * int [3(J x z_hat terms)...] over sheet elements.

    Uses the standard Biot-Savart kernel for a sheet current K at z=z0:
    ``B = mu0/(4 pi) * int (K x r) / |r|^3 da``.
    Chunked over evaluation points to bound memory.
    """
    n = len(eval_positions)
    out = np.zeros((n, 3))
    Kx = current_densities[:, 0] * areas
    Ky = current_densities[:, 1] * areas
    chunk = max(1, int(5e7 / max(len(positions), 1)))
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        r = eval_positions[start:stop, None, :] - positions[None, :, :]
        dr = np.linalg.norm(r, axis=2)
        inv_dr3 = 1.0 / dr**3
        # K = (Kx, Ky, 0); B = mu0/4pi * sum K x r / |r|^3
        cx = Ky[None, :] * r[:, :, 2]
        cy = -Kx[None, :] * r[:, :, 2]
        cz = Kx[None, :] * r[:, :, 1] - Ky[None, :] * r[:, :, 0]
        out[start:stop, 0] = np.sum(cx * inv_dr3, axis=1)
        out[start:stop, 1] = np.sum(cy * inv_dr3, axis=1)
        out[start:stop, 2] = np.sum(cz * inv_dr3, axis=1)
    out *= MU_0 / (4 * np.pi)
    if vector:
        return out
    return out[:, 2]


def biot_savart_2d(
    x,
    y,
    z,
    *,
    positions: np.ndarray,
    current_densities: np.ndarray,
    z0: float = 0,
    areas: Optional[np.ndarray] = None,
    length_units: str = "um",
    current_units: str = "uA",
    vector: bool = True,
) -> Quantity:
    """Magnetic field (T) from a 2D sheet current density distribution.

    Args:
        x, y, z: Evaluation coordinates (in ``length_units``).
        positions: ``(m, 2)`` sheet positions (in ``length_units``).
        current_densities: ``(m, 2)`` sheet current density (in
            ``current_units / length_units``).
        z0: The z-plane of the sheet.
        areas: Optional per-position effective areas; computed from a Delaunay
            triangulation if omitted.
        vector: Return the full vector field (n, 3) or just Bz (n,).
    """
    to_meter = ureg(length_units).to("m").magnitude
    to_A_per_m = ureg(f"{current_units} / {length_units}").to("A / m").magnitude
    x, y, z = np.atleast_1d(x, y, z)
    if z.shape[0] == 1:
        z = z * np.ones_like(x)
    eval_positions = np.stack([x, y, z], axis=1) * to_meter
    positions = np.atleast_2d(positions)
    current_densities = np.atleast_2d(current_densities) * to_A_per_m
    if areas is None:
        from scipy import spatial

        from .fv.mesh import Mesh

        triangles = spatial.Delaunay(positions).simplices
        mesh = Mesh.from_triangulation(positions, triangles)
        areas = mesh.areas
    areas = np.asarray(areas) * to_meter**2
    positions3 = np.concatenate(
        [positions * to_meter,
         z0 * to_meter * np.ones((len(positions), 1))],
        axis=1,
    )
    B = _sheet_field_kernel(eval_positions, positions3, current_densities,
                            areas, vector)
    return Quantity.from_units(B, "tesla")


def current_loop_vector_potential(
    positions: np.ndarray,
    *,
    loop_center: Sequence[float] = (0, 0, 0),
    loop_radius: float = 1,
    current: float = 1,
    length_units: str = "um",
    current_units: str = "uA",
) -> Quantity:
    """Vector potential (T*m) of a circular current loop, via the standard
    elliptic-integral solution (azimuthal component only)."""
    to_meter = ureg(length_units).to("m").magnitude
    to_amp = ureg(current_units).to("A").magnitude
    positions = np.atleast_2d(positions) * to_meter
    loop_center = np.atleast_2d(loop_center) * to_meter
    a = loop_radius * to_meter
    current = current * to_amp
    r_rel = positions - loop_center
    rs = np.linalg.norm(r_rel, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        thetas = np.arccos(np.clip(r_rel[:, 2] / rs, -1, 1))
        sin_thetas = np.sin(thetas)
        denom = rs**2 + a**2 + 2 * a * rs * sin_thetas
        m = 4 * a * rs * sin_thetas / denom
        K = special.ellipk(m)
        E = special.ellipe(m)
        mag = (
            -MU_0 * current * a / (np.pi * m) * ((m - 2) * K + 2 * E)
            / np.sqrt(denom)
        )
    mag = np.where(np.isfinite(mag), mag, 0.0)
    phis = np.arctan2(r_rel[:, 1], r_rel[:, 0]) + np.pi / 2
    direction = np.stack(
        [np.cos(phis), np.sin(phis), np.zeros_like(phis)], axis=1
    )
    return Quantity.from_units(mag[:, None] * direction, "T * m")


def current_loop_field(
    positions: np.ndarray,
    *,
    loop_center: Sequence[float] = (0, 0, 0),
    loop_radius: float = 1e-6,
    current: float = 1e-3,
    length_units: str = "um",
    current_units: str = "uA",
) -> Quantity:
    """Magnetic field (T) of a circular current loop via the elliptic-integral
    solution in cylindrical coordinates."""
    to_meter = ureg(length_units).to("m").magnitude
    to_amp = ureg(current_units).to("A").magnitude
    positions = np.atleast_2d(positions) * to_meter
    loop_center = np.atleast_2d(loop_center) * to_meter
    a = loop_radius * to_meter
    current = current * to_amp
    r_rel = positions - loop_center
    rho = np.linalg.norm(r_rel[:, :2], axis=1)
    zz = r_rel[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = (a + rho) ** 2 + zz**2
        m = 4 * a * rho / denom
        K = special.ellipk(m)
        E = special.ellipe(m)
        pref = MU_0 * current / (2 * np.pi * np.sqrt(denom))
        sub = (a - rho) ** 2 + zz**2
        Bz = pref * (K + (a**2 - rho**2 - zz**2) / sub * E)
        Brho = pref * (zz / rho) * (-K + (a**2 + rho**2 + zz**2) / sub * E)
    Brho = np.where(np.isfinite(Brho), Brho, 0.0)
    phis = np.arctan2(r_rel[:, 1], r_rel[:, 0])
    B = np.stack(
        [Brho * np.cos(phis), Brho * np.sin(phis), Bz], axis=1
    )
    return Quantity.from_units(B, "tesla")
