"""Uniform out-of-plane magnetic field source (reference
``tdgl/sources/constant.py:25``)."""

from __future__ import annotations

import numpy as np

from ..parameter import Parameter
from ..utils.units import ureg


def constant_field_vector_potential(
    x, y, z, *, Bz: float, field_units: str = "mT", length_units: str = "um"
):
    """A = (B x r)/2 for B = Bz z_hat, returned in field_units*length_units."""
    if np.ndim(z) == 0:
        z = z * np.ones_like(x)
    # Work directly in the requested units: A = Bz/2 * (-y, x, 0).
    A = 0.5 * np.stack(
        [-Bz * y, Bz * x, np.zeros_like(np.asarray(x, dtype=float))], axis=1
    )
    return A


def ConstantField(
    value: float = 0, field_units: str = "mT", length_units: str = "um"
) -> Parameter:
    """A :class:`Parameter` giving the vector potential of a uniform
    out-of-plane field ``Bz = value`` (in ``field_units``)."""
    return Parameter(
        constant_field_vector_potential,
        Bz=float(value),
        field_units=field_units,
        length_units=length_units,
        jittable=True,
    )
