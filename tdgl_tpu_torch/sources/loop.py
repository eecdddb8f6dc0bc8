"""Current-loop vector potential source (reference ``tdgl/sources/loop.py:35``).

Copy of :mod:`tdgl_tpu.sources.loop` on the port's :mod:`~tdgl_tpu_torch.em`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..em import current_loop_vector_potential
from ..parameter import Parameter


def loop_vector_potential(
    x, y, z, *,
    current: float,
    radius: float,
    center: Tuple[float, float, float],
    current_units: str = "uA",
    field_units: str = "mT",
    length_units: str = "um",
):
    if np.ndim(z) == 0:
        z = z * np.ones_like(x)
    positions = np.stack([x, y, z], axis=1)
    A = current_loop_vector_potential(
        positions,
        loop_center=center,
        loop_radius=radius,
        current=current,
        length_units=length_units,
        current_units=current_units,
    )
    return A.to(f"{field_units} * {length_units}").magnitude


def CurrentLoop(
    *,
    current: float,
    radius: float,
    center: Tuple[float, float, float],
    current_units: str = "uA",
    field_units: str = "mT",
    length_units: str = "um",
) -> Parameter:
    """A :class:`Parameter` giving the vector potential of a circular current
    loop."""
    return Parameter(
        loop_vector_potential,
        current=current,
        radius=radius,
        center=tuple(center),
        current_units=current_units,
        field_units=field_units,
        length_units=length_units,
    )
