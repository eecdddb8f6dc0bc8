"""Fluxoid container and measurement-polygon generation.

Copied from :mod:`tdgl_tpu.fluxoid`; API parity with the reference
``tdgl/fluxoid.py:9-73``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np


class Fluxoid(NamedTuple):
    """The two parts of the fluxoid through a closed region S:

    ``flux_part = int_S mu_0 H_z d^2r = oint A . dl`` and
    ``supercurrent_part = oint mu_0 Lambda K_s . dl``.
    """

    flux_part: Union[float, "object"]
    supercurrent_part: Union[float, "object"]


def make_fluxoid_polygons(
    device,
    holes: Optional[Union[List[str], str]] = None,
    join_style: str = "mitre",
    interp_points: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Generate measurement polygons around the device's holes, offset from
    each hole by half its minimum distance to other polygons.

    Args:
        device: The :class:`tdgl_tpu_torch.Device`.
        holes: Hole name(s) for which to build polygons (default: all).
        join_style: Offset join style (see :meth:`Polygon.buffer`).
        interp_points: If given, resample the polygon to this many points.

    Returns:
        ``{hole_name: polygon_points}``
    """
    from .geometry import distance_to_polygon

    device_polygons = [device.film] + list(device.holes)
    device_holes = {hole.name: hole for hole in device.holes}
    if holes is None:
        holes = list(device_holes)
    if isinstance(holes, str):
        holes = [holes]
    polygons: Dict[str, np.ndarray] = {}
    for name in holes:
        hole = device_holes[name]
        hole_poly = hole.points
        min_dist = min(
            float(distance_to_polygon(hole_poly, other.points).min())
            for other in device_polygons
            if other.name != name
        )
        delta = min_dist / 2
        new_poly = hole.buffer(delta, join_style=join_style)
        if interp_points:
            new_poly = new_poly.resample(interp_points)
        polygons[name] = new_poly.points
    return polygons
