"""Named polygons with geometric operations.

API parity with the reference ``tdgl/device/polygon.py:29-622``: CCW-oriented
vertices with validation, set operations (union/intersection/difference, also
via ``+ - *`` operators), affine transforms, ``buffer``, spline ``resample``,
containment and boundary tests, meshing, and HDF5 round-trips.

Boolean geometry is provided by :mod:`tdgl_tpu.device.clipping`
(Greiner-Hormann) instead of shapely/GEOS.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import interpolate

from ..geometry import (
    close_curve,
    distance_to_polygon,
    ensure_unique,
    points_in_polygon,
    polygon_area,
    polygon_centroid,
    rotate as rotate_coords,
)
from .clipping import clip_polygons

logger = logging.getLogger(__name__)

PolygonType = Union["Polygon", np.ndarray, Sequence[Tuple[float, float]]]


def _coerce_points(obj: PolygonType) -> np.ndarray:
    if isinstance(obj, Polygon):
        return obj.points
    return np.asarray(obj, dtype=float)


def _is_simple(coords: np.ndarray) -> bool:
    """Check that the ring has no proper self-intersections (O(n^2) sweep,
    native C++ when available)."""
    if np.allclose(coords[0], coords[-1]):
        coords = coords[:-1]
    from ..native import is_simple_polygon_native

    native = is_simple_polygon_native(coords)
    if native is not None:
        return native
    n = len(coords)
    segs = np.stack([coords, np.roll(coords, -1, axis=0)], axis=1)
    for i in range(n):
        p1, p2 = segs[i]
        r = p2 - p1
        for j in range(i + 2, n):
            if i == 0 and j == n - 1:
                continue  # adjacent through the wrap
            q1, q2 = segs[j]
            s = q2 - q1
            denom = r[0] * s[1] - r[1] * s[0]
            if abs(denom) < 1e-300:
                continue
            qp = q1 - p1
            t = (qp[0] * s[1] - qp[1] * s[0]) / denom
            u = (qp[0] * r[1] - qp[1] * r[0]) / denom
            if 1e-12 < t < 1 - 1e-12 and 1e-12 < u < 1 - 1e-12:
                return False
    return True


class Polygon:
    """A simply-connected polygon.

    Args:
        name: An optional name for the polygon.
        points: Shape ``(n, 2)`` vertex coordinates. Will be oriented
            counterclockwise and deduplicated.
        mesh: Whether to include this polygon when meshing a Device.
    """

    def __init__(
        self,
        name: Optional[str] = None,
        *,
        points: PolygonType,
        mesh: bool = True,
    ):
        self.name = name
        self.points = points
        self.mesh = mesh

    @property
    def points(self) -> np.ndarray:
        """Vertex coordinates, shape ``(n, 2)``, CCW-oriented, not closed."""
        return self._points

    @points.setter
    def points(self, points: PolygonType) -> None:
        coords = _coerce_points(points)
        if coords.ndim != 2 or coords.shape[1] != 2:
            raise ValueError(f"Expected shape (n, 2), got {coords.shape}")
        coords = ensure_unique(coords)
        if len(coords) > 1 and np.allclose(coords[0], coords[-1]):
            coords = coords[:-1]
        if len(coords) < 3:
            raise ValueError("A polygon must have at least 3 distinct vertices.")
        if polygon_area(coords) < 0:
            coords = coords[::-1]
        if not _is_simple(coords):
            raise ValueError("Polygon vertices must not self-intersect.")
        self._points = coords

    @property
    def path(self):
        """A ``matplotlib.path.Path`` for the closed polygon boundary
        (reference parity: ``tdgl/device/polygon.py:111-114``).

        The ring is explicitly closed first: with ``closed=True``
        matplotlib treats the LAST vertex as the CLOSEPOLY placeholder, so
        passing the open ring would silently drop a real vertex."""
        from matplotlib.path import Path

        return Path(np.vstack([self._points, self._points[:1]]),
                    closed=True)

    @property
    def polygon(self):
        """A shapely ``Polygon``, if shapely is installed (reference
        parity: ``tdgl/device/polygon.py:106-109``). tdgl_tpu itself does
        not depend on shapely — geometry queries are native: use
        ``points`` / ``path`` / ``contains_points`` / ``on_boundary`` and
        the ``union`` / ``intersection`` / ``difference`` operations."""
        try:
            from shapely import geometry as geo
        except ImportError as exc:
            raise ImportError(
                "Polygon.polygon returns a shapely Polygon, but shapely is"
                " not installed (tdgl_tpu does not require it). Use"
                " .points, .path, .contains_points, or the boolean ops"
                " instead."
            ) from exc
        return geo.Polygon(self._points)

    @property
    def is_valid(self) -> bool:
        """True if the polygon is a valid simple polygon with nonzero area."""
        try:
            return (
                self._points.ndim == 2
                and len(self._points) >= 3
                and abs(polygon_area(self._points)) > 0
            )
        except Exception:
            return False

    @property
    def area(self) -> float:
        """The area of the polygon."""
        return abs(polygon_area(self._points))

    @property
    def bbox(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        """Bounding box: ``((xmin, ymin), (xmax, ymax))``."""
        p = self._points
        return (
            (float(p[:, 0].min()), float(p[:, 1].min())),
            (float(p[:, 0].max()), float(p[:, 1].max())),
        )

    @property
    def extents(self) -> Tuple[float, float]:
        """``(Delta_x, Delta_y)`` of the bounding box."""
        (xmin, ymin), (xmax, ymax) = self.bbox
        return (xmax - xmin, ymax - ymin)

    @property
    def centroid(self) -> np.ndarray:
        """Area centroid ``(x, y)``."""
        return polygon_centroid(self._points)

    # -- queries --------------------------------------------------------------
    def contains_points(
        self,
        points: np.ndarray,
        index: bool = False,
        radius: float = 0,
    ) -> np.ndarray:
        """Whether each point lies inside the polygon.

        Args:
            points: Shape ``(n, 2)`` coordinates.
            index: If True, return indices of contained points instead of a mask.
            radius: Dilate (positive) or erode (negative) the boundary.
        """
        points = np.atleast_2d(np.asarray(points, dtype=float))
        mask = points_in_polygon(points, self._points, radius=radius)
        if index:
            return np.where(mask)[0]
        return mask

    def on_boundary(
        self, points: np.ndarray, radius: float = 1e-3, index: bool = False
    ):
        """Whether each point lies within ``radius`` of the polygon boundary."""
        points = np.atleast_2d(np.asarray(points, dtype=float))
        d = distance_to_polygon(points, self._points)
        mask = d <= radius
        if index:
            return np.where(mask)[0]
        return mask

    # -- transforms -----------------------------------------------------------
    def rotate(
        self, degrees: float, origin: Tuple[float, float] = (0.0, 0.0)
    ) -> "Polygon":
        """Rotate counterclockwise by ``degrees`` about ``origin`` (in place)."""
        origin = np.asarray(origin, dtype=float)
        self.points = rotate_coords(self._points - origin, degrees) + origin
        return self

    def translate(self, dx: float = 0.0, dy: float = 0.0) -> "Polygon":
        """Translate by ``(dx, dy)`` (in place)."""
        self.points = self._points + np.array([dx, dy])
        return self

    def scale(
        self,
        xfact: float = 1.0,
        yfact: float = 1.0,
        origin: Tuple[float, float] = (0, 0),
    ) -> "Polygon":
        """Scale about ``origin`` (in place). Negative factors mirror."""
        origin = np.asarray(origin, dtype=float)
        pts = (self._points - origin) * np.array([xfact, yfact]) + origin
        self.points = pts
        return self

    # -- boolean geometry -------------------------------------------------------
    def _combine(self, others, operation: str, name: Optional[str]) -> "Polygon":
        result = self._points
        for other in others:
            other_pts = _coerce_points(other)
            pieces = clip_polygons(result, other_pts, operation)
            if len(pieces) == 0:
                raise ValueError(
                    f"Polygon {operation} resulted in an empty geometry."
                )
            if len(pieces) > 1:
                raise ValueError(
                    f"Polygon {operation} resulted in {len(pieces)} disjoint"
                    " polygons; a tdgl Polygon must be simply connected."
                )
            result = pieces[0]
        return Polygon(name or self.name, points=result, mesh=self.mesh)

    def union(self, *others: PolygonType, name: Optional[str] = None) -> "Polygon":
        """Union of this polygon with one or more others."""
        return self._combine(others, "union", name)

    def intersection(
        self, *others: PolygonType, name: Optional[str] = None
    ) -> "Polygon":
        """Intersection of this polygon with one or more others."""
        return self._combine(others, "intersection", name)

    def difference(
        self, *others: PolygonType, name: Optional[str] = None
    ) -> "Polygon":
        """This polygon minus one or more others."""
        return self._combine(others, "difference", name)

    def __add__(self, other: PolygonType) -> "Polygon":
        return self.union(other)

    def __mul__(self, other: PolygonType) -> "Polygon":
        return self.intersection(other)

    def __sub__(self, other: PolygonType) -> "Polygon":
        return self.difference(other)

    @classmethod
    def from_union(
        cls, items: Sequence[PolygonType], *, name: Optional[str] = None, **kwargs
    ) -> "Polygon":
        """Union of a sequence of polygons."""
        first, *rest = items
        poly = cls(name, points=_coerce_points(first), **kwargs)
        return poly.union(*rest, name=name) if rest else poly

    @classmethod
    def from_intersection(
        cls, items: Sequence[PolygonType], *, name: Optional[str] = None, **kwargs
    ) -> "Polygon":
        """Intersection of a sequence of polygons."""
        first, *rest = items
        poly = cls(name, points=_coerce_points(first), **kwargs)
        return poly.intersection(*rest, name=name) if rest else poly

    @classmethod
    def from_difference(
        cls, items: Sequence[PolygonType], *, name: Optional[str] = None, **kwargs
    ) -> "Polygon":
        """First polygon minus all the rest."""
        first, *rest = items
        poly = cls(name, points=_coerce_points(first), **kwargs)
        return poly.difference(*rest, name=name) if rest else poly

    # -- reshaping --------------------------------------------------------------
    def buffer(
        self,
        distance: float,
        join_style: str = "round",
        mitre_limit: float = 5.0,
        single_sided: bool = True,
        as_polygon: bool = True,
    ) -> Union[np.ndarray, "Polygon"]:
        """Offset the polygon boundary outward (or inward for negative
        ``distance``) by ``distance``.

        Implemented as a per-vertex miter/round offset along the angle
        bisector (the reference delegates to shapely's buffer,
        ``tdgl/device/polygon.py:412``). Suitable for the smooth,
        densely-sampled polygons used for devices.
        """
        if distance == 0:
            out = self._points.copy()
        else:
            pts = self._points
            nxt = np.roll(pts, -1, axis=0)
            prv = np.roll(pts, 1, axis=0)
            e_in = pts - prv
            e_out = nxt - pts
            n_in = np.stack([e_in[:, 1], -e_in[:, 0]], axis=1)
            n_out = np.stack([e_out[:, 1], -e_out[:, 0]], axis=1)
            n_in /= np.maximum(np.linalg.norm(n_in, axis=1, keepdims=True), 1e-300)
            n_out /= np.maximum(np.linalg.norm(n_out, axis=1, keepdims=True), 1e-300)
            bisector = n_in + n_out
            norm = np.linalg.norm(bisector, axis=1, keepdims=True)
            bisector = np.divide(bisector, norm, out=np.zeros_like(bisector),
                                 where=norm > 1e-12)
            # miter scale: 1 / cos(theta/2), capped by mitre_limit
            cos_half = np.clip(
                np.sqrt(np.maximum(0.0, (1 + np.sum(n_in * n_out, axis=1)) / 2)),
                1.0 / mitre_limit,
                1.0,
            )
            scale = 1.0 / cos_half
            if join_style in ("round", 1, "mitre", "miter", 2):
                offset = bisector * (distance * scale[:, None])
            elif join_style in ("bevel", 3):
                offset = bisector * distance
            else:
                raise ValueError(f"Unknown join_style: {join_style!r}")
            # For a CCW ring, the edge normal (dy, -dx) points outward.
            out = pts + offset
            out = ensure_unique(out)
        if as_polygon:
            name = self.name
            return Polygon(name, points=out, mesh=self.mesh)
        return out

    def resample(
        self, num_points: Optional[int] = None, degree: int = 1, smooth: float = 0
    ) -> "Polygon":
        """Resample the boundary with ``num_points`` points using periodic
        spline interpolation of the given ``degree``.

        ``resample(False)`` or ``resample(0)`` returns a copy; ``resample(None)``
        keeps the current number of points.
        """
        if num_points is False or num_points == 0:
            return self.copy()
        if num_points is None:
            num_points = len(self._points)
        pts = close_curve(self._points)
        tck, _ = interpolate.splprep(pts.T, k=degree, s=smooth, per=True)
        x, y = interpolate.splev(np.linspace(0, 1, int(num_points)), tck)
        return Polygon(self.name, points=np.stack([x, y], axis=1), mesh=self.mesh)

    def set_name(self, name: Optional[str]) -> "Polygon":
        """Set the polygon name and return self."""
        self.name = name
        return self

    def copy(self) -> "Polygon":
        return Polygon(self.name, points=self._points.copy(), mesh=self.mesh)

    # -- meshing ------------------------------------------------------------
    def make_mesh(
        self,
        min_points: Optional[int] = None,
        max_edge_length: Optional[float] = None,
        smooth: int = 0,
        **kwargs,
    ):
        """Generate a finite-volume mesh of this polygon (no holes).

        See :func:`tdgl_tpu.device.meshing.generate_mesh`.
        """
        from ..fv.mesh import Mesh
        from .meshing import generate_mesh

        points, triangles = generate_mesh(
            self._points,
            min_points=min_points,
            max_edge_length=max_edge_length,
            **kwargs,
        )
        mesh = Mesh.from_triangulation(points, triangles, create_submesh=False)
        if smooth:
            mesh = mesh.smooth(smooth, create_submesh=True)
        else:
            mesh = Mesh.from_triangulation(points, triangles, create_submesh=True)
        return mesh

    # -- plotting / IO --------------------------------------------------------
    def plot(self, ax=None, **kwargs):
        """Plot the polygon outline."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        kwargs.setdefault("label", self.name)
        ax.plot(*close_curve(self._points).T, **kwargs)
        ax.set_aspect("equal")
        return ax

    def to_hdf5(self, h5_group: h5py.Group) -> None:
        """Save to an HDF5 group."""
        if self.name is not None:
            h5_group.attrs["name"] = self.name
        h5_group.attrs["mesh"] = self.mesh
        h5_group["points"] = self._points

    @classmethod
    def from_hdf5(cls, h5_group: h5py.Group) -> "Polygon":
        """Load from an HDF5 group."""
        return cls(
            name=h5_group.attrs.get("name", None),
            points=np.array(h5_group["points"]),
            mesh=bool(h5_group.attrs.get("mesh", True)),
        )

    def __repr__(self) -> str:
        return (
            f"Polygon(name={self.name!r}, points=<{len(self._points)} vertices>,"
            f" mesh={self.mesh})"
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Polygon):
            return False
        return (
            self.name == other.name
            and self._points.shape == other._points.shape
            and np.allclose(self._points, other._points)
        )
