"""Quality triangular meshing of polygons with holes.

The reference wraps the ``triangle`` C library via meshpy
(``tdgl/device/meshing.py:15-123``). Neither is available here, so this module
implements its own mesh generator:

1. Resample the film/hole boundaries at a target spacing ``h``, preserving
   corners (vertices with a significant turn angle).
2. Seed the interior with a hexagonal lattice of spacing ``h``, keeping points
   a safe distance from all boundaries.
3. Delaunay-triangulate (scipy/Qhull), discard triangles whose centroid lies
   outside the film or inside a hole.
4. Improve quality with a few Lloyd-style relaxation passes (move interior
   vertices to the mean of their neighbors, re-triangulate).
5. Iterate on ``h`` until ``min_points`` / ``max_edge_length`` are satisfied,
   mirroring the reference's refinement loop semantics.

Hexagonal seeding yields near-equilateral triangles, which is exactly what the
finite-volume discretization (convex Voronoi cells) wants.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
from scipy import spatial

from ..geometry import close_curve, ensure_unique, points_in_polygon, polygon_area

logger = logging.getLogger(__name__)


def _resample_ring(coords: np.ndarray, h: float, corner_angle: float = 20.0
                   ) -> np.ndarray:
    """Resample a closed ring at (approximately) uniform spacing ``h``,
    preserving corner vertices where the boundary turns by more than
    ``corner_angle`` degrees."""
    coords = ensure_unique(np.asarray(coords, dtype=float))
    n = len(coords)
    prev_v = coords - np.roll(coords, 1, axis=0)
    next_v = np.roll(coords, -1, axis=0) - coords
    prev_n = prev_v / np.maximum(np.linalg.norm(prev_v, axis=1, keepdims=True), 1e-300)
    next_n = next_v / np.maximum(np.linalg.norm(next_v, axis=1, keepdims=True), 1e-300)
    cos_turn = np.clip(np.sum(prev_n * next_n, axis=1), -1, 1)
    turn = np.degrees(np.arccos(cos_turn))
    corner_ix = np.where(turn > corner_angle)[0]
    if len(corner_ix) == 0:
        corner_ix = np.array([0])
    # Split the ring into polyline segments between consecutive corners.
    out: List[np.ndarray] = []
    num_corners = len(corner_ix)
    for k in range(num_corners):
        i0 = corner_ix[k]
        i1 = corner_ix[(k + 1) % num_corners]
        if i1 > i0:
            seg = coords[i0:i1 + 1]
        else:
            seg = np.concatenate([coords[i0:], coords[:i1 + 1]], axis=0)
        # Arc-length resample this open segment at spacing ~h, endpoints fixed.
        d = np.linalg.norm(np.diff(seg, axis=0), axis=1)
        arclen = np.concatenate([[0.0], np.cumsum(d)])
        total = arclen[-1]
        if total < 1e-300:
            continue
        pieces = max(1, int(round(total / h)))
        targets = np.linspace(0, total, pieces + 1)[:-1]  # exclude the endpoint
        x = np.interp(targets, arclen, seg[:, 0])
        y = np.interp(targets, arclen, seg[:, 1])
        out.append(np.stack([x, y], axis=1))
    ring = np.concatenate(out, axis=0)
    return ensure_unique(ring)


def _hex_lattice(bbox_min, bbox_max, h: float) -> np.ndarray:
    """Hexagonal (triangular) lattice with nearest-neighbor distance ``h``."""
    dx = h
    dy = h * np.sqrt(3) / 2
    nx = int(np.ceil((bbox_max[0] - bbox_min[0]) / dx)) + 2
    ny = int(np.ceil((bbox_max[1] - bbox_min[1]) / dy)) + 2
    ix = np.arange(nx)
    iy = np.arange(ny)
    X, Y = np.meshgrid(ix * dx, iy * dy)
    X[1::2] += dx / 2  # stagger every other row
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    return pts + np.asarray(bbox_min) - np.array([dx / 2, dy / 2])


def _min_dist_to_rings(points: np.ndarray, rings: List[np.ndarray]) -> np.ndarray:
    """Approximate distance from each point to the nearest ring, via a KD-tree
    over the ring VERTICES (fast, C): underestimates the true
    point-to-boundary distance by at most half the ring spacing, which the
    caller's exclusion margin absorbs."""
    ring_points = np.concatenate(rings, axis=0)
    tree = spatial.cKDTree(ring_points)
    d, _ = tree.query(points, k=1)
    return d


def _triangulate(points: np.ndarray, film: np.ndarray,
                 holes: List[np.ndarray],
                 max_edge: float = np.inf) -> Tuple[np.ndarray, np.ndarray]:
    """Delaunay + containment filter + orphan removal. Returns (points, tris).

    Triangles are kept only if their centroid lies inside the film and outside
    every hole, and the longest edge is below ``max_edge``. The edge cutoff
    removes long Delaunay slivers spanning concave notches, which can survive
    a centroid-only test.
    """
    tri = spatial.Delaunay(points)
    elements = tri.simplices
    p = points[elements]
    edge_len = np.stack([
        np.linalg.norm(p[:, a] - p[:, b], axis=1)
        for a, b in ((0, 1), (1, 2), (2, 0))
    ], axis=1)
    keep = edge_len.max(axis=1) <= max_edge
    # Drop (near-)zero-area slivers — e.g. three collinear boundary points —
    # which would produce unbounded circumcenters and corrupt the Voronoi
    # dual (negative cell areas) after smoothing.
    areas2 = np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    )
    keep &= areas2 > 1e-4 * edge_len.max(axis=1) * edge_len.min(axis=1)
    centroids = p.mean(axis=1)
    keep &= points_in_polygon(centroids, film)
    for hole in holes:
        keep &= ~points_in_polygon(centroids, hole)
    elements = elements[keep]
    # Drop unused points and remap.
    used = np.unique(elements)
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return points[used], remap[elements]


def _ccw_elements(points: np.ndarray, elements: np.ndarray) -> np.ndarray:
    p = points[elements]
    cross = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    flip = cross < 0
    elements = elements.copy()
    elements[flip] = elements[flip][:, ::-1]
    return elements


def _max_edge_length(points: np.ndarray, elements: np.ndarray) -> float:
    p = points[elements]
    lengths = [
        np.linalg.norm(p[:, a] - p[:, b], axis=1)
        for a, b in ((0, 1), (1, 2), (2, 0))
    ]
    return float(np.max(lengths))


def _relax(points: np.ndarray, elements: np.ndarray, n_boundary_locked: int,
           iterations: int = 2) -> np.ndarray:
    """Lloyd-ish relaxation: move free vertices to the mean of their
    triangulation neighbors. The first ``n_boundary_locked`` points are fixed."""
    n = len(points)
    for _ in range(iterations):
        edges = np.concatenate(
            [elements[:, (0, 1)], elements[:, (1, 2)], elements[:, (2, 0)]]
        )
        i = np.concatenate([edges[:, 0], edges[:, 1]])
        j = np.concatenate([edges[:, 1], edges[:, 0]])
        sums = np.zeros((n, 2))
        np.add.at(sums, i, points[j])
        counts = np.bincount(i, minlength=n).astype(float)
        new_points = sums / np.maximum(counts, 1)[:, None]
        new_points[:n_boundary_locked] = points[:n_boundary_locked]
        points = new_points
    return points


def generate_mesh(
    poly_coords: np.ndarray,
    hole_coords: Optional[List[np.ndarray]] = None,
    min_points: Optional[int] = None,
    max_edge_length: Optional[float] = None,
    convex_hull: bool = False,
    boundary: Optional[np.ndarray] = None,
    min_angle: float = 32.5,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate a quality Delaunay mesh of a polygon with holes.

    API-compatible with the reference ``tdgl.device.meshing.generate_mesh``
    (``tdgl/device/meshing.py:15``); ``min_angle`` and extra kwargs are accepted
    for compatibility (quality is controlled by hexagonal seeding + relaxation
    here rather than by Ruppert refinement).

    Args:
        poly_coords: Shape ``(n, 2)`` polygon vertices.
        hole_coords: List of hole-boundary vertex arrays.
        min_points: Minimum number of mesh vertices.
        max_edge_length: Maximum allowed edge length.
        convex_hull: Mesh the convex hull of the polygon (minus holes).
        boundary: Optional subset of ``poly_coords`` to use as the boundary.
        min_angle: Accepted for API compatibility.

    Returns:
        ``(points, triangles)``: float ``(n, 2)`` vertex coordinates and int
        ``(m, 3)`` CCW triangle indices.
    """
    film = ensure_unique(np.asarray(poly_coords, dtype=float))
    if polygon_area(film) < 0:
        film = film[::-1]
    holes = [ensure_unique(np.asarray(c, dtype=float))
             for c in (hole_coords or [])]
    if convex_hull:
        if boundary is not None:
            raise ValueError("Cannot use both boundary and convex_hull=True.")
        hull = spatial.ConvexHull(film)
        film = film[hull.vertices]
    elif boundary is not None:
        boundary = np.asarray(boundary, dtype=float)
        keep = [
            i for i, xy in enumerate(film)
            if np.any(np.all(np.isclose(boundary, xy), axis=1))
        ]
        film = film[keep]

    area = abs(polygon_area(film)) - sum(abs(polygon_area(h)) for h in holes)
    extent = max(np.ptp(film[:, 0]), np.ptp(film[:, 1]))

    # Initial spacing estimate.
    if min_points:
        h = np.sqrt(2 * area / (np.sqrt(3) * min_points))
    elif max_edge_length and max_edge_length > 0:
        h = 0.85 * max_edge_length
    else:
        h = extent / 32

    min_points = min_points or 0
    target_edge = max_edge_length if (max_edge_length and max_edge_length > 0) \
        else np.inf

    def ring_spacing(ring: np.ndarray, h: float) -> float:
        """Boundary spacing: honor the user's (finer) native vertex spacing —
        peak currents live in an edge boundary layer — but cap the
        boundary/interior ratio at 3x for triangle quality."""
        native = float(np.median(
            np.linalg.norm(np.diff(np.vstack([ring, ring[:1]]), axis=0),
                           axis=1)
        ))
        return float(np.clip(native, h / 3, h))

    points = elements = None
    for iteration in range(20):
        rings = [_resample_ring(film, ring_spacing(film, h))] + [
            _resample_ring(hh, ring_spacing(hh, h)) for hh in holes
        ]
        boundary_pts = np.concatenate(rings, axis=0)
        interior = _hex_lattice(film.min(axis=0), film.max(axis=0), h)
        inside = points_in_polygon(interior, film)
        for hole in holes:
            inside &= ~points_in_polygon(interior, hole)
        interior = interior[inside]
        if len(interior):
            d = _min_dist_to_rings(interior, rings)
            interior = interior[d > 0.5 * h]
        all_points = ensure_unique(
            np.concatenate([boundary_pts, interior], axis=0)
        )
        n_locked = len(boundary_pts)
        cutoff = 2.5 * h
        points, elements = _triangulate(all_points, film, holes, max_edge=cutoff)
        # Relax and re-triangulate for quality (free points only).
        points = _relax(points, elements, n_boundary_locked=n_locked)
        points, elements = _triangulate(points, film, holes, max_edge=cutoff)

        max_len = _max_edge_length(points, elements)
        if len(points) >= min_points and max_len <= target_edge:
            break
        # Shrink h toward the target, at most halving per iteration.
        factor = 0.9
        if np.isfinite(target_edge) and max_len > target_edge:
            factor = min(factor, 0.95 * target_edge / max_len)
        if min_points and len(points) < min_points:
            factor = min(factor, 0.95 * np.sqrt(len(points) / min_points))
        h *= max(factor, 0.5)
        logger.info(
            "Meshing iteration %d: %d points, max edge %.3g (target %.3g); "
            "h -> %.3g", iteration, len(points), max_len, target_edge, h,
        )
    return points, _ccw_elements(points, elements)
