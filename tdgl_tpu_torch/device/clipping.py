"""Polygon boolean operations (union / intersection / difference).

The reference framework delegates polygon booleans to shapely/GEOS
(``tdgl/device/polygon.py:282-401``). GEOS is not available here, so this
module implements the Greiner-Hormann clipping algorithm for pairs of simple
polygons, with deterministic vertex perturbation to escape degenerate
configurations (endpoint-on-edge, collinear overlaps).

Only simple (non-self-intersecting) polygons without holes are supported,
which matches the reference's usage: a ``tdgl.Polygon`` wraps a single simple
ring, and operations that would produce holes or multiple disjoint parts
raise ``ValueError`` there as well.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..geometry import ensure_unique, points_in_polygon, polygon_area

__all__ = ["clip_polygons", "DegenerateGeometry"]


class DegenerateGeometry(Exception):
    """Internal: raised when an intersection is too degenerate to classify."""


class _Vertex:
    __slots__ = (
        "x", "y", "next", "prev", "neighbor", "intersect", "entry", "alpha",
        "visited",
    )

    def __init__(self, x: float, y: float, alpha: float = 0.0,
                 intersect: bool = False):
        self.x = x
        self.y = y
        self.next: Optional["_Vertex"] = None
        self.prev: Optional["_Vertex"] = None
        self.neighbor: Optional["_Vertex"] = None
        self.intersect = intersect
        self.entry = True
        self.alpha = alpha
        self.visited = False


def _build_ring(coords: np.ndarray) -> _Vertex:
    """Build a circular doubly-linked list from (n, 2) coordinates."""
    first = None
    prev = None
    for x, y in coords:
        v = _Vertex(float(x), float(y))
        if first is None:
            first = v
        else:
            prev.next = v
            v.prev = prev
        prev = v
    prev.next = first
    first.prev = prev
    return first


def _ring_vertices(first: _Vertex, originals_only: bool = False):
    v = first
    while True:
        if not (originals_only and v.intersect):
            yield v
        v = v.next
        if v is first:
            break


def _insert_sorted(edge_start: _Vertex, new: _Vertex) -> None:
    """Insert an intersection vertex after ``edge_start``, ordered by alpha
    among any intersection vertices already on this edge."""
    pos = edge_start
    nxt = pos.next
    while nxt.intersect and nxt.alpha < new.alpha:
        pos = nxt
        nxt = pos.next
    new.next = nxt
    new.prev = pos
    pos.next = new
    nxt.prev = new


def _segment_intersection(p1, p2, q1, q2, eps: float):
    """Parametric intersection of segments p1→p2 and q1→q2.

    Returns (t, u) in (0, 1) x (0, 1) for a proper crossing, None for no
    intersection. Raises DegenerateGeometry for near-parallel overlaps or
    endpoint grazing.
    """
    rx, ry = p2[0] - p1[0], p2[1] - p1[1]
    sx, sy = q2[0] - q1[0], q2[1] - q1[1]
    denom = rx * sy - ry * sx
    qpx, qpy = q1[0] - p1[0], q1[1] - p1[1]
    t_num = qpx * sy - qpy * sx
    u_num = qpx * ry - qpy * rx
    scale = max(abs(rx), abs(ry), abs(sx), abs(sy), 1e-300)
    if abs(denom) < eps * scale * scale:
        # Parallel (or nearly). Check for collinear overlap, which is degenerate.
        cross = qpx * ry - qpy * rx
        if abs(cross) < eps * scale * scale:
            # Collinear: degenerate if the segments overlap.
            rr = rx * rx + ry * ry
            t0 = (qpx * rx + qpy * ry) / rr
            t1 = t0 + (sx * rx + sy * ry) / rr
            lo, hi = min(t0, t1), max(t0, t1)
            if hi > eps and lo < 1 - eps:
                raise DegenerateGeometry("collinear overlap")
        return None
    t = t_num / denom
    u = u_num / denom
    if -eps < t < eps or 1 - eps < t < 1 + eps or -eps < u < eps or 1 - eps < u < 1 + eps:
        if -eps < t < 1 + eps and -eps < u < 1 + eps:
            raise DegenerateGeometry("endpoint grazing")
        return None
    if 0 < t < 1 and 0 < u < 1:
        return t, u
    return None


def _find_all_intersections(subject, clipper, eps):
    """All proper pairwise edge intersections, native (C++) when available,
    else pure Python. Returns a list of (si, ci, t, u)."""
    from ..native import find_intersections

    native = find_intersections(subject, clipper, eps)
    if native is not None:
        si, ci, t, u = native
        return list(zip(si.tolist(), ci.tolist(), t.tolist(), u.tolist()))
    hits = []
    n, m = len(subject), len(clipper)
    for i in range(n):
        p1 = subject[i]
        p2 = subject[(i + 1) % n]
        for j in range(m):
            hit = _segment_intersection(
                tuple(p1), tuple(p2),
                tuple(clipper[j]), tuple(clipper[(j + 1) % m]), eps,
            )
            if hit is not None:
                hits.append((i, j, hit[0], hit[1]))
    return hits


def _clip_once(subject: np.ndarray, clipper: np.ndarray, op: str,
               eps: float) -> List[np.ndarray]:
    s_first = _build_ring(subject)
    c_first = _build_ring(clipper)

    # Phase 1: find and insert all intersections.
    s_verts = list(_ring_vertices(s_first))
    c_verts = list(_ring_vertices(c_first))
    hits = _find_all_intersections(subject, clipper, eps)
    num_intersections = 0
    for i, j, t, u in hits:
        sv, cv = s_verts[i], c_verts[j]
        # Compute the intersection point from the original edge endpoints.
        p2 = subject[(i + 1) % len(subject)]
        ix = sv.x + t * (p2[0] - sv.x)
        iy = sv.y + t * (p2[1] - sv.y)
        vs = _Vertex(ix, iy, alpha=t, intersect=True)
        vc = _Vertex(ix, iy, alpha=u, intersect=True)
        vs.neighbor = vc
        vc.neighbor = vs
        _insert_sorted(sv, vs)
        _insert_sorted(cv, vc)
        num_intersections += 1

    if num_intersections == 0:
        return _no_intersection_result(subject, clipper, op)

    # Phase 2: mark entry/exit status.
    # Initial status: True if the first subject vertex is OUTSIDE the clipper
    # (the first intersection encountered is then an entry into the clipper).
    subj_entry = not bool(points_in_polygon(np.array([[s_first.x, s_first.y]]),
                                            clipper)[0])
    clip_entry = not bool(points_in_polygon(np.array([[c_first.x, c_first.y]]),
                                            subject)[0])
    if op == "union":
        subj_entry = not subj_entry
        clip_entry = not clip_entry
    elif op == "difference":
        subj_entry = not subj_entry

    for first, status in ((s_first, subj_entry), (c_first, clip_entry)):
        v = first
        while True:
            if v.intersect:
                v.entry = status
                status = not status
            v = v.next
            if v is first:
                break

    # Phase 3: trace result polygons.
    results = []
    while True:
        start = None
        for v in _ring_vertices(s_first):
            if v.intersect and not v.visited:
                start = v
                break
        if start is None:
            break
        ring = []
        current = start
        while True:
            current.visited = True
            if current.neighbor is not None:
                current.neighbor.visited = True
            if current.entry:
                while True:
                    ring.append((current.x, current.y))
                    current = current.next
                    if current.intersect:
                        break
            else:
                while True:
                    ring.append((current.x, current.y))
                    current = current.prev
                    if current.intersect:
                        break
            current = current.neighbor
            if current.visited:
                break
        if len(ring) >= 3:
            results.append(np.array(ring))
    return results


def _no_intersection_result(subject, clipper, op):
    a_in_b = bool(points_in_polygon(subject[:1], clipper)[0])
    b_in_a = bool(points_in_polygon(clipper[:1], subject)[0])
    if op == "intersection":
        if a_in_b:
            return [subject.copy()]
        if b_in_a:
            return [clipper.copy()]
        return []
    if op == "union":
        if a_in_b:
            return [clipper.copy()]
        if b_in_a:
            return [subject.copy()]
        return [subject.copy(), clipper.copy()]
    # difference (subject - clipper)
    if a_in_b:
        return []
    if b_in_a:
        raise ValueError(
            "Polygon difference would create a hole, which cannot be"
            " represented as a single simple polygon."
        )
    return [subject.copy()]


def _normalize(coords: np.ndarray) -> np.ndarray:
    """CCW orientation, no duplicate vertices."""
    coords = ensure_unique(np.asarray(coords, dtype=float))
    if polygon_area(coords) < 0:
        coords = coords[::-1]
    return coords


def clip_polygons(subject: np.ndarray, clipper: np.ndarray,
                  op: str) -> List[np.ndarray]:
    """Compute a boolean operation between two simple polygons.

    Args:
        subject: Shape ``(n, 2)`` vertices of the first polygon.
        clipper: Shape ``(m, 2)`` vertices of the second polygon.
        op: One of ``"union"``, ``"intersection"``, ``"difference"``.

    Returns:
        A list of CCW-oriented result polygons (possibly empty).
    """
    if op not in ("union", "intersection", "difference"):
        raise ValueError(f"Unknown operation: {op!r}")
    subject = _normalize(subject)
    clipper = _normalize(clipper)
    scale = max(
        np.ptp(subject[:, 0]), np.ptp(subject[:, 1]),
        np.ptp(clipper[:, 0]), np.ptp(clipper[:, 1]), 1e-300,
    )
    rng = np.random.default_rng(42)
    perturbed = clipper
    for attempt in range(8):
        try:
            results = _clip_once(subject, perturbed, op, eps=1e-11)
            return [_normalize(r) for r in results if abs(polygon_area(r)) > 0]
        except DegenerateGeometry:
            # Break the degeneracy deterministically: dilate the clipper very
            # slightly about its centroid (so touching shapes properly overlap)
            # and add a much smaller jitter to break collinearity.
            magnitude = 10.0 ** (attempt - 10)
            centroid = clipper.mean(axis=0)
            jitter = rng.normal(scale=0.01 * magnitude * scale,
                                size=clipper.shape)
            perturbed = centroid + (clipper - centroid) * (1 + magnitude) + jitter
    raise ValueError(
        "Polygon clipping failed: geometry remained degenerate after"
        " perturbation. Try Polygon.resample() to redistribute vertices."
    )
