"""Vectorized finite-volume mesh utilities: edges, circumcenters, Voronoi dual.

Semantics follow the reference ``tdgl/finite_volume/util.py:15-356`` with two
implementation differences (both NumPy-vectorized instead of per-site Python
loops):

* Voronoi cell areas are computed by the exact signed decomposition
  ``cell(v) = sum over incident triangles t of quad(v, mid(v,a), c_t, mid(v,b))``
  where ``c_t`` is the circumcenter of ``t``. This partitions the mesh exactly
  (site areas always sum to the total mesh area), including for boundary cells,
  where the reference instead completes the cell via a convex hull and a
  concavity correction (``util.py:169-255``).
* Boundary loop extraction walks the boundary-edge adjacency directly rather
  than using shapely polygonize.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def get_edges(elements: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique (sorted) edges of a triangulation and a boundary mask.

    Args:
        elements: Shape ``(m, 3)`` triangle indices.

    Returns:
        ``(edges, is_boundary)``: shape ``(e, 2)`` int array with
        ``edges[:, 0] < edges[:, 1]``, and a boolean mask marking edges that
        belong to exactly one triangle.
    """
    edges = np.concatenate([elements[:, (0, 1)], elements[:, (1, 2)],
                            elements[:, (2, 0)]])
    edges = np.sort(edges, axis=1)
    edges, counts = np.unique(edges, axis=0, return_counts=True)
    return edges, counts == 1


def get_edge_lengths(points: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Lengths of all unique edges."""
    edges, _ = get_edges(elements)
    return np.linalg.norm(points[edges[:, 1]] - points[edges[:, 0]], axis=1)


def get_max_edge_length(points: np.ndarray, elements: np.ndarray) -> float:
    """Maximum edge length in the triangulation."""
    return float(get_edge_lengths(points, elements).max())


def triangle_areas(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Signed areas of the triangles (positive for CCW orientation)."""
    p = points[triangles]
    return 0.5 * (
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    )


def circumcenters(sites: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Circumcenters of all triangles (= Voronoi vertices of the dual mesh)."""
    a = sites[elements[:, 0]]
    b = sites[elements[:, 1]] - a
    c = sites[elements[:, 2]] - a
    d = 2 * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0])
    b2 = np.sum(b * b, axis=1)
    c2 = np.sum(c * c, axis=1)
    ux = (c[:, 1] * b2 - b[:, 1] * c2) / d
    uy = (b[:, 0] * c2 - c[:, 0] * b2) / d
    return np.stack([ux, uy], axis=1) + a


def edge_to_triangles(edges: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Map each unique edge to its (1 or 2) adjacent triangle indices.

    Returns:
        Shape ``(e, 2)`` int array of triangle indices; the second entry is
        ``-1`` for boundary edges.
    """
    tri_edges = np.concatenate([elements[:, (0, 1)], elements[:, (1, 2)],
                                elements[:, (2, 0)]])
    tri_edges = np.sort(tri_edges, axis=1)
    tri_index = np.tile(np.arange(len(elements)), 3)
    # Lexicographic sort of (edge, tri) pairs groups duplicates together.
    order = np.lexsort((tri_edges[:, 1], tri_edges[:, 0]))
    sorted_edges = tri_edges[order]
    sorted_tris = tri_index[order]
    # Each unique edge appears once or twice, consecutively after sorting.
    new_group = np.ones(len(sorted_edges), dtype=bool)
    new_group[1:] = np.any(sorted_edges[1:] != sorted_edges[:-1], axis=1)
    group_id = np.cumsum(new_group) - 1
    n_edges = group_id[-1] + 1
    occurrence = np.arange(len(sorted_edges)) - np.flatnonzero(new_group)[group_id]
    out = -np.ones((n_edges, 2), dtype=np.int64)
    out[group_id, occurrence] = sorted_tris
    # The unique-sorted edges here match np.unique's ordering in get_edges.
    return out


def get_dual_edge_lengths(
    sites: np.ndarray,
    elements: np.ndarray,
    dual_sites: np.ndarray,
    edges: np.ndarray,
) -> np.ndarray:
    """Length of the Voronoi (dual) edge crossing each mesh edge.

    For interior edges this is the distance between the circumcenters of the
    two adjacent triangles; for boundary edges, the distance from the single
    circumcenter to the edge midpoint (cf. reference ``util.py:59-97``).
    """
    adj = edge_to_triangles(edges, elements)
    centers = 0.5 * (sites[edges[:, 0]] + sites[edges[:, 1]])
    c0 = dual_sites[adj[:, 0]]
    boundary = adj[:, 1] < 0
    c1 = np.where(boundary[:, None], centers, dual_sites[np.maximum(adj[:, 1], 0)])
    return np.linalg.norm(c1 - c0, axis=1)


def voronoi_site_areas(
    sites: np.ndarray, elements: np.ndarray, dual_sites: np.ndarray
) -> np.ndarray:
    """Voronoi cell area of each site via exact signed decomposition.

    For each triangle ``(i, j, k)`` with circumcenter ``c``, the piece of
    site ``i``'s cell inside the triangle is the quadrilateral
    ``(r_i, mid(r_i, r_j), c, mid(r_i, r_k))``. Signed areas handle obtuse
    triangles (circumcenter outside) correctly, and the site areas always sum
    to the total mesh area.
    """
    n = len(sites)
    areas = np.zeros(n)
    c = dual_sites  # (m, 2)

    def quad_area(p0, p1, p2, p3):
        # Shoelace for quadrilateral p0-p1-p2-p3.
        x = np.stack([p[:, 0] for p in (p0, p1, p2, p3)], axis=1)
        y = np.stack([p[:, 1] for p in (p0, p1, p2, p3)], axis=1)
        xn = np.roll(x, -1, axis=1)
        yn = np.roll(y, -1, axis=1)
        return 0.5 * np.sum(x * yn - xn * y, axis=1)

    for v in range(3):
        i = elements[:, v]
        j = elements[:, (v + 1) % 3]
        k = elements[:, (v + 2) % 3]
        ri, rj, rk = sites[i], sites[j], sites[k]
        mid_ij = 0.5 * (ri + rj)
        mid_ik = 0.5 * (ri + rk)
        # Triangle orientation: for CCW (i, j, k), the path
        # r_i -> mid_ij -> c -> mid_ik is CCW.
        contrib = quad_area(ri, mid_ij, c, mid_ik)
        np.add.at(areas, i, contrib)
    return areas


def get_voronoi_polygon_indices(
    elements: np.ndarray, num_sites: int
) -> List[np.ndarray]:
    """For each site, the indices of its incident triangles (= indices of the
    Voronoi vertices surrounding the site)."""
    flat_sites = elements.ravel()
    flat_tris = np.repeat(np.arange(len(elements)), 3)
    order = np.argsort(flat_sites, kind="stable")
    sorted_sites = flat_sites[order]
    sorted_tris = flat_tris[order]
    splits = np.searchsorted(sorted_sites, np.arange(1, num_sites))
    return np.split(sorted_tris, splits)


def build_voronoi_polygons(
    sites: np.ndarray,
    elements: np.ndarray,
    dual_sites: np.ndarray,
    edges: np.ndarray,
    boundary_edge_indices: np.ndarray,
    boundary_indices: np.ndarray,
) -> List[np.ndarray]:
    """CCW-oriented Voronoi cell vertices for each site (for plotting/IO).

    Interior cells are the circumcenters of the incident triangles; boundary
    cells additionally include the midpoints of the two adjacent boundary
    edges and the site itself (same construction as the reference
    ``util.py:205-254``).
    """
    polygon_indices = get_voronoi_polygon_indices(elements, len(sites))
    boundary_set = set(boundary_indices.tolist())
    boundary_edges = edges[boundary_edge_indices]
    polygons: List[np.ndarray] = []
    for site, tri_ix in enumerate(polygon_indices):
        poly = dual_sites[tri_ix]
        if site in boundary_set:
            attached = boundary_edges[np.any(boundary_edges == site, axis=1)]
            midpoints = sites[attached].mean(axis=1)
            poly = np.concatenate([poly, midpoints, sites[site][None]], axis=0)
        # Sort CCW about the mean.
        d = poly - poly.mean(axis=0)
        poly = poly[np.argsort(np.arctan2(d[:, 1], d[:, 0]))]
        polygons.append(poly)
    return polygons


def convex_polygon_centroid(points: np.ndarray) -> Tuple[float, float]:
    """Centroid of a convex polygon given unordered vertices."""
    d = points - points.mean(axis=0)
    pts = points[np.argsort(np.arctan2(d[:, 1], d[:, 0]))]
    x, y = pts[:, 0], pts[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    area = 0.5 * np.sum(cross)
    if abs(area) < 1e-300:
        return tuple(points.mean(axis=0))
    cx = np.sum((x + xn) * cross) / (6 * area)
    cy = np.sum((y + yn) * cross) / (6 * area)
    return (float(cx), float(cy))


def get_oriented_boundary(
    points: np.ndarray, boundary_edges: np.ndarray
) -> List[np.ndarray]:
    """Closed boundary loops as arrays of site indices, each oriented CCW.

    Returns one loop for the outer boundary plus one per hole (cf. reference
    ``util.py:334-356``).
    """
    # adjacency: each boundary site connects to exactly 2 boundary edges
    from collections import defaultdict

    neighbors = defaultdict(list)
    for a, b in boundary_edges:
        neighbors[int(a)].append(int(b))
        neighbors[int(b)].append(int(a))
    unvisited = set(neighbors.keys())
    loops = []
    while unvisited:
        start = min(unvisited)
        loop = [start]
        unvisited.discard(start)
        prev, current = None, start
        while True:
            nbrs = neighbors[current]
            nxt = nbrs[0] if nbrs[0] != prev else (nbrs[1] if len(nbrs) > 1 else None)
            if nxt is None or nxt == start:
                break
            loop.append(nxt)
            unvisited.discard(nxt)
            prev, current = current, nxt
        loop = np.array(loop, dtype=np.int64)
        # orient CCW
        coords = points[loop]
        x, y = coords[:, 0], coords[:, 1]
        area = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
        if area < 0:
            loop = loop[::-1]
        loops.append(loop)
    # Outer boundary (largest enclosed area) first.
    def loop_area(lp):
        c = points[lp]
        return abs(0.5 * np.sum(c[:, 0] * np.roll(c[:, 1], -1)
                                - np.roll(c[:, 0], -1) * c[:, 1]))

    loops.sort(key=loop_area, reverse=True)
    return loops
