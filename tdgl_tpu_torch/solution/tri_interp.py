"""Linear interpolation on a triangle mesh, without matplotlib.

The JAX package interpolates with ``matplotlib.tri.LinearTriInterpolator``
on the device's triangulation; the machine that runs the port has no
matplotlib. :class:`LinearTriInterpolator` computes the same function:
the value at a point is the linear (barycentric) interpolation of the
vertex values over the mesh triangle that contains it, and NaN where no
triangle does (matplotlib masks those points; its ``.data`` holds NaN).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


class LinearTriInterpolator:
    """Find containing triangles and interpolate linearly.

    Args:
        points: ``(n, 2)`` vertex coordinates.
        triangles: ``(m, 3)`` vertex indices of each triangle.
        candidates: Nearest triangle centroids tested per point before
            the search among all triangles within reach.
    """

    def __init__(self, points: np.ndarray, triangles: np.ndarray,
                 candidates: int = 8):
        self.points = np.asarray(points, dtype=np.float64)
        self.triangles = np.asarray(triangles, dtype=np.int64)
        corners = self.points[self.triangles]            # (m, 3, 2)
        centroids = corners.mean(axis=1)
        self._origin = corners[:, 0]
        e1 = corners[:, 1] - corners[:, 0]
        e2 = corners[:, 2] - corners[:, 0]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        # Rows of the inverse of [e1 e2]: barycentric (l1, l2) of a point.
        self._inv = np.stack([
            np.stack([e2[:, 1], -e2[:, 0]], axis=1),
            np.stack([-e1[:, 1], e1[:, 0]], axis=1),
        ], axis=1) / det[:, None, None]                  # (m, 2, 2)
        self._tree = cKDTree(centroids)
        self._reach = float(np.linalg.norm(
            corners - centroids[:, None], axis=2).max())
        self._k = min(candidates, len(self.triangles))
        self._eps = 1e-10
        self._last = None

    def _barycentric(self, xy: np.ndarray, tri: np.ndarray) -> np.ndarray:
        """``(p, 3)`` barycentric coordinates of ``xy`` in triangles
        ``tri``."""
        d = xy - self._origin[tri]
        l12 = np.einsum("pij,pj->pi", self._inv[tri], d)
        return np.concatenate([1.0 - l12.sum(axis=1, keepdims=True), l12],
                              axis=1)

    def find(self, x, y):
        """Index of the triangle containing each point (-1 if none) and
        the point's barycentric coordinates in it."""
        xy = np.stack([np.ravel(x), np.ravel(y)], axis=1).astype(np.float64)
        n = len(xy)
        index = np.full(n, -1, dtype=np.int64)
        bary = np.full((n, 3), np.nan)
        dist, near = self._tree.query(xy, k=self._k)
        near = near.reshape(n, -1)
        for j in range(near.shape[1]):
            todo = np.flatnonzero(index < 0)
            if not len(todo):
                break
            tri = near[todo, j]
            lam = self._barycentric(xy[todo], tri)
            hit = (lam >= -self._eps).all(axis=1)
            index[todo[hit]] = tri[hit]
            bary[todo[hit]] = lam[hit]
        # Points beyond every triangle's reach lie outside the mesh. The
        # rest are tested in one pass against every triangle whose
        # centroid lies within that reach (a triangle that holds a point
        # does), the lowest index winning as in a scan of all triangles.
        rest = np.flatnonzero(
            (index < 0) & (np.reshape(dist, (n, -1))[:, 0] <= self._reach))
        if len(rest):
            lists = self._tree.query_ball_point(xy[rest],
                                                r=self._reach * (1 + 1e-9))
            counts = np.fromiter((len(c) for c in lists), np.int64,
                                 len(lists))
            pt = np.repeat(np.arange(len(rest)), counts)
            tri = np.fromiter((t for c in lists for t in sorted(c)),
                              np.int64, int(counts.sum()))
            lam = self._barycentric(xy[rest[pt]], tri)
            hit = np.flatnonzero((lam >= -self._eps).all(axis=1))
            # First hit of each point: its candidates are sorted.
            first = hit[np.unique(pt[hit], return_index=True)[1]]
            index[rest[pt[first]]] = tri[first]
            bary[rest[pt[first]]] = lam[first]
        return index, bary

    def _find_once(self, x, y):
        """:meth:`find`, kept for the last points asked for (a second
        quantity at the same points reuses it)."""
        xy = np.stack([np.ravel(x), np.ravel(y)], axis=1).astype(np.float64)
        if self._last is None or not np.array_equal(self._last[0], xy):
            self._last = (xy, *self.find(x, y))
        return self._last[1:]

    def __call__(self, values: np.ndarray, x, y) -> np.ndarray:
        """Interpolate vertex ``values`` (``(n,)``, or ``(n, k)`` for k
        quantities at once) at the points ``(x, y)``; NaN outside the
        mesh."""
        index, bary = self._find_once(x, y)
        values = np.asarray(values)
        out = np.full((len(index),) + values.shape[1:], np.nan,
                      dtype=np.result_type(values, float))
        inside = index >= 0
        corners = self.triangles[index[inside]]
        out[inside] = np.einsum("pk,pk...->p...", bary[inside],
                                values[corners])
        return out.reshape(np.shape(x) + values.shape[1:])
