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
        candidates: Nearest triangle centroids tested per point before the
            exhaustive search.
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
        # Points beyond every triangle's reach lie outside the mesh; test
        # the rest against all triangles.
        reach = np.reshape(dist, (n, -1))[:, 0] <= self._reach
        for p in np.flatnonzero((index < 0) & reach):
            lam = self._barycentric(
                np.broadcast_to(xy[p], (len(self.triangles), 2)),
                np.arange(len(self.triangles)))
            hits = np.flatnonzero((lam >= -self._eps).all(axis=1))
            if len(hits):
                index[p] = hits[0]
                bary[p] = lam[hits[0]]
        return index, bary

    def __call__(self, values: np.ndarray, x, y) -> np.ndarray:
        """Interpolate vertex ``values`` at the points ``(x, y)``; NaN
        outside the mesh."""
        index, bary = self.find(x, y)
        values = np.asarray(values)
        out = np.full(len(index), np.nan, dtype=np.result_type(values, float))
        inside = index >= 0
        corners = self.triangles[index[inside]]
        out[inside] = np.einsum("pk,pk->p", bary[inside], values[corners])
        return out.reshape(np.shape(x))
