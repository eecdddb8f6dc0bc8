"""Pairwise distance kernels (the counterpart of :mod:`tdgl_tpu.distance`).

API parity with the reference ``tdgl/distance.py:55`` (a Numba-parallel
``cdist``), in chunked NumPy broadcasting: vectorized, memory-bounded and
dependency-free. A host helper for analysis code; the solver computes its
distances in torch on the device.
"""

from __future__ import annotations

import numpy as np


def cdist(
    XA: np.ndarray, XB: np.ndarray, metric: str = "euclidean",
    chunk_elements: int = 50_000_000,
) -> np.ndarray:
    """Pairwise distances between two sets of 2D or 3D points.

    Args:
        XA: Shape ``(m, k)`` points (k = 2 or 3).
        XB: Shape ``(n, k)`` points.
        metric: ``"euclidean"`` or ``"sqeuclidean"``.
        chunk_elements: Bound on the number of temporary array elements.

    Returns:
        Shape ``(m, n)`` distance matrix.
    """
    XA = np.atleast_2d(np.asarray(XA, dtype=float))
    XB = np.atleast_2d(np.asarray(XB, dtype=float))
    if XA.ndim != 2 or XB.ndim != 2:
        raise ValueError("XA and XB must be 2D arrays.")
    if XA.shape[1] != XB.shape[1]:
        raise ValueError(
            f"Dimension mismatch: {XA.shape[1]} vs {XB.shape[1]}."
        )
    if XA.shape[1] not in (2, 3):
        raise ValueError("Points must be 2D or 3D.")
    if metric not in ("euclidean", "sqeuclidean"):
        raise ValueError(f"Unsupported metric: {metric!r}.")
    m, n = len(XA), len(XB)
    out = np.empty((m, n))
    rows_per_chunk = max(1, chunk_elements // max(n, 1))
    for start in range(0, m, rows_per_chunk):
        stop = min(start + rows_per_chunk, m)
        diff = XA[start:stop, None, :] - XB[None, :, :]
        out[start:stop] = np.sum(diff * diff, axis=2)
    if metric == "euclidean":
        np.sqrt(out, out=out)
    return out


def sqeuclidean_distance_2d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Squared Euclidean distances between 2D point sets (reference
    ``tdgl/distance.py:5-14``)."""
    return cdist(XA, XB, metric="sqeuclidean")


def sqeuclidean_distance_3d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Squared Euclidean distances between 3D point sets (reference
    ``tdgl/distance.py:17-27``)."""
    return cdist(XA, XB, metric="sqeuclidean")


def euclidean_distance_2d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Euclidean distances between 2D point sets (reference
    ``tdgl/distance.py:30-39``)."""
    return cdist(XA, XB, metric="euclidean")


def euclidean_distance_3d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Euclidean distances between 3D point sets (reference
    ``tdgl/distance.py:42-52``)."""
    return cdist(XA, XB, metric="euclidean")
