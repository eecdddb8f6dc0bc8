"""Native (C++) host-runtime kernels, bound via ctypes.

The shared library is built on demand with ``g++ -O3 -march=native`` and
cached next to the source, keyed by the source and the host's CPU (rebuilt
when either changes, so a copy built on another machine is not loaded). Every entry point has a pure
NumPy fallback, so the package works without a compiler; the native path
accelerates the host-side geometry runtime (polygon booleans, containment,
distances) by 1-2 orders of magnitude.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "geometry_kernels.cpp")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

OK, DEGENERATE, OVERFLOWED = 0, 1, 2


def _host_cpu() -> bytes:
    """The CPU model and feature flags (``-march=native`` depends on
    them), from ``/proc/cpuinfo`` where it exists."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        import platform

        return platform.processor().encode()
    keep = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def _build_library() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + _host_cpu()).hexdigest()[:12]
    lib_path = os.path.join(_HERE, f"_geometry_kernels_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = tempfile.mktemp(suffix=".so", dir=_HERE)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        # Clean stale builds.
        for name in os.listdir(_HERE):
            if (name.startswith("_geometry_kernels_") and name.endswith(".so")
                    and name != os.path.basename(lib_path)):
                try:
                    os.remove(os.path.join(_HERE, name))
                except OSError:
                    pass
        return lib_path
    except (subprocess.SubprocessError, OSError) as exc:
        logger.info("Native geometry kernels unavailable (%s); using the"
                    " NumPy fallback.", exc)
        return None


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native kernel library, or None."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        logger.info("Failed to load native kernels: %s", exc)
        return None
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.find_intersections.restype = ctypes.c_int
    lib.find_intersections.argtypes = [
        c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64,
        ctypes.c_double, c_int64_p, c_int64_p, c_double_p, c_double_p,
        ctypes.c_int64, c_int64_p,
    ]
    lib.is_simple_polygon.restype = ctypes.c_int
    lib.is_simple_polygon.argtypes = [
        c_double_p, ctypes.c_int64, ctypes.c_double,
    ]
    lib.points_in_polygon.restype = None
    lib.points_in_polygon.argtypes = [
        c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64, c_uint8_p,
    ]
    lib.distance_to_polygon.restype = None
    lib.distance_to_polygon.argtypes = [
        c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64, c_double_p,
    ]
    _lib = lib
    return _lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def find_intersections(
    subject: np.ndarray, clipper: np.ndarray, eps: float
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """All proper intersections between two closed rings.

    Returns ``(si, ci, t, u)`` arrays, or raises the same
    ``DegenerateGeometry`` the Python path uses. Returns None if the native
    library is unavailable (caller falls back to Python).
    """
    lib = get_library()
    if lib is None:
        return None
    from ..device.clipping import DegenerateGeometry

    subject = np.ascontiguousarray(subject, dtype=np.float64)
    clipper = np.ascontiguousarray(clipper, dtype=np.float64)
    cap = 16 + 4 * (len(subject) + len(clipper))
    while True:
        si = np.empty(cap, dtype=np.int64)
        ci = np.empty(cap, dtype=np.int64)
        t = np.empty(cap, dtype=np.float64)
        u = np.empty(cap, dtype=np.float64)
        count = ctypes.c_int64(0)
        status = lib.find_intersections(
            _as_c(subject), len(subject), _as_c(clipper), len(clipper),
            ctypes.c_double(eps),
            si.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _as_c(t), _as_c(u), cap, ctypes.byref(count),
        )
        if status == DEGENERATE:
            raise DegenerateGeometry("native: degenerate configuration")
        if status == OVERFLOWED:
            cap *= 4
            continue
        n = count.value
        return si[:n], ci[:n], t[:n], u[:n]


def is_simple_polygon_native(poly: np.ndarray,
                             tol: float = 1e-12) -> Optional[bool]:
    """Whether the ring has no proper self-intersections; None if the native
    library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    poly = np.ascontiguousarray(poly, dtype=np.float64)
    return bool(lib.is_simple_polygon(_as_c(poly), len(poly),
                                      ctypes.c_double(tol)))


def points_in_polygon_native(points: np.ndarray,
                             poly: np.ndarray) -> Optional[np.ndarray]:
    """Batched even-odd containment test; None if native lib unavailable."""
    lib = get_library()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    poly = np.ascontiguousarray(poly, dtype=np.float64)
    out = np.empty(len(points), dtype=np.uint8)
    lib.points_in_polygon(
        _as_c(points), len(points), _as_c(poly), len(poly),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def distance_to_polygon_native(points: np.ndarray,
                               poly: np.ndarray) -> Optional[np.ndarray]:
    """Batched exact point-to-boundary distance; None if unavailable."""
    lib = get_library()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    poly = np.ascontiguousarray(poly, dtype=np.float64)
    out = np.empty(len(points), dtype=np.float64)
    lib.distance_to_polygon(
        _as_c(points), len(points), _as_c(poly), len(poly), _as_c(out),
    )
    return out
