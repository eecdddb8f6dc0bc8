"""Build and load the hand-written CUDA step kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and link into one shared
library with a plain C interface, loaded through ``ctypes`` — no PyTorch
headers and no ninja, so a cold build takes seconds. The build runs at
first use, from the package's own sources, into ``tdgl_tpu_torch/_build/``
(git-ignored), and is reused while the sources and flags are unchanged.
Nothing here is imported or built until a kernel is launched on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("psi_update.cu", "poisson_rhs.cu")
HEADERS = ("stencil_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Filled by load_library(): build seconds, whether a cached library was
# reused, the library path and nvcc's output (ptxas register/spill report).
BUILD_INFO: dict = {}

# The kernels' (rows, cols) site tile, read from the library by
# load_library(); the grid must be a multiple of it.
TILE: Optional[Tuple[int, int]] = None

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's conventional install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA step"
        " kernels are built from tdgl_tpu_torch/csrc at first use."
    )


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile the kernels (unless an up-to-date build exists) and return
    the library path. Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libtdgl_step_{_digest()}.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=True,
                          path=lib_path, log="")
        return lib_path
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # One nvcc per source, all at once; then one link.
        objects = [os.path.join(tmp, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj,
                 os.path.join(CSRC_DIR, src)]
                for src, obj in zip(SOURCES, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        out = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", "-o", out, *objects]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(out, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      path=lib_path, log="".join(logs))
    return lib_path


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call); also sets
    :data:`TILE`."""
    global _lib, TILE
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    rows, cols = ctypes.c_int(), ctypes.c_int()
    lib.tdgl_step_tile.restype = None
    lib.tdgl_step_tile(ctypes.byref(rows), ctypes.byref(cols))
    TILE = (rows.value, cols.value)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("tdgl_psi_update_f32", "tdgl_psi_update_f64"):
        fn = getattr(lib, name)
        fn.restype = i
        # pr pi old_sq mu eps w sym_diag inv_area fixed valid ur ui cf sf
        # cg sg factored dt gamma u out_r out_i out_sq flag ok rows cols
        # members strides stream
        fn.argtypes = [p] * 16 + [i, p, d, d, p, p, p, p, p, i, i, i, p, p]
    for name in ("tdgl_poisson_rhs_f32", "tdgl_poisson_rhs_f64"):
        fn = getattr(lib, name)
        fn.restype = i
        # pr pi ur ui cf sf cg sg factored inv_len dual dA_dt inv_area
        # neumann rhs js rows cols members strides stream
        fn.argtypes = [p] * 8 + [i] + [p] * 7 + [i, i, i, p, p]
    _lib = lib
    return lib
