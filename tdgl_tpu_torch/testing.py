"""Self-test entry point and fixtures for checking the step kernels.

:func:`run` (reference ``tdgl/testing.py:10``) runs the port's own test
files so an installation can verify itself. :func:`periodic_stencil` is
a fixture of the kernel checks, imported by the tests and by
``chip_smoke.py``; the solver does not use it.
"""

from __future__ import annotations

import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np

from .device.hexmesh import EDGE_OFFSETS


def run() -> int:
    """Run the port's test files (``tests/test_torch_*.py``) with pytest;
    returns pytest's exit code.

    Where jax is not importable (as on a GPU machine without the JAX
    package), ``--noconftest`` skips ``tests/conftest.py``, which imports
    jax; the files that compare with the JAX package then fail to import,
    and the ones that need only the port run.
    """
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo_root, "tests",
                                          "test_torch_*.py")))
    if not files:
        print("Test directory not found; install from source to run tests.")
        return 1
    args = [sys.executable, "-m", "pytest", *files, "-v"]
    if importlib.util.find_spec("jax") is None:
        args.append("--noconftest")
    return subprocess.call(args, cwd=repo_root)


def periodic_stencil(sten, seed: int):
    """``sten`` (host arrays) with every edge live, wrapped ones included.

    Random positive ``w``, ``dual``, ``inv_len`` and ``inv_area`` on every
    site and edge, ``valid = 1`` and ``fixed_mask = 0``; ``w_m`` and
    ``sym_diag`` follow from ``w`` as in ``build_stencil_operators``. On
    such a stencil the kernels' halo wrap is visible in the result (on a
    real one zero weights hide it), so it checks that edge tiles read the
    values ``torch.roll`` gives. Works on either package's
    ``StencilOperators``.
    """
    rng = np.random.default_rng(seed)
    valid = np.asarray(sten.valid)
    shape, dtype = valid.shape, valid.dtype

    def positive(*lead):
        return rng.uniform(0.5, 1.5, lead + shape).astype(dtype)

    w = positive(3)
    w_m = np.stack([np.roll(w[k], off, axis=(0, 1))
                    for k, off in enumerate(EDGE_OFFSETS)])
    inv_area = positive()
    return sten._replace(
        valid=np.ones(shape, dtype), edge_valid=np.ones((3,) + shape, dtype),
        w=w, w_m=w_m, dual=positive(3), inv_len=positive(3),
        sym_diag=(w + w_m).sum(axis=0).astype(dtype),
        area=(1.0 / inv_area).astype(dtype), inv_area=inv_area,
        fixed_mask=np.zeros(shape, dtype),
    )
