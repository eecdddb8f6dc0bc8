"""Self-test entry point and fixtures for checking the step kernels.

:func:`run` (reference ``tdgl/testing.py:10``) runs the port's own test
files so an installation can verify itself. :func:`periodic_stencil` is
a fixture of the kernel checks, imported by the tests and by
``chip_smoke.py``; :func:`one_hierarchy_per_mesh` lets the tests build
each mesh's multigrid hierarchy once, :class:`PerKey` lets a module
fixture run each of its solves only where a test reads it, and
:func:`session_file` lets the test files share a solve's output file.
The solver uses none of them.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def one_hierarchy_per_mesh(*targets):
    """While open, each ``(module, name)`` in ``targets`` names a
    multigrid build function (``build_hexmg(sten, maps, mesh, ...)``,
    either package's) that runs once per mesh: a later call on the same
    grid, sites, edges and arguments returns the hierarchy the first call
    built (the build reads only those, and its coarsest pseudo-inverse is
    most of a solver's set-up). Each target keeps its own hierarchies."""
    saved = []
    for module, name in targets:
        original = getattr(module, name)

        def build_once(sten, maps, mesh, *args, _fn=original, _built={},
                       **kwargs):
            key = (tuple(maps.shape), np.asarray(maps.site_flat).tobytes(),
                   np.asarray(mesh.sites).tobytes(),
                   np.asarray(mesh.edge_mesh.edges).tobytes(), args,
                   tuple(sorted(kwargs.items())))
            if key not in _built:
                _built[key] = _fn(sten, maps, mesh, *args, **kwargs)
            return _built[key]

        saved.append((module, name, original))
        setattr(module, name, build_once)
    try:
        yield
    finally:
        for module, name, original in reversed(saved):
            setattr(module, name, original)


def session_file(tmp_path_factory, name: str, make) -> str:
    """The path of ``name``, a file that ``make(path)`` writes once per
    pytest session: every test module and pytest-xdist worker of the
    session that asks for it gets the same file (a lock serialises the
    first write), so a solve that a module fixture of several test files
    needs runs once. The file lives in the session's temporary directory,
    which the workers share."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = str(base / name)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            make(path)
    return path


class PerKey(dict):
    """A dict that makes a missing key's value with ``make(key)`` on first
    use. A module fixture that returns one holds several independent
    set-ups (each package's solve, each backend's runs), and a test file
    pays only for the keys its tests read."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, key):
        self[key] = value = self._make(key)
        return value
