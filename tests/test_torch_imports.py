"""Import hygiene of the PyTorch port (an AST scan of tdgl_tpu_torch/ and
chip_smoke.py).

The port must run where neither jax nor the JAX package, nor h5py,
matplotlib, cloudpickle or tqdm, is installed: no module may import ``jax``
or ``tdgl_tpu`` anywhere, or ``h5py`` at all (the port writes HDF5 through
its own ``utils/h5lite``), module-level imports are limited to the standard
library, numpy, scipy, torch and the package itself, and ``triton``
appears nowhere (the kernels are CUDA C++)."""

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tdgl_tpu_torch")
ALLOWED_TOP = {"numpy", "scipy", "torch", "tdgl_tpu_torch"}


def _read(path):
    with open(path) as f:
        return f.read()


def _modules():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.join(root, name))
    return sorted(out)


def _imports(tree, module_level_only):
    """``(top-level package name, lineno)`` of every absolute import; with
    ``module_level_only`` the bodies of functions are skipped."""
    found = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if module_level_only and isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], child.lineno)
                             for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module.split(".")[0], child.lineno))
            visit(child)

    visit(tree)
    return found


@pytest.fixture(scope="module")
def trees():
    return {path: ast.parse(_read(path), path) for path in _modules()}


def test_package_has_modules(trees):
    names = {os.path.relpath(p, PKG) for p in trees}
    for required in ("convert.py", "ops/step_kernels.py", "ops/cg.py",
                     "ops/hexmg.py", "solver/grid_step.py",
                     "solver/solver.py", "models/gtdgl_stencil.py",
                     "solver/runner.py", "solver/solve.py",
                     "solution/solution.py", "solution/data.py",
                     "solution/tri_interp.py", "utils/h5lite.py",
                     "about.py", "version.py", "em.py", "fluxoid.py",
                     "ops/fft_screening.py", "ops/screening.py",
                     "sources/scaling.py", "sources/loop.py",
                     "sources/constant.py", "parameter.py",
                     "fv/operators.py", "models/gtdgl.py", "ops/amg.py",
                     "utils/pickles.py", "parallel/sweep.py"):
        assert required in names


def test_no_jax_or_reference_package_anywhere(trees):
    bad = [(os.path.relpath(p, PKG), name, line)
           for p, tree in trees.items()
           for name, line in _imports(tree, module_level_only=False)
           if name in ("jax", "jaxlib", "tdgl_tpu")]
    assert not bad, bad


def test_no_h5py_anywhere(trees):
    bad = [(os.path.relpath(p, PKG), line)
           for p, tree in trees.items()
           for name, line in _imports(tree, module_level_only=False)
           if name == "h5py"]
    assert not bad, bad


def test_module_level_imports_are_stdlib_numpy_scipy_torch(trees):
    bad = [(os.path.relpath(p, PKG), name, line)
           for p, tree in trees.items()
           for name, line in _imports(tree, module_level_only=True)
           if name not in ALLOWED_TOP
           and name not in sys.stdlib_module_names
           and name != "__future__"]
    assert not bad, bad


def test_triton_appears_nowhere(trees):
    for path in trees:
        assert "triton" not in _read(path).lower(), path
    csrc = os.path.join(PKG, "csrc")
    for name in os.listdir(csrc):
        assert "triton" not in _read(os.path.join(csrc, name)).lower()
