"""The port's top-level API against the JAX package's.

* ``tdgl_tpu_torch.distance.cdist`` against scipy and against
  ``tdgl_tpu.distance.cdist``, chunked and validated, and the four
  distance helpers (mirrors of ``tests/test_distance_about.py``);
* ``version_dict``, ``version_table``, ``__git_revision__``,
  ``SolverResult`` and ``testing.run``;
* every public name of ``tdgl_tpu`` and of ``tdgl_tpu.visualization``
  exists in the port, and the port's ``visualization.__all__`` is the
  JAX package's.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial import distance as sp_distance

import tdgl_tpu
import tdgl_tpu.distance as jdistance
import tdgl_tpu.visualization
import tdgl_tpu_torch
import tdgl_tpu_torch.visualization
from tdgl_tpu_torch import distance
from tdgl_tpu_torch.about import version_dict, version_table


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("dim,m,n,seed", [(2, 137, 211, 0), (3, 53, 71, 1)])
def test_cdist_matches_scipy_and_reference(metric, dim, m, n, seed):
    rng = np.random.default_rng(seed)
    XA = rng.normal(size=(m, dim))
    XB = rng.normal(size=(n, dim))
    got = distance.cdist(XA, XB, metric=metric)
    np.testing.assert_allclose(
        got, sp_distance.cdist(XA, XB, metric=metric), atol=1e-12)
    assert np.array_equal(got, jdistance.cdist(XA, XB, metric=metric))


def test_cdist_chunked():
    rng = np.random.default_rng(2)
    XA = rng.normal(size=(500, 2))
    XB = rng.normal(size=(400, 2))
    got = distance.cdist(XA, XB, chunk_elements=1000)  # force many chunks
    np.testing.assert_allclose(got, sp_distance.cdist(XA, XB), atol=1e-12)
    assert np.array_equal(got, jdistance.cdist(XA, XB, chunk_elements=1000))


def test_cdist_validation():
    for args, kw in (((np.zeros((3, 2)), np.zeros((3, 3))), {}),
                     ((np.zeros((3, 4)), np.zeros((3, 4))), {}),
                     ((np.zeros((3, 2)), np.zeros((3, 2))),
                      {"metric": "cityblock"})):
        with pytest.raises(ValueError):
            distance.cdist(*args, **kw)


@pytest.mark.parametrize("name,dim", [
    ("sqeuclidean_distance_2d", 2), ("sqeuclidean_distance_3d", 3),
    ("euclidean_distance_2d", 2), ("euclidean_distance_3d", 3)])
def test_distance_helpers(name, dim):
    rng = np.random.default_rng(3)
    XA, XB = rng.normal(size=(20, dim)), rng.normal(size=(30, dim))
    assert np.array_equal(getattr(distance, name)(XA, XB),
                          getattr(jdistance, name)(XA, XB))


def test_version_dict_and_table():
    info = version_dict()
    for key in ("tdgl_tpu_torch", "torch", "numpy", "scipy", "cuda_device"):
        assert key in info
    html = version_table()
    text = getattr(html, "data", html)
    assert "<table>" in text and "tdgl_tpu_torch" in text
    assert version_table({"a": "1"}) is not None
    rev = tdgl_tpu_torch.__git_revision__
    assert rev is None or isinstance(rev, str)


def test_solver_result_fields():
    ours, theirs = tdgl_tpu_torch.SolverResult, tdgl_tpu.SolverResult
    assert ours._fields == theirs._fields
    assert ours._field_defaults == theirs._field_defaults


def _public(module):
    names = {n for n in dir(module) if not n.startswith("_")}
    return names | {"__git_revision__", "__version__", "__version_info__"}


def test_every_public_name_exists_in_the_port():
    missing = []
    for name in sorted(_public(tdgl_tpu)):
        if hasattr(tdgl_tpu_torch, name):
            continue
        try:
            # A submodule the JAX package has loaded by now.
            importlib.import_module(f"tdgl_tpu_torch.{name}")
        except ImportError:
            missing.append(name)
    assert not missing, missing
    for name in ("em", "fluxoid", "geometry", "visualization", "parallel",
                 "sources"):
        assert getattr(tdgl_tpu_torch, name).__name__ == (
            f"tdgl_tpu_torch.{name}")
    ours, theirs = tdgl_tpu_torch.visualization, tdgl_tpu.visualization
    assert ours.__all__ == theirs.__all__
    assert [n for n in ours.__all__ if not hasattr(ours, n)] == []
    assert ([q.name for q in ours.Quantity]
            == [q.name for q in theirs.Quantity])
    assert ours.DEFAULT_QUANTITIES == theirs.DEFAULT_QUANTITIES


def test_testing_run_collects_the_port_tests(monkeypatch):
    """``testing.run()`` hands pytest the port's own test files (the call
    is intercepted: running them is the suite's job)."""
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda args, cwd: calls.append(args) or 0)
    from tdgl_tpu_torch import testing

    assert testing.run() == 0
    (args,) = calls
    assert args[:3] == [sys.executable, "-m", "pytest"]
    files = [a for a in args if a.endswith(".py")]
    assert files and all("test_torch_" in f for f in files)
    assert any(f.endswith("test_torch_api.py") for f in files)
    # jax is importable here, so tests/conftest.py is used.
    assert "--noconftest" not in args
