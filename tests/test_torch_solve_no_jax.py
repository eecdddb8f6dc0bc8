"""``solve()`` in a process where h5py, cloudpickle, tqdm, matplotlib, jax
and tdgl_tpu cannot be imported, and a seed from the JAX package's file
there.

The fixtures are in ``tests/test_torch_solve.py``.
"""

import os
import subprocess
import sys
import textwrap

import pytest

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_solve import f64_pair, one_blas_thread, one_hierarchy_per_mesh


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- (e) no h5py, cloudpickle, tqdm, matplotlib, jax or tdgl_tpu ---------------
# One process for (e) and the seed of (f): each part prints "ok <part>"
# or its traceback.
_NO_JAX_PROCESS = textwrap.dedent("""
    import sys
    import traceback
    for name in ("h5py", "cloudpickle", "tqdm", "matplotlib", "jax",
                 "tdgl_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import tdgl_tpu_torch as ttdgl


    def solve_without_extras(out):
        layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                            thickness=0.1, conductivity=10.0)
        film = ttdgl.Polygon("film", points=ttdgl.box(10)).resample(100)
        source = ttdgl.Polygon("source",
                               points=ttdgl.box(1, 4, center=(-5, 0)))
        drain = ttdgl.Polygon("drain", points=ttdgl.box(1, 4, center=(5, 0)))
        device = ttdgl.Device("box", layer=layer, film=film,
                              terminals=[source, drain],
                              probe_points=[(-2, 0), (2, 0)],
                              length_units="um")
        device.make_mesh(min_points=400, structured=True)
        options = ttdgl.SolverOptions(solve_time=0.02, skip_time=0.01,
                                      dt_init=1e-3, save_every=10,
                                      output_file=out,
                                      field_units="mT", current_units="uA")
        kw = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=2.0, drain=-2.0),
                  torch_device="cpu")
        solution = ttdgl.solve(device, options, **kw)
        assert ttdgl.Solution.from_hdf5(solution.path).equals(solution)
        # Thermalization (skip_time) ran first; the clock restarted at 0.
        assert solution.tdgl_data.state["step"] == len(solution.dynamics.dt)
        assert np.isfinite(solution.magnetic_moment(with_units=False))
        assert solution.hole_fluxoid is not None
        try:
            ttdgl.solve(device, options, disorder_epsilon=lambda r: 1.0,
                        **kw)
        except ValueError as exc:
            assert "disorder_epsilon" in str(exc), exc
        else:
            raise AssertionError("a lambda pickled without cloudpickle")
        missing = [m for m in ("h5py", "cloudpickle", "tqdm", "matplotlib",
                               "jax", "tdgl_tpu") if sys.modules.get(m)]
        assert not missing, missing
        return solution.data_range


    def seed_from_jax_file(path, out):
        seed = ttdgl.Solution.from_hdf5(path)
        assert seed.data_range == (0, 5), seed.data_range
        assert seed.terminal_currents == {"source": 5.0, "drain": -5.0}
        assert isinstance(seed.applied_vector_potential, ttdgl.Parameter)
        # The JAX package stored its uniform disorder by value with
        # cloudpickle, which this process lacks: reading it raises, the
        # rest loads.
        try:
            seed.disorder_epsilon
        except RuntimeError as exc:
            assert "cloudpickle" in str(exc), exc
        else:
            raise AssertionError("a cloudpickle stream loaded without it")
        options = ttdgl.SolverOptions(solve_time=0.005, dt_init=1e-3,
                                      adaptive=False, save_every=5,
                                      dtype="float64", output_file=out,
                                      field_units="mT", current_units="uA")
        solution = ttdgl.solve(seed.device, options,
                               applied_vector_potential=0.5,
                               terminal_currents=seed.terminal_currents,
                               seed_solution=seed, torch_device="cpu")
        solution.solve_step = 0
        assert np.array_equal(solution.tdgl_data.psi, seed.tdgl_data.psi)
        assert ("tdgl_tpu" not in sys.modules
                or sys.modules["tdgl_tpu"] is None)
        loaded = [m for m in sys.modules if m.startswith("tdgl_tpu.")]
        assert not loaded, loaded
        return solution.data_range


    for part, run, args in (
            ("no extras", solve_without_extras, sys.argv[1:2]),
            ("jax file seed", seed_from_jax_file, sys.argv[2:4])):
        try:
            print("ok", part, run(*args))
        except BaseException:
            print("failed", part)
            traceback.print_exc()
""")


@pytest.fixture(scope="module")
def no_jax_process(f64_pair, tmp_path_factory):
    """(e) and the seed of (f) in one process where h5py, cloudpickle,
    tqdm, matplotlib, jax and tdgl_tpu cannot be imported."""
    tmp = tmp_path_factory.mktemp("no_jax")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    result = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PROCESS, str(tmp / "out.h5"),
         f64_pair["jax"].path, str(tmp / "seeded.h5")],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    return result


def _part_ok(result, part):
    assert f"ok {part}" in result.stdout, (result.stdout,
                                           result.stderr[-3000:])


def test_solve_without_optional_packages(no_jax_process):
    _part_ok(no_jax_process, "no extras")


def test_jax_file_seeds_without_jax(no_jax_process):
    _part_ok(no_jax_process, "jax file seed")
