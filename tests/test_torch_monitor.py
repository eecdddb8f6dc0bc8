"""The port's live-monitoring path: the ``<file>.h5.tmp`` side file that
``solve()`` writes, the h5lite in-place write it is built on, and
``monitor_solution``.

* A port ``solve()`` in a subprocess writes the side file while this
  process reads it through h5lite until ``step`` advances (mirrors
  ``tests/test_monitor.py:33``, which reads the JAX package's SWMR file
  with h5py).
* h5lite's in-place write keeps the data's address and the file's other
  bytes, and a process killed halfway through one leaves a readable file.
* ``monitor_solution`` under Agg draws the latest snapshot and returns
  once the side file is removed; ``SolverOptions(monitor=True)`` starts
  the monitor's subprocess, and raises ``ImportError`` before the first
  step where matplotlib is missing.

Every wait has its own deadline, so no test can hang the suite.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import h5py
import numpy as np
import pytest
import torch

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.solver import runner as runner_module
from tdgl_tpu_torch.solver.runner import DataHandler
from tdgl_tpu_torch.utils import h5lite
from tdgl_tpu_torch.visualization import monitor_solution
from tdgl_tpu_torch.visualization.monitor import read_latest

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND="Agg",
           OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")

SOLVE_SCRIPT = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    import tdgl_tpu_torch as tdgl

    layer = tdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = tdgl.Polygon("film", points=tdgl.box(8)).resample(100)
    device = tdgl.Device("film", layer=layer, film=film)
    device.make_mesh(min_points=400, smooth=10)
    options = tdgl.SolverOptions(
        solve_time=10000.0, dt_init=1e-4, dt_max=1e-4, adaptive=False,
        save_every=50, output_file=sys.argv[1],
    )
    tdgl.solve(device, options, torch_device="cpu",
               applied_vector_potential=tdgl.ConstantField(
                   20, field_units="uT"))
""")


def _small_device():
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1)
    film = ttdgl.Polygon("film", points=ttdgl.box(6)).resample(60)
    device = ttdgl.Device("film", layer=layer, film=film)
    device.make_mesh(min_points=150, smooth=10)
    return device


def test_side_file_read_while_solving(tmp_path):
    out = str(tmp_path / "live.h5")
    tmp_file = out + ".tmp"
    proc = subprocess.Popen(
        [sys.executable, "-c", SOLVE_SCRIPT, out], cwd=str(tmp_path),
        env=ENV, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def read_state():
        with h5lite.File(tmp_file, "r") as f:
            grp = f["data/-1"]
            psi = np.asarray(grp["psi"])
            return int(np.asarray(grp["step"])[0]), psi, "solution/device" in f

    try:
        deadline = time.time() + 120
        while True:
            assert time.time() < deadline, "the side file never held psi"
            assert proc.poll() is None, "the solve ended early"
            try:
                step1, psi1, has_device = read_state()
                break
            except (KeyError, OSError):
                time.sleep(0.25)
        assert has_device
        deadline = time.time() + 120
        while True:
            assert time.time() < deadline, "step never advanced"
            time.sleep(0.5)
            try:
                step2, psi2, _ = read_state()
            except OSError:
                continue
            if step2 > step1:
                break
        assert psi1.shape == psi2.shape and np.iscomplexobj(psi2)
        assert np.isfinite(psi2).all()
        # h5py reads the file h5lite keeps rewriting in place.
        with h5py.File(tmp_file, "r") as f:
            assert "solution/device" in f and "psi" in f["data/-1"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_inplace_write_keeps_addresses_and_survives_a_kill(tmp_path):
    path = str(tmp_path / "inplace.h5")
    with h5lite.File(path, "w") as f:
        f["a/x"] = np.arange(4096, dtype=np.float64)
        f["a/step"] = np.array([0])
    with open(path, "rb") as fh:
        before = fh.read()
    with h5lite.File(path, "r+") as f:
        node = f["a/x"]._node
        addr = node.data_addr
        blocks = [(n.data_addr, n.data_addr + n.data_size)
                  for n in (node, f["a/step"]._node)]
        f["a/x"][:] = np.full(4096, 2.0)
        f["a/step"][...] = [7]
        with pytest.raises(ValueError):
            f["a/x"][:] = np.zeros(10)
        with pytest.raises(TypeError):
            f["a/x"][:10] = np.zeros(10)
        assert f["a/x"]._node.data_addr == addr
    with open(path, "rb") as fh:
        after = fh.read()
    assert len(after) == len(before)
    # Only the two data blocks changed (the superblock is rewritten with
    # the same bytes).
    changed = np.flatnonzero(np.frombuffer(before, np.uint8)
                             != np.frombuffer(after, np.uint8))
    assert len(changed) and all(any(lo <= i < hi for lo, hi in blocks)
                                for i in changed)
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["a/x"][:], np.full(4096, 2.0))
        assert int(f["a/step"][0]) == 7

    # A writer killed halfway through an in-place write: the first half
    # of the block holds the new values, the file opens in both readers.
    script = textwrap.dedent("""
        import os, signal, sys
        import numpy as np
        from tdgl_tpu_torch.utils import h5lite

        f = h5lite.File(sys.argv[1], "r+")
        def half_then_die(addr, data):
            data = bytes(data)
            f._fh.seek(addr)
            f._fh.write(data[:len(data) // 2])
            f._fh.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        f._write = half_then_die
        f["a/x"][:] = np.full(4096, 3.0)
    """)
    proc = subprocess.run([sys.executable, "-c", script, path], env=ENV,
                          capture_output=True, timeout=120)
    assert proc.returncode == -9, proc.stderr
    expected = np.r_[np.full(2048, 3.0), np.full(2048, 2.0)]
    with h5lite.File(path, "r") as f:
        assert np.array_equal(np.asarray(f["a/x"]), expected)
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["a/x"][:], expected)


def _snapshot_arrays(mesh, rng):
    n, e = len(mesh.sites), len(mesh.edge_mesh.edges)
    return dict(psi=rng.normal(size=n) + 1j * rng.normal(size=n),
                mu=rng.normal(size=n), supercurrent=rng.normal(size=e),
                normal_current=rng.normal(size=e))


def test_side_file_protocol(tmp_path):
    """The side file of ``tdgl_tpu/solver/runner.py:60-150``: created
    beside the output (the name loop skips a stale side file), ``data/-1``
    with step/time/dt, mirrored fixed arrays, ``solution/device``, each
    snapshot's arrays in place, removed on close."""
    device = _small_device()
    rng = np.random.default_rng(0)
    out = str(tmp_path / "run.h5")
    open(out + ".tmp", "w").close()       # another run's side file
    with DataHandler(out) as dh:
        assert dh.output_path == str(tmp_path / "run-1.h5")
        assert dh.tmp_path == dh.output_path + ".tmp"
        assert not os.path.exists(out)
        dh.save_fixed_values({"epsilon": np.ones(len(device.mesh.sites))})
        dh.save_device(device)
        with h5lite.File(dh.tmp_path, "r") as f:
            assert int(np.asarray(f["data/-1/step"])[0]) == 0
            assert "solution/device" in f
            addr = f["data/-1"]._node.addr
        for step in (0, 50):
            data = _snapshot_arrays(device.mesh, rng)
            dh.save_time_step(dict(step=step, time=step * 1e-3, dt=1e-3),
                              data, None)
            with h5lite.File(dh.tmp_path, "r") as f:
                grp = f["data/-1"]
                assert int(np.asarray(grp["step"])[0]) == step
                assert np.array_equal(np.asarray(grp["psi"]), data["psi"])
                assert np.array_equal(np.asarray(f["epsilon"]),
                                      np.ones(len(device.mesh.sites)))
                if step == 0:
                    addr = grp._node.addr
                    size = os.path.getsize(dh.tmp_path)
                else:
                    # No header moved and the file did not grow.
                    assert grp._node.addr == addr
                    assert os.path.getsize(dh.tmp_path) == size
    assert not os.path.exists(dh.tmp_path)
    assert os.path.exists(dh.output_path)


def test_monitor_returns_when_the_side_file_goes(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    from tdgl_tpu_torch.visualization import monitor

    device = _small_device()
    rng = np.random.default_rng(1)
    handler = DataHandler(str(tmp_path / "mon.h5")).__enter__()
    handler.save_device(device)
    handler.save_time_step(dict(step=0, time=0.0, dt=1e-3),
                           _snapshot_arrays(device.mesh, rng), None)
    drawn = []

    def recorded(*args):
        out = read_latest(*args)
        drawn.append(out[0])
        return out

    monkeypatch.setattr(monitor, "read_latest", recorded)

    def writer():
        # Advance the step until the monitor has read two snapshots, then
        # end the run (removing the side file); at the latest after 60 s.
        try:
            deadline = time.time() + 60
            step = 0
            while time.time() < deadline and len(set(drawn)) < 2:
                step += 1
                handler.save_time_step(
                    dict(step=step, time=step * 1e-3, dt=1e-3),
                    _snapshot_arrays(device.mesh, rng), None)
                time.sleep(0.1)
        finally:
            handler.close()

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    t0 = time.time()
    fig = monitor_solution(handler.tmp_path, update_interval=0.05)
    thread.join(timeout=60)
    assert not thread.is_alive() and time.time() - t0 < 90
    assert not os.path.exists(handler.tmp_path)
    assert len(set(drawn)) >= 2, drawn
    text = fig._suptitle.get_text()
    assert text.startswith(f"Step {drawn[-1]},"), text
    values = fig.axes[0].collections[0].get_array()
    assert len(values) == len(device.mesh.sites)
    assert np.isfinite(values).all() and values.max() > 0
    plt.close(fig)


def test_solver_monitor_option(tmp_path, monkeypatch):
    """``monitor=True`` starts ``python -m tdgl_tpu_torch.visualize --input
    <output> monitor`` after the step-0 snapshot, and raises ImportError
    before any step where matplotlib is missing."""
    device = _small_device()
    options = ttdgl.SolverOptions(solve_time=0.01, dt_init=1e-3,
                                  adaptive=False, save_every=5,
                                  monitor=True, monitor_update_interval=0.5,
                                  output_file=str(tmp_path / "m.h5"))
    started = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            started.append((cmd, kwargs,
                            os.path.exists(cmd[4] + ".tmp")))

    monkeypatch.setattr(runner_module.subprocess, "Popen", FakePopen)
    solution = ttdgl.solve(device, options, torch_device="cpu")
    (cmd, kwargs, side_file_there), = started
    assert cmd[1:] == ["-m", "tdgl_tpu_torch.visualize", "--input",
                       solution.path, "monitor", "--interval", "0.5"]
    assert side_file_there and kwargs["start_new_session"]

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ttdgl.solve(device, options, torch_device="cpu")
    assert len(started) == 1
    assert not os.path.exists(str(tmp_path / "m-1.h5"))
