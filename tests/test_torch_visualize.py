"""The port's visualization, plots, XDMF export and ``visualize`` CLI
against the JAX package's.

One float64 ``solve()`` in each package on the same ~300-site structured
transport film (module fixture). Each output file, the port's and then
the JAX package's, is fed to both packages (the port reads through
h5lite, the JAX package through h5py), and:

* ``get_plot_data`` for every ``Quantity`` at every frame and
  ``get_state_string`` agree to 1e-12;
* every ``plot_*`` function, the ``Solution.plot_*`` aliases and
  ``DynamicsData.plot``/``plot_dt`` draw the same artists under
  ``non_gui_backend``: collection arrays, colour limits and line data to
  1e-12, titles and labels equal;
* ``generate_snapshots``, ``create_animation`` and the key events of both
  interactive plots (mirrors of ``tests/test_visualize.py:122,176``) agree;
* ``convert_to_xdmf`` writes the same XML up to file names and, read
  with h5py, the same heavy datasets to 1e-12;
* the port's CLI runs in subprocesses from the repo root: ``--help``,
  ``snapshot``, ``convert`` and ``animate``.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import tdgl_tpu as jtdgl
import tdgl_tpu.visualization as jvis
import tdgl_tpu_torch as ttdgl
import tdgl_tpu_torch.visualization as tvis
from tdgl_tpu_torch.utils import h5lite

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
WRITERS = ("torch", "jax")


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1):
        yield


def _device(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(10, 6)).resample(120)
    hole = pkg.Polygon("hole", points=pkg.circle(1.0, center=(1, 0.5)))
    source = pkg.Polygon("source", points=pkg.box(1, 4, center=(-5, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, 4, center=(5, 0)))
    device = pkg.Device("vis", layer=layer, film=film, holes=[hole],
                        terminals=[source, drain],
                        probe_points=[(-3, 0), (3, 0)], length_units="um")
    device.make_mesh(min_points=300, structured=True)
    return device


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """``{writer: (path, {reader: Solution})}``: each package's output
    file, loaded by both packages."""
    paths = {}
    for name, pkg, kw in (("torch", ttdgl, {"torch_device": "cpu"}),
                          ("jax", jtdgl, {})):
        path = str(tmp_path_factory.mktemp(f"vis_{name}") / "out.h5")
        solution = pkg.solve(
            _device(pkg),
            pkg.SolverOptions(solve_time=0.1, dt_init=1e-3, adaptive=False,
                              save_every=25, dtype="float64",
                              output_file=path, field_units="mT",
                              current_units="uA"),
            applied_vector_potential=0.5,
            terminal_currents=dict(source=5.0, drain=-5.0), **kw)
        paths[name] = solution.path
    return {writer: (path, {"torch": ttdgl.Solution.from_hdf5(path),
                            "jax": jtdgl.Solution.from_hdf5(path)})
            for writer, path in paths.items()}


def _close(a, b, what):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    ok = ~np.isnan(a)
    scale = max(np.abs(b[ok]).max(initial=0.0), 1.0)
    assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= TOL * scale, what


def _artists(fig):
    """Per axes: title, labels, (array, clim) of every collection with an
    array, and the data of every line."""
    out = []
    for ax in fig.axes:
        colls = [(np.ma.filled(np.ma.asarray(c.get_array(), float), np.nan),
                  c.get_clim())
                 for c in ax.collections if c.get_array() is not None]
        lines = [np.asarray(line.get_xydata(), float)
                 for line in ax.get_lines()]
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    colls, lines))
    suptitle = fig._suptitle.get_text() if fig._suptitle else None
    return suptitle, out


def _same_figures(ours, theirs, what):
    import matplotlib.pyplot as plt

    (sup_a, a), (sup_b, b) = _artists(ours), _artists(theirs)
    plt.close(ours)
    plt.close(theirs)
    assert sup_a == sup_b, what
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x[:3] == y[:3], (what, i)
        assert len(x[3]) == len(y[3]) and len(x[4]) == len(y[4]), (what, i)
        for (arr_a, clim_a), (arr_b, clim_b) in zip(x[3], y[3]):
            _close(arr_a, arr_b, (what, i, "array"))
            _close(clim_a, clim_b, (what, i, "clim"))
        for line_a, line_b in zip(x[4], y[4]):
            _close(line_a, line_b, (what, i, "line"))


@pytest.mark.parametrize("writer", WRITERS)
def test_plot_data_and_state_string(solved, writer):
    path, sols = solved[writer]
    mesh_t, mesh_j = sols["torch"].device.mesh, sols["jax"].device.mesh
    lo, hi = sols["torch"].data_range
    with h5lite.File(path, "r") as ft, h5py.File(path, "r") as fj:
        for frame in range(lo, hi + 1):
            for qt, qj in zip(tvis.Quantity, jvis.Quantity):
                assert qt.name == qj.name
                ours = tvis.get_plot_data(ft, mesh_t, qt, frame)
                theirs = jvis.get_plot_data(fj, mesh_j, qj, frame)
                for a, b in zip(ours, theirs):
                    _close(a, b, (qt.name, frame))
            assert (tvis.get_state_string(ft, frame, hi)
                    == jvis.get_state_string(fj, frame, hi))
        # A path is opened for the call.
        _close(tvis.get_plot_data(path, mesh_t, tvis.Quantity.PHASE, hi)[0],
               jvis.get_plot_data(fj, mesh_j, jvis.Quantity.PHASE, hi)[0],
               "path")


PLOTS = [
    ("plot_currents", lambda pkg, s: pkg.plot_currents(s)),
    ("plot_currents streamless", lambda pkg, s: pkg.plot_currents(
        s, streamplot=False, auto_range_cutoff=1, dataset="supercurrent")),
    ("plot_order_parameter", lambda pkg, s: pkg.plot_order_parameter(
        s, squared=True)),
    ("plot_vorticity", lambda pkg, s: pkg.plot_vorticity(s)),
    ("plot_scalar_potential", lambda pkg, s: pkg.plot_scalar_potential(s)),
    ("plot_field_at_positions", lambda pkg, s: pkg.plot_field_at_positions(
        s, np.stack(np.meshgrid(np.linspace(-6, 6, 9),
                                np.linspace(-4, 4, 7)), -1).reshape(-1, 2),
        zs=0.5, grid_shape=20)),
    ("Solution.plot_currents", lambda pkg, s: s.plot_currents()),
    ("Solution.plot_order_parameter",
     lambda pkg, s: s.plot_order_parameter()),
    ("Solution.plot_vorticity", lambda pkg, s: s.plot_vorticity()),
    ("Solution.plot_scalar_potential",
     lambda pkg, s: s.plot_scalar_potential()),
    ("Solution.plot_field_at_positions",
     lambda pkg, s: s.plot_field_at_positions(
         np.array([[x, y] for x in (-4, 0, 4) for y in (-2, 0, 2)]),
         zs=1.0, grid_shape=10, symmetric_color_scale=True)),
    ("DynamicsData.plot", lambda pkg, s: s.dynamics.plot(legend=True)),
    ("DynamicsData.plot_dt", lambda pkg, s: s.dynamics.plot_dt(bins=11)),
]


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name,draw", PLOTS, ids=[p[0] for p in PLOTS])
def test_plot_functions(solved, writer, name, draw):
    _, sols = solved[writer]
    with ttdgl.non_gui_backend(), jtdgl.non_gui_backend():
        ours = draw(ttdgl, sols["torch"])[0]
        theirs = draw(jtdgl, sols["jax"])[0]
        _same_figures(ours, theirs, name)


@pytest.mark.parametrize("writer", WRITERS)
def test_current_through_paths(solved, writer):
    """The time series agree. Drawing it raises ValueError in both
    packages on this file: ``Solution.times`` drops a snapshot when the
    run's step count is 1 mod ``save_every`` (here 101 steps, 6 snapshots,
    5 times; ROADMAP Queue 3), and the port keeps the reference's
    behaviour."""
    path, _ = solved[writer]
    ys = np.linspace(-3, 3, 61)
    line = np.stack([np.zeros_like(ys), ys], axis=1)
    ours = ttdgl.get_current_through_paths(path, [line, line + 2],
                                           with_units=False,
                                           progress_bar=False)
    theirs = jtdgl.get_current_through_paths(path, [line, line + 2],
                                             with_units=False,
                                             progress_bar=False)
    _close(ours[0], theirs[0], "times")
    for a, b in zip(ours[1], theirs[1]):
        _close(a, b, "currents")
    assert len(ours[0]) == 5 and len(ours[1][0]) == 6
    errors = []
    for pkg in (ttdgl, jtdgl):
        with pkg.non_gui_backend(), pytest.raises(ValueError) as info:
            pkg.plot_current_through_paths(path, line, progress_bar=False)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("writer", WRITERS)
def test_generate_snapshots(solved, writer):
    path, _ = solved[writer]
    kw = dict(times=[0.0, 0.05, 1.0], quantities=["order_parameter",
                                                   "supercurrent", "vorticity"],
              axis_labels=True)
    with tvis.non_gui_backend():
        ours = tvis.generate_snapshots(path, **kw)
        theirs = jvis.generate_snapshots(path, **kw)
        assert len(ours) == len(theirs) == 3
        for i, ((fa, _), (fb, _)) in enumerate(zip(ours, theirs)):
            _same_figures(fa, fb, ("snapshot", i))


@pytest.mark.parametrize("writer", WRITERS)
def test_create_animation(solved, writer, tmp_path):
    path, _ = solved[writer]
    figs = []
    for vis, tag in ((tvis, "t"), (jvis, "j")):
        out = str(tmp_path / f"{tag}.gif")
        anim = vis.create_animation(
            path, output_file=out, quantities=["order_parameter", "phase"],
            fps=10, min_frame=1, max_frame=3, full_title=False, silent=True)
        assert os.path.getsize(out) > 0
        figs.append(anim._fig)
    _same_figures(*figs, "animation's last frame")


def _press_all(plot, f, keys):
    """Build ``plot`` on ``f``, press ``keys`` and record the frame, the
    quantity and every collection's array after each."""
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import KeyEvent

    fig = plot._build(f)
    colls = getattr(plot, "_collections", None) or [plot._pc]
    out = []
    for key in keys:
        plot._on_key(KeyEvent("key_press_event", fig.canvas, key))
        out.append((plot._frames.current,
                    getattr(plot, "quantity", None),
                    [np.array(c.get_array()) for c in colls]))
    plt.close(fig)
    return out


KEYS = {
    "InteractivePlot": ["right", "left", "left", "end", "up", "home",
                        "shift+right", "shift+left", "up", "down", "shift+up",
                        "shift+down", "3", "right", "9", "5", "1"],
    "MultiInteractivePlot": ["right", "left", "left", "end", "up", "home",
                             "shift+right"],
}


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("kind", ["InteractivePlot", "MultiInteractivePlot"])
def test_interactive_key_events(solved, writer, kind):
    """The key sequence of ``tests/test_visualize.py:122,176`` (frame jumps
    clipped to the file's range, number keys selecting the quantity)
    moves both packages' plots through the same frames and arrays."""
    path, _ = solved[writer]
    with tvis.non_gui_backend():
        with h5lite.File(path, "r") as f:
            ours = _press_all(getattr(tvis, kind)(path), f, KEYS[kind])
        with h5py.File(path, "r") as f:
            theirs = _press_all(getattr(jvis, kind)(path), f, KEYS[kind])
    frames = [o[0] for o in ours]
    assert frames == [o[0] for o in theirs]
    assert frames[:6] == [1, 0, 0, 5, 5, 0]
    for (_, qa, aa), (_, qb, ab) in zip(ours, theirs):
        assert (qa and qa.name) == (qb and qb.name)
        for a, b in zip(aa, ab):
            _close(a, b, kind)
    if kind == "InteractivePlot":
        assert [o[1].name for o in ours[-5:]] == [
            "SUPERCURRENT", "SUPERCURRENT", "VORTICITY", "SCALAR_POTENTIAL",
            "ORDER_PARAMETER"]
        assert not np.array_equal(ours[11][2][0], ours[12][2][0])
    else:
        assert not np.array_equal(ours[5][2][0], ours[6][2][0])


@pytest.mark.parametrize("writer", WRITERS)
def test_convert_to_xdmf(solved, writer, tmp_path):
    path, _ = solved[writer]
    ours = tvis.convert_to_xdmf(path, str(tmp_path / "t.xdmf"))
    theirs = jvis.convert_to_xdmf(path, str(tmp_path / "j.xdmf"))
    with open(ours) as a, open(theirs) as b:
        assert a.read().replace("t.xdmf.h5", "j.xdmf.h5") == b.read()
    names = []
    with h5py.File(ours + ".h5", "r") as a, h5py.File(theirs + ".h5",
                                                      "r") as b:
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert sorted(names) == sorted(other)
        for name in names:
            if isinstance(b[name], h5py.Dataset):
                assert a[name].dtype == b[name].dtype, name
                _close(a[name][()], b[name][()], name)
    assert sum(n.startswith("frame_") and "/" not in n for n in names) == 6


# -- the CLI, in subprocesses started together --------------------------------
CLI = {
    "help": ["--help"],
    "snapshot": ["snapshot", "--times", "0.05", "0.1"],
    "convert": ["--output", "{tmp}/cli.xdmf", "convert"],
    "animate": ["--output", "{tmp}/cli.gif", "animate", "--fps", "10",
                "--max-frame", "3"],
}


@pytest.fixture(scope="module")
def cli_runs(solved, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    path, _ = solved["torch"]
    env = dict(os.environ, MPLBACKEND="Agg", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = {}
    for name, args in CLI.items():
        args = [a.format(tmp=tmp) for a in args]
        if name != "help":
            args = ["--input", path] + args
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "tdgl_tpu_torch.visualize"] + args,
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[name] = (proc.returncode, stdout, stderr)
    return tmp, path, out


def test_cli_help(cli_runs):
    rc, stdout, _ = cli_runs[2]["help"]
    assert rc == 0
    for cmd in ("interactive", "animate", "monitor", "convert", "snapshot"):
        assert cmd in stdout


def test_cli_snapshot(cli_runs):
    _, path, out = cli_runs
    assert out["snapshot"][0] == 0, out["snapshot"][2]
    for t in (0.05, 0.1):
        assert os.path.getsize(path.replace(".h5", "") + f"_t{t:.1f}.png")


def test_cli_convert(cli_runs):
    tmp, _, out = cli_runs
    assert out["convert"][0] == 0, out["convert"][2]
    with open(os.path.join(tmp, "cli.xdmf")) as f:
        text = f.read()
    assert "Xdmf" in text and "TimeSeries" in text
    with h5py.File(os.path.join(tmp, "cli.xdmf.h5"), "r") as f:
        assert "frame_5/order_parameter" in f


def test_cli_animate(cli_runs):
    tmp, _, out = cli_runs
    assert out["animate"][0] == 0, out["animate"][2]
    assert os.path.getsize(os.path.join(tmp, "cli.gif"))
