"""The port's CLI from the repo root: ``--help``, ``snapshot``, ``convert``
and ``animate`` as ``python -m tdgl_tpu_torch.visualize`` runs them, one
after another in one subprocess, on the port's output file.

The solve fixture is in ``tests/test_torch_visualize.py``.
"""

import json
import os
import subprocess
import sys
import textwrap

import h5py
import pytest

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_visualize import one_blas_thread, solved


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the CLI, each command run as ``python -m`` runs it, in one subprocess --
CLI = {
    "help": ["--help"],
    "snapshot": ["snapshot", "--times", "0.05", "0.1"],
    "convert": ["--output", "{tmp}/cli.xdmf", "convert"],
    "animate": ["--output", "{tmp}/cli.gif", "animate", "--fps", "10",
                "--max-frame", "3"],
}


# Runs ``python -m tdgl_tpu_torch.visualize <args>`` for each command in
# turn (``runpy``, as ``-m`` does), capturing its exit code, stdout and
# stderr; prints them as JSON.
_CLI_RUNNER = textwrap.dedent("""
    import contextlib
    import io
    import json
    import runpy
    import sys
    import traceback

    results = {}
    for name, argv in json.loads(sys.argv[1]).items():
        out, err = io.StringIO(), io.StringIO()
        sys.argv = ["tdgl_tpu_torch.visualize"] + argv
        code = 0
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                runpy.run_module("tdgl_tpu_torch.visualize",
                                 run_name="__main__", alter_sys=True)
            except SystemExit as exc:
                code = (exc.code if isinstance(exc.code, int)
                        else int(exc.code is not None))
            except BaseException:
                traceback.print_exc()
                code = 1
        results[name] = (code, out.getvalue(), err.getvalue())
    print(json.dumps(results))
""")


@pytest.fixture(scope="module")
def cli_runs(solved, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    path, _ = solved["torch"]
    env = dict(os.environ, MPLBACKEND="Agg", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    commands = {name: ([] if name == "help" else ["--input", path])
                + [a.format(tmp=tmp) for a in args]
                for name, args in CLI.items()}
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_RUNNER, json.dumps(commands)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {name: tuple(v) for name, v in
           json.loads(proc.stdout.strip().splitlines()[-1]).items()}
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
