"""``solve()`` on the ELL backend against the JAX package's: the output
file, the checkpoint group, and resume and seed from the JAX package's
file.

The fixtures are in ``tests/test_torch_ell.py``.
"""

import h5py
import numpy as np
import pytest

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_ell import CURRENTS, _rel, devices, one_blas_thread


@pytest.fixture(scope="module")
def solved(devices, tmp_path_factory):
    """Both packages' ``solve()`` (float64, fixed dt, 61 steps, a
    snapshot every 20)."""
    out = {}
    for name, pkg, kw in (("jax", jtdgl, {}),
                          ("torch", ttdgl, {"torch_device": "cpu"})):
        path = str(tmp_path_factory.mktemp(f"ell_{name}") / "out.h5")
        out[name] = pkg.solve(
            devices[name],
            pkg.SolverOptions(solve_time=0.06, dt_init=1e-3, adaptive=False,
                              save_every=20, dtype="float64",
                              output_file=path, field_units="mT",
                              current_units="uA"),
            applied_vector_potential=0.5, terminal_currents=CURRENTS, **kw)
    return out


def test_solve_matches_jax(solved):
    j, t = solved["jax"], solved["torch"]
    assert t.data_range == j.data_range == (0, 4)
    assert len(t.dynamics.dt) == len(j.dynamics.dt) == 61
    for step in range(j.data_range[0], j.data_range[1] + 1):
        j.solve_step = t.solve_step = step
        assert t.tdgl_data.state["step"] == j.tdgl_data.state["step"]
        for name in ("psi", "mu", "supercurrent", "normal_current"):
            assert _rel(getattr(t.tdgl_data, name),
                        getattr(j.tdgl_data, name)) < 1e-10, (step, name)
    for name in ("dt", "mu", "theta"):
        assert _rel(getattr(t.dynamics, name),
                    getattr(j.dynamics, name)) < 1e-10, name
    j.solve_step = t.solve_step = -1
    # The port's file loads in the JAX package and in the port.
    loaded = jtdgl.Solution.from_hdf5(t.path)
    assert _rel(loaded.tdgl_data.psi, j.tdgl_data.psi) < 1e-10
    assert ttdgl.Solution.from_hdf5(t.path).equals(t)


def test_checkpoint_group_matches_jax(solved):
    """The ``checkpoint`` group has the JAX file's datasets (same shapes
    and dtypes) and attributes, ``backend`` ``"ell"``: the resume slice
    reads both backends from it."""
    groups = {}
    for name in ("jax", "torch"):
        with h5py.File(solved[name].path, "r") as f:
            grp = f["checkpoint"]
            groups[name] = (
                {k: (grp[k].shape, grp[k].dtype) for k in grp},
                {k: grp.attrs[k] for k in grp.attrs},
                {k: np.asarray(grp[k]) for k in grp})
    (jd, ja, jv), (td, ta, tv) = groups["jax"], groups["torch"]
    assert td == jd
    assert sorted(ta) == sorted(ja)
    assert ta["backend"] == ja["backend"] == "ell"
    assert ta["mesh_fingerprint"] == ja["mesh_fingerprint"]
    assert ta["step"] == ja["step"]
    for k in ("time", "prev_dt", "tentative_dt"):
        assert abs(ta[k] - ja[k]) <= 1e-12 * abs(ja[k]), k
    for k in ("psi", "mu", "mu_boundary", "A_applied"):
        assert _rel(tv[k], jv[k]) < 1e-10, k


def test_resume_and_seed_from_jax_file(solved, tmp_path):
    """Both packages' files of ``solved`` resumed by the port 20 fixed
    steps on agree to 1e-10 with equal steps; the JAX file loads in the
    port with the JAX package's fields and seeds a port run."""
    device = solved["torch"].device
    kw = dict(applied_vector_potential=0.5, terminal_currents=CURRENTS,
              torch_device="cpu")

    def options(solve_time, name):
        return ttdgl.SolverOptions(
            solve_time=solve_time, dt_init=1e-3, adaptive=False,
            save_every=20, dtype="float64",
            output_file=str(tmp_path / name), field_units="mT",
            current_units="uA")

    out = {name: ttdgl.solve(device, options(0.08, f"{name}.h5"),
                             resume_from=solved[name].path, **kw)
           for name in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    assert j.tdgl_data.state["step"] == t.tdgl_data.state["step"] == 81
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        assert _rel(getattr(j.tdgl_data, name),
                    getattr(t.tdgl_data, name)) < 1e-10, name
    ours = ttdgl.Solution.from_hdf5(solved["jax"].path)
    theirs = jtdgl.Solution.from_hdf5(solved["jax"].path)
    for name in ("psi", "mu", "supercurrent", "normal_current",
                 "induced_vector_potential", "applied_vector_potential",
                 "epsilon"):
        assert np.array_equal(getattr(ours.tdgl_data, name),
                              getattr(theirs.tdgl_data, name)), name
    assert ours.tdgl_data.state["time"] == theirs.tdgl_data.state["time"]
    seeded = ttdgl.solve(device, options(0.002, "seeded.h5"),
                         seed_solution=ours, **kw)
    seeded.solve_step = 0
    assert np.array_equal(seeded.tdgl_data.psi, theirs.tdgl_data.psi)
