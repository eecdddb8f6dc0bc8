"""The callable-bias current sweep on the ELL backend against the JAX
package's (the current pair's cases of ``test_sweep_matches_jax`` and
``test_member_files_match_jax``), its member Solutions with the serial
rename, a failing member, and a plain-callable field's member Solution.

The helpers are in ``tests/test_torch_sweep.py``.
"""

import numpy as np
import pytest

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.parallel import sweep as tsweep

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_sweep import (_box, _bridge, _options, _run,
                              member_files_match_jax, one_blas_thread,
                              one_hierarchy_per_mesh, sweep_matches_jax)


@pytest.fixture(scope="module")
def current_pair(tmp_path_factory):
    """(a) The ELL callable-bias current sweep in both packages."""
    return {name: _run(pkg, _bridge(pkg), "current",
                       tmp_path_factory.mktemp(f"current_{name}"))
            for name, pkg in (("jax", jtdgl), ("torch", ttdgl))}


def test_current_sweep_callable_bias(current_pair):
    """(c) The callable IV-like bias: the probe voltage scales with the
    member's bias."""
    result = current_pair["torch"][0]
    assert result.psi.shape[0] == 3
    assert not np.any(result.failed)
    assert np.all(result.times >= 1.0)
    v = np.abs(result.dynamics_mu[:, 0, :] - result.dynamics_mu[:, 1, :])
    final_v = np.array([
        row[np.flatnonzero(dt > 0)[-1]]
        for row, dt in zip(v, result.dynamics_dt)
    ])
    assert final_v[-1] > 2.0 * final_v[0] > 0


def test_sweep_failed_member_surfaced():
    """(c) A member that cannot converge (fixed dt far too large) is
    reported: raise_on_failure=True raises; False returns per-member
    flags."""
    device = _box(ttdgl)
    options = ttdgl.SolverOptions(
        solve_time=5, dt_init=0.5, dt_max=0.5, adaptive=False,
        save_every=10, field_units="uT", current_units="uA",
    )
    kwargs = dict(
        applied_vector_potential=ttdgl.ConstantField(1.0, field_units="uT"),
        field_scales=np.linspace(100, 400, 4), max_steps=20,
        torch_device="cpu",
    )
    with pytest.raises(RuntimeError, match="failed to converge"):
        tsweep.solve_sweep(device, options, **kwargs)
    result = tsweep.solve_sweep(device, options, raise_on_failure=False,
                                **kwargs)
    assert np.any(result.failed)


def plain_field(x, y, z):
    """A uniform field's vector potential as a plain (non-Parameter)
    callable of the edge centres."""
    return np.stack([-0.5 * y, 0.5 * x, np.zeros_like(x)], axis=1)


def test_member_solution_of_plain_callable_field(tmp_path):
    """(c) A field sweep of a plain callable: each member's Solution stores
    the callable times its scale (``ScaledApplied``) and reloads it."""
    result = tsweep.solve_sweep(
        _box(ttdgl), _options(ttdgl, solve_time=0.002, dt_init=1e-3,
                              save_every=2),
        applied_vector_potential=plain_field, field_scales=[0.5, 2.0],
        output_dir=str(tmp_path), torch_device="cpu")
    xyz = np.array([[1.0, 2.0, 0.0], [-3.0, 0.5, 0.0]]).T
    for scale, sol in zip((0.5, 2.0), result.solutions):
        reloaded = ttdgl.Solution.from_hdf5(sol.path)
        for applied in (sol.applied_vector_potential,
                        reloaded.applied_vector_potential):
            assert isinstance(applied, tsweep.ScaledApplied)
            np.testing.assert_allclose(applied(*xyz),
                                       scale * plain_field(*xyz))


def test_sweep_member_solutions_ell_and_rename(current_pair, tmp_path):
    """(c) Member Solutions of the ELL current sweep (the scaled callable
    bias is stored), and a second sweep into the same directory is
    serial-renamed, not lost."""
    result = current_pair["torch"][0]
    for b, sol in enumerate(result.solutions):
        np.testing.assert_allclose(sol.tdgl_data.psi, result.psi[b])
        assert len(sol.dynamics.time) == result.steps[b]
        tc = sol.terminal_currents(0.0)
        assert tc["source"] == pytest.approx(1.0 * result.values[b])
        assert np.isfinite(sol.magnetic_moment(with_units=False))
    device = result.solutions[0].device
    kwargs = dict(terminal_currents=dict(source=1.0, drain=-1.0),
                  current_scales=[1.0, 2.0], max_steps=40,
                  output_dir=str(tmp_path), torch_device="cpu")
    options = _options(ttdgl, solve_time=0.01, dt_max=1e-2)
    first = tsweep.solve_sweep(device, options, **kwargs)
    again = tsweep.solve_sweep(device, options, **kwargs)
    assert len(again.solutions) == 2
    assert again.solutions[0].path != first.solutions[0].path
    assert again.solutions[0].path.endswith("member_000-1.h5")


@pytest.mark.parametrize("pair", ["current_pair"])
def test_sweep_matches_jax(pair, request):
    sweep_matches_jax(request.getfixturevalue(pair))


@pytest.mark.parametrize("pair", ["current_pair"])
def test_member_files_match_jax(pair, request):
    member_files_match_jax(request.getfixturevalue(pair))
