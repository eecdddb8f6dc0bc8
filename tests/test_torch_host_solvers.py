"""The host set-up of both packages' solvers, continued: the multigrid
hierarchy, the applied potential and scales, and the initial state.

The fixtures are in ``tests/test_torch_host.py``.
"""

import numpy as np

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_host import one_blas_thread, one_hierarchy_per_mesh, solvers


def test_hexmg_equal(solvers):
    js, ts = solvers
    jm, tm = js.amg, ts.host_amg
    assert jm.offsets == tm.offsets
    assert jm.shapes == tm.shapes
    assert jm.p_omega == tm.p_omega
    assert len(jm.level_arrays) == len(tm.level_arrays)
    for jl, tl in zip(jm.level_arrays, tm.level_arrays):
        assert set(tl) == set(jl) - {"PR", "PC"}
        for key in tl:
            assert np.array_equal(np.asarray(jl[key]), tl[key]), key


def test_applied_potential_and_scales_equal(solvers):
    js, ts = solvers
    assert js.cfg.factor_link_phases and ts.cfg.factor_link_phases
    assert np.array_equal(js._full_A_grid, ts._full_A_grid)
    assert np.array_equal(js.current_A_applied, ts.current_A_applied)
    assert js.A_scale == ts.A_scale
    assert js.J_scale == ts.J_scale
    assert js.cfg.probe_ix == ts.cfg.probe_ix


def test_initial_state_equal(solvers):
    js, ts = solvers
    jstate = js._initial_state()
    tstate = ts._initial_state()
    for name in ("psi_r", "psi_i", "mu", "A_applied", "epsilon",
                 "neumann_term", "dA_dt", "tentative_dt", "end_time"):
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
