"""The induced-potential update (Anderson and Polyak) per member.

The fixtures are in ``tests/test_torch_screened_sweep.py``.
"""

import dataclasses

import pytest

from tdgl_tpu_torch.solver import step as tstep

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_screened_sweep import (LAYOUTS, _fields, box_solver,
                                       one_blas_thread, one_hierarchy_per_mesh)


@pytest.mark.parametrize("solver", ["anderson", "polyak"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_induced_potential_update_is_per_member(box_solver, layout,
                                                solver):
    """(d) The fixed point's update of a batch (Anderson's secant
    coefficient from per-member sums; Polyak's heavy ball) equals each
    member's own, at the first and a later iteration."""
    c = dataclasses.replace(box_solver.cfg, screening_anderson=(
        solver == "anderson"))
    nd = len(LAYOUTS[layout]) + 1
    A, A_new, velocity, x_prev = _fields(layout, 2)
    for s in (0, 3):
        got = tstep.induced_potential_update(c, s, A, A_new, velocity,
                                             x_prev, nd)
        for m in range(3):
            one = tstep.induced_potential_update(c, s, A[m], A_new[m],
                                                 velocity[m], x_prev[m], nd)
            for g, r in zip(got, one):
                scale = max(float(r.abs().max()), 1e-300)
                assert float((g[m] - r).abs().max()) <= 1e-14 * scale
