"""Per-member screening reductions: the fixed point's error (global and
per-edge norms) and the batched induced potential against single
members.

The fixtures are in ``tests/test_torch_screened_sweep.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tdgl_tpu_torch.ops import fft_screening as fs
from tdgl_tpu_torch.ops.screening import induced_vector_potential
from tdgl_tpu_torch.solver import step as tstep

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_screened_sweep import (LAYOUTS, _fields, box_solver,
                                       one_blas_thread, one_hierarchy_per_mesh)


@pytest.mark.parametrize("norm", ["global", "per_edge"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_screening_error_is_per_member(box_solver, layout, norm):
    """(d) ``screening_error`` (with each member's applied-potential scale)
    of a batch equals each member's own."""
    c = dataclasses.replace(box_solver.cfg, screening_global_error_norm=(
        norm == "global"))
    nd = len(LAYOUTS[layout]) + 1
    dA, A, A_app, _ = _fields(layout, 1)
    app = tstep.vector_scale(A_app, nd)
    assert app.shape == (3,)
    err = tstep.screening_error(c, dA, A, app, nd)
    assert err.shape == (3,)
    for m in range(3):
        one = tstep.screening_error(c, dA[m], A[m], tstep.vector_scale(
            A_app[m], nd), nd)
        assert one.dim() == 0
        assert float(abs(err[m] - one)) <= 1e-15 * float(one)


@pytest.mark.parametrize("kernel", ["pairwise", "fft", "fft site"])
def test_batched_induced_potential_equals_members(box_solver, kernel):
    """(d) One batched evaluation of the induced potential (three members
    of weighted site currents, zero at masked sites) equals each member's
    single evaluation."""
    sten = box_solver.sten
    weights, fft_data = box_solver._screening
    rng = np.random.default_rng(3)
    valid = sten.valid.to(torch.float64)[..., None]
    Jw = torch.tensor(rng.normal(size=(3,) + tuple(valid.shape[:2]) + (2,)),
                      dtype=torch.float64) * valid * weights[..., None]
    if kernel == "pairwise":
        ec = torch.stack([sten.ec_x, sten.ec_y], dim=-1).reshape(-1, 2)
        xy = torch.stack([sten.site_x, sten.site_y], dim=-1).reshape(-1, 2)

        def evaluate(J):
            return induced_vector_potential(ec, xy, J.reshape(
                J.shape[:-3] + (-1, 2)), block_size=100)
    elif kernel == "fft":
        def evaluate(J):
            return fs.induced_vector_potential_fft(fft_data, sten, J)
    else:
        def evaluate(J):
            return fs.induced_vector_potential_fft_site(
                fft_data, sten, J, box_solver._site_taps)
    got = evaluate(Jw)
    for m in range(3):
        ref = evaluate(Jw[m])
        assert got.shape == (3,) + ref.shape
        assert float((got[m] - ref).abs().max()) <= 1e-13 * float(
            ref.abs().max())
