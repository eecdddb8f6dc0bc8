"""Batched screened chunks against single chunks (ELL, the exact FFT, the
site-evaluated FFT and the pairwise sum), and the ELL edge average per
member.

The helpers are in ``tests/test_torch_screened_sweep.py``.
"""

import numpy as np
import pytest
import torch

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.models import gtdgl
from tdgl_tpu_torch.parallel import sweep as tsweep

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_screened_sweep import (SCALES, _box, _bridge, _options,
                                       one_blas_thread, one_hierarchy_per_mesh)


def _sweep_chunk(solver, state):
    if solver.structured:
        return solver._raw_chunk_fn(solver.sten, solver.amg, state,
                                    solver._screening)
    return solver._raw_chunk_fn(solver.op, solver._screening, solver.amg,
                                state)


@pytest.mark.parametrize("case", ["ell", "fft", "fft site", "xla"])
def test_screened_batched_chunk_equals_single_chunks(case):
    """(b) One 12-step screened chunk of a 3-member field batch against 3
    single robust chunks, each started from its member's scaled applied
    potential (150, 300 and 600 uT), whose fixed points take different
    iteration counts. The chunk ends before the dt jump at step 12 (index
    12), whose fixed-point burst (~100 iterations) grows the batch's
    rounding-order differences (the multigrid's and AMG's coarse solve is
    one matmul for the batch and a matvec alone) past 1e-12 by step 20 on
    ELL, with equal iteration counts throughout. The two psi components
    are held on the scale of ``|psi|``. The structured ``"xla"`` case sums
    over every padded-grid site pair, so it runs 1 step."""
    extra = {"fft site": dict(screening_site_eval=True),
             "xla": dict(screening_kernel="xla")}.get(case, {})
    film = _bridge if case == "ell" else _box
    solver = ttdgl.TDGLSolver(
        film(ttdgl), _options(ttdgl, save_every=1 if case == "xla" else 12,
                              **extra),
        applied_vector_potential=300.0, torch_device="cpu")
    assert solver.structured == (case != "ell")
    assert solver.cfg.screening_use_fft == case.startswith("fft")
    assert solver.cfg.screening_site_eval == (case == "fft site")
    base = solver._initial_state()
    s = torch.tensor(SCALES, dtype=torch.float64)
    A = base.A_applied[None] * s.reshape((3,) + (1,) * base.A_applied.dim())
    per_member = ("psi_r", "psi_i", "psi", "mu", "mu_prev", "supercurrent",
                  "normal_current", "A_induced", "dpsi_window")
    batch = tsweep._member_axis(base, 3, per_member, {"A_applied": A})
    b_state, b_out, _ = _sweep_chunk(solver, batch)
    its = b_out.screening_iterations
    assert bool((its != its[:1]).any()), its
    for m in range(3):
        state, out, _ = _sweep_chunk(solver, base._replace(A_applied=A[m]))
        psi = (torch.sqrt(state.psi_r**2 + state.psi_i**2) if
               solver.structured else state.psi)
        for name in state._fields:
            ref = getattr(state, name)
            got = getattr(b_state, name)
            got = got[m] if got.dim() > ref.dim() else got
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (m, name)
                continue
            scale = (1.0 if name == "dpsi_window"
                     else float(psi.abs().max()) if name.startswith("psi")
                     else max(float(ref.abs().max()), 1e-300))
            assert float((got - ref).abs().max()) <= 1e-12 * scale, (
                m, name)
        scales = dict(mu_probe=float(state.mu.abs().max()),
                      theta_probe=1.0)
        for name in out._fields:
            ref = getattr(out, name)
            got = getattr(b_out, name)[m]
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (m, name)
                continue
            scale = scales.get(name, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= 1e-12 * scale, (
                m, name)


def test_ell_edge_average_is_per_member():
    """(d) ``gtdgl.edge_quantity_to_sites`` of a ``(B, E)`` batch equals
    each member's ``(E,)`` average, bit for bit."""
    solver = ttdgl.TDGLSolver(_bridge(ttdgl), _options(
        ttdgl, include_screening=False), torch_device="cpu")
    op = solver.op
    n = op.areas.shape[0]
    F = torch.tensor(np.random.default_rng(4).normal(
        size=(3, op.edges.shape[0])))
    got = gtdgl.edge_quantity_to_sites(op, F, n)
    assert got.shape == (3, n, 2)
    for m in range(3):
        assert torch.equal(got[m], gtdgl.edge_quantity_to_sites(op, F[m], n))
