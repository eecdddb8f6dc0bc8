"""A batched chunk equals single chunks (the grid, the grid with a traced
applied potential, ELL).

The helpers are in ``tests/test_torch_sweep.py``.
"""

import pytest
import torch

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.parallel import sweep as tsweep

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_sweep import (SCALES, _box, _bridge, _options, one_blas_thread,
                              one_hierarchy_per_mesh, terminal_currents)


@pytest.mark.parametrize("backend", ["grid", "grid traced A", "ell"])
def test_batched_chunk_equals_single_chunks(backend):
    """(b) One 20-step chunk of a 3-member batch against 3 single robust
    chunks, each started from its member's input: the scaled applied
    potential (grid), the scaled boundary currents (ELL), or, with a
    traced ramp of the applied potential, its own start time (each member
    evaluates A(t) at its own time). (The batch sums its dot products per
    member and does one matmul for all members' coarse solves where a
    single run does a matvec: rounding-order differences that grow, on the
    grid at the largest dt, to ~3e-12 by step 37.)"""
    if backend == "grid":
        solver = ttdgl.TDGLSolver(
            _box(ttdgl), _options(ttdgl, save_every=20),
            applied_vector_potential=100.0, torch_device="cpu")
        field = "A_applied"
    elif backend == "grid traced A":
        ramp = (ttdgl.ConstantField(300.0, field_units="uT")
                * ttdgl.LinearRamp(tmin=0, tmax=0.05))
        solver = ttdgl.TDGLSolver(
            _box(ttdgl), _options(ttdgl, save_every=20),
            applied_vector_potential=ramp, torch_device="cpu")
        assert solver.cfg.A_fn is not None
        field = "time"
    else:
        solver = ttdgl.TDGLSolver(
            _bridge(ttdgl), _options(ttdgl, dt_max=1e-2, save_every=20),
            terminal_currents=terminal_currents(0.0), torch_device="cpu")
        field = "mu_boundary"
    base = solver._initial_state()
    s = torch.tensor(SCALES, dtype=torch.float64)
    if field == "time":
        # Each member at its own time, with its own A(t) in the state.
        t0 = 0.01 * (s - s[0])
        start = {"time": t0, "A_applied": torch.stack(
            [solver.cfg.A_fn(t) for t in t0])}
    else:
        start = {field: getattr(base, field)[None] * s.reshape(
            (3,) + (1,) * getattr(base, field).dim())}
    per_member = ("psi_r", "psi_i", "psi", "mu", "mu_prev", "supercurrent",
                  "normal_current", "dpsi_window")
    batch = tsweep._member_axis(base, 3, per_member, start)
    if solver.structured:
        def chunk(st):
            return solver._raw_chunk_fn(solver.sten, solver.amg, st, None)
    else:
        def chunk(st):
            return solver._raw_chunk_fn(solver.op, None, solver.amg, st)
    b_state, b_out, _ = chunk(batch)
    for m in range(3):
        state, out, _ = chunk(base._replace(
            **{k: v[m] for k, v in start.items()}))
        for name in state._fields:
            ref = getattr(state, name)
            got = getattr(b_state, name)
            got = got[m] if got.dim() > ref.dim() else got
            if not ref.is_floating_point():
                assert torch.equal(got, ref), (m, name)
                continue
            # The window holds differences of |psi|^2 (<= 1): absolute.
            scale = (1.0 if name == "dpsi_window"
                     else max(float(ref.abs().max()), 1e-300))
            assert float((got - ref).abs().max()) <= 1e-12 * scale, (
                m, name)
        # Probe potentials on the scale of mu, phases absolutely.
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
