"""ELL chunks against the JAX package's (static, retry, traced ramp, host
path, screened), a float32 chunk, and the solver-state converter.

The fixtures are in ``tests/test_torch_ell.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver
from tdgl_tpu_torch import convert

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_ell import CURRENTS, _rel, devices, one_blas_thread


class HostRamp:
    """Terminal currents as a plain callable (the host path)."""

    def __call__(self, t):
        current = 3.0 * min(float(t) / 0.01, 1.0)
        return {"source": current, "drain": -current}


@ttdgl.jittable
def _torch_ramp(t):
    current = 3.0 * torch.clamp(t / 0.01, 0.0, 1.0)
    return {"source": current, "drain": -current}


@jtdgl.jittable
def _jax_ramp(t):
    current = 3.0 * jnp.clip(t / 0.01, 0.0, 1.0)
    return {"source": current, "drain": -current}


def _case(pkg, case):
    """``(options, inputs)`` of one chunk case for ``pkg``."""
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    inputs = dict(applied_vector_potential=0.5, terminal_currents=CURRENTS)
    if case == "retry":
        # A first step far too large: the discriminant test rejects it
        # and the dt shrinks until it passes.
        opts.update(dt_init=0.5, dt_max=1.0, save_every=10)
    elif case == "traced ramp":
        inputs = dict(
            applied_vector_potential=pkg.ConstantField(0.5)
            * pkg.LinearRamp(tmin=0.0, tmax=0.01),
            terminal_currents=_torch_ramp if pkg is ttdgl else _jax_ramp)
    elif case == "host path":
        opts.update(save_every=1)
        inputs["terminal_currents"] = HostRamp()
    elif case == "screened":
        opts.update(dt_init=1e-4, adaptive=False, save_every=10,
                    include_screening=True, screening_tolerance=1e-4,
                    screening_error_norm="global")
    return opts, inputs


@pytest.mark.parametrize("case", ["static", "retry", "traced ramp",
                                  "host path", "screened"])
def test_ell_chunk_matches_jax(devices, case):
    opts, jin = _case(jtdgl, case)
    _, tin = _case(ttdgl, case)
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts), **jin)
    ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**opts),
                          torch_device="cpu", **tin)
    assert not ts.structured and ts.chunk_size == js.chunk_size
    assert ts.cfg.amg_omega == js.cfg.amg_omega == 0.6
    assert ts.cfg.screening_cg_iters == js.cfg.screening_cg_iters == 32
    assert ts.cfg.poisson_fixed_iters is js.cfg.poisson_fixed_iters is None
    jstate = js._initial_state()
    tstate = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")
    outs = []
    while int(jstate.step) < (10 if case in ("retry", "screened") else 20):
        if case == "host path":
            assert ts.host_dynamic and ts.chunk_size == 1
            jstate = js._host_update(jstate)
            tstate = ts._host_update(tstate)
        jstate, jout, _ = js.chunk_fn(jstate)
        tstate, tout, texp = ts.chunk_fn(tstate)
        outs.append((jout, tout))
    assert int(tstate.step) == int(jstate.step)
    assert not bool(jstate.failed) and not bool(tstate.failed)
    for name in ("psi", "mu", "supercurrent", "normal_current", "A_induced",
                 "A_applied", "mu_boundary", "dpsi_window"):
        assert _rel(getattr(tstate, name), getattr(jstate, name)) < 1e-10, \
            name
    # dA/dt is zero once the ramp ends, up to the JAX program's rounding
    # (~1e-14): measured against the scale of A / dt.
    scale = max(float(np.abs(np.asarray(jstate.A_applied)).max())
                / float(jstate.prev_dt), 1e-300)
    assert np.abs(tstate.dA_dt.numpy()
                  - np.asarray(jstate.dA_dt)).max() < 1e-10 * scale
    for field in ("cg_iterations", "screening_iterations", "valid"):
        for jout, tout in outs:
            assert getattr(tout, field).tolist() == \
                np.asarray(getattr(jout, field)).tolist(), field
    for name in ("dt", "mu_probe", "theta_probe"):
        got = np.concatenate([getattr(t, name).numpy() for _, t in outs])
        ref = np.concatenate([np.asarray(getattr(j, name)) for j, _ in outs])
        assert _rel(got, ref) < 1e-10, name
    dts = np.concatenate([np.asarray(j.dt) for j, _ in outs])
    if case == "retry":
        assert dts[0] < opts["dt_init"]
    if case == "screened":
        its = np.concatenate([np.asarray(j.screening_iterations)
                              for j, _ in outs])
        assert its.max() > 1
        assert float(torch.abs(tstate.A_induced).max()) > 0
    assert _rel(texp["psi_real"], np.asarray(jstate.psi)[:, 0]) < 1e-10


def test_float32_chunk(devices):
    """Float32, default options (adaptive dt, AMG, tolerance-stopped CG at
    1e-4): 20 steps from the JAX initial state. Float32 rounding parts the
    two packages' CG iterates at the 1e-4 stopping tolerance, so the
    pins are those of the structured port's float32 test (psi 5e-4, mu
    5e-3 relative), and the mean CG count agrees to 1 iteration."""
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=20,
                dtype="float32", field_units="mT", current_units="uA")
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts),
                   applied_vector_potential=0.5, terminal_currents=CURRENTS)
    ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**opts),
                          applied_vector_potential=0.5,
                          terminal_currents=CURRENTS, torch_device="cpu")
    jstate = js._initial_state()
    tstate = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")
    jstate, jout, _ = js.chunk_fn(jstate)
    tstate, tout, _ = ts.chunk_fn(tstate)
    assert tstate.psi.dtype == torch.float32
    assert int(tstate.step) == int(jstate.step) == 20
    assert _rel(tstate.psi, jstate.psi) < 5e-4
    assert _rel(tstate.mu, jstate.mu) < 5e-3
    assert abs(float(tout.cg_iterations.float().mean())
               - float(np.mean(jout.cg_iterations))) <= 1.0


def test_solver_state_converter_takes_export_dict(devices):
    """``convert.solver_state_to_torch`` on the JAX chunk's
    ``export_state_arrays`` dict (with a template for the fields an
    export lacks) gives the same state as on the JAX ``SolverState``."""
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=5,
                dtype="float64", field_units="mT", current_units="uA")
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts),
                   applied_vector_potential=0.5, terminal_currents=CURRENTS)
    jstate, _, exported = js.chunk_fn(js._initial_state())
    direct = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, jstate), "cpu")
    with pytest.raises(ValueError, match="template"):
        convert.solver_state_to_torch(exported, "cpu")
    from_export = convert.solver_state_to_torch(
        jax.tree.map(np.asarray, exported), "cpu", template=direct)
    for name in direct._fields:
        a, b = getattr(from_export, name), getattr(direct, name)
        if name in ("time", "prev_dt", "tentative_dt"):
            # The export's diagnostics are float32.
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)), name
        else:
            assert torch.equal(a, b), name
    assert int(from_export.step) == 5 and from_export.psi.shape[-1] == 2
