"""A float32 screened run, the screening options the port refuses, and
the fluxoid quantization against the JAX package's.

The fixtures are in ``tests/test_torch_screening.py``.
"""

import numpy as np
import pytest

import tdgl_tpu as jtdgl
import tdgl_tpu_torch as ttdgl
from tdgl_tpu.solver.solver import TDGLSolver as JaxSolver

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_screening import (_options, _rel, _start, devices,
                                  one_blas_thread, one_hierarchy_per_mesh)


def test_float32_screened_run(devices):
    opts = _options(dtype="float32", screening_error_norm="auto",
                    screening_tolerance=1e-3, save_every=10)
    kw = dict(applied_vector_potential=0.1,
              terminal_currents=dict(source=1.0, drain=-1.0))
    js = JaxSolver(devices["jax"], jtdgl.SolverOptions(**opts), **kw)
    ts = ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(**opts),
                          torch_device="cpu", **kw)
    # The fast program's float32 overrides match the JAX package's.
    for field in ("screening_cg_iters", "screening_site_eval",
                  "poisson_fail_gate", "screening_tolerance",
                  "poisson_tolerance"):
        assert getattr(ts._fast_cfg, field) == getattr(js._fast_cfg, field)
    assert ts._fast_cfg.screening_site_eval
    jstate, tstate = _start(js)
    jstate, _, _ = js.chunk_fn(jstate)
    tstate, _, _ = ts.chunk_fn(tstate)
    assert int(tstate.step) == int(jstate.step) == 10
    assert ts._failover_count == js._failover_count >= 1
    assert _rel(tstate.psi_r, jstate.psi_r) < 5e-4
    assert _rel(tstate.psi_i, jstate.psi_i) < 5e-4
    assert _rel(tstate.mu, jstate.mu) < 5e-3


def test_unported_screening_options_raise(devices):
    for bad in (dict(screening_kernel="mxu"),
                dict(screening_dft_precision="bf16"),
                dict(screening_kernel="xla", screening_site_eval=True)):
        with pytest.raises(ttdgl.SolverOptionsError):
            ttdgl.TDGLSolver(devices["torch"], ttdgl.SolverOptions(
                **_options(**bad)), torch_device="cpu")


def _bar(pkg):
    xi = 0.1
    layer = pkg.Layer(coherence_length=xi, london_lambda=0.075,
                      thickness=0.05)
    film = pkg.Polygon("film", points=pkg.box(1, 0.5, points=151))
    device = pkg.Device("bar_fast", layer=layer, film=film,
                        length_units="um")
    device.make_mesh(max_edge_length=0.35 * xi, structured=True)
    return device


def test_fluxoid_quantization_matches_jax():
    curves = [jtdgl.geometry.circle(0.15, center=(0, 0)),
              jtdgl.geometry.box(0.25, center=(-0.2, 0)),
              jtdgl.geometry.circle(0.12, center=(0.2, 0.1))]
    errors = {}
    for name, pkg, kw in (("jax", jtdgl, {}),
                          ("torch", ttdgl, {"torch_device": "cpu"})):
        options = pkg.SolverOptions(
            solve_time=0.03, dt_max=1e-3, field_units="mT",
            current_units="uA", include_screening=True,
            screening_tolerance=1e-6, dtype="float64",
            chunk_failover="off")
        solution = pkg.solve(_bar(pkg), options,
                             applied_vector_potential=0.1, **kw)
        errors[name] = []
        for curve in curves:
            fluxoid = solution.polygon_fluxoid(curve)
            total = (fluxoid.flux_part.magnitude
                     + fluxoid.supercurrent_part.magnitude)
            errors[name].append(abs(total / fluxoid.flux_part.magnitude))
    print("fluxoid errors (structured mesh, t = 0.03):", errors)
    assert np.allclose(errors["torch"], errors["jax"], rtol=0, atol=1e-6)
    # Screening lowers every error well below its unscreened value (> 1).
    assert max(errors["torch"]) < 0.5
