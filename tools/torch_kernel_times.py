"""Device ms of one single-run call of each CUDA step kernel of the
PyTorch port, in the checkout given as the first argument.

Usage, on a machine with an NVIDIA GPU (one process per checkout; to
compare two commits, run both in one session, alternating, e.g.
parent, change, change, parent):

    python tools/torch_kernel_times.py <checkout>

The benchmark film of ``chip_smoke.bench_device`` (50,040 sites, grid
(256, 384)), float32, factored and raw links, seeded inputs; each time is
``chip_smoke.queued_ms`` of 200 back-to-back calls (median of 5 runs), with
a fill of one plane as the launch floor. Prints one JSON line.
"""

import json
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tdgl_tpu_torch as ttdgl  # noqa: E402
from tdgl_tpu_torch.models import gtdgl_stencil as gs  # noqa: E402
from tdgl_tpu_torch.ops import step_kernels as sk  # noqa: E402

dev = cs.bench_device(ttdgl)
solver = ttdgl.TDGLSolver(
    dev, ttdgl.SolverOptions(solve_time=1, dt_init=1e-4, dt_max=1e-2,
                             save_every=100, field_units="mT",
                             current_units="uA", dtype="float32"),
    applied_vector_potential=0.5,
    terminal_currents=dict(source=20.0, drain=-20.0), torch_device="cuda")
st = solver._initial_state()
x = cs.random_inputs(solver, seed=7)
dt = torch.tensor(1e-2, device="cuda")
g, u = solver.cfg.gamma, solver.cfg.u
cyc = cs.sleep_cycles_per_ms()
out = {"tree": sys.argv[1]}
fill = x["pr"].clone()
out["fill"] = cs.queued_ms(fill.zero_, 200, cyc, repeats=5)
for form, U in (("factored", gs.factor_link_phases(solver.sten,
                                                    st.A_applied)),
                ("raw", gs.edge_link_phases(solver.sten, st.A_applied))):
    ops = sk.StepOperands(solver.sten, U, x["dA"], st.neumann_term)
    out[f"psi_{form}"] = cs.queued_ms(
        lambda: ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], x["eps"],
                               dt), 200, cyc, repeats=5)
    out[f"rhs_{form}"] = cs.queued_ms(
        lambda: ops.poisson_rhs(x["pr"], x["pi"]), 200, cyc, repeats=5)
print(json.dumps(out))
