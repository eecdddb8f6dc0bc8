"""How long a sweep member follows the same member run alone, in both
packages, on the CPU at float64.

Usage (CPU, about a minute):

    python tools/sweep_divergence_probe.py [max_steps]

The small film of ``chip_smoke.small_device`` (~700 sites, a hole, a
source and a drain), 3 uA into the source (current scales 0.5, 1 and 2),
0.5 mT, adaptive dt, the robust program. For each member it prints the
first step at which the probe potentials of two runs part by more than
1e-9 of their scale, and their largest difference at the last step, for:
the JAX package's 3-member sweep against the member run alone
(``tdgl_tpu.parallel.solve_sweep`` with one scale), the port's batch
against the port's member alone, and the port's batch against the JAX
package's. In the film's phase-slip regime a difference at the rounding
level grows about tenfold every few steps, in either package, so a
batched member and its single run (or the two packages) agree closely
only over a finite number of steps. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tdgl_tpu as jtdgl  # noqa: E402
import tdgl_tpu_torch as ttdgl  # noqa: E402
from tdgl_tpu.parallel import solve_sweep as jax_sweep  # noqa: E402
from tdgl_tpu_torch.parallel import solve_sweep as port_sweep  # noqa: E402

SCALES = [0.5, 1.0, 2.0]


def run(pkg, sweep, scales, max_steps, **extra):
    options = pkg.SolverOptions(solve_time=1e9, dt_init=1e-3, dt_max=1e-2,
                                save_every=20, dtype="float64",
                                field_units="mT", current_units="uA")
    return sweep(cs.small_device(pkg), options, current_scales=scales,
                 max_steps=max_steps, applied_vector_potential=0.5,
                 terminal_currents=dict(source=3.0, drain=-3.0), **extra)


def parting(a, b, tol=1e-9):
    """First step at which probe potentials ``a`` and ``b`` ((P, T))
    differ by more than ``tol`` of their scale, and their largest
    difference at the last step."""
    d = np.abs(a - b).max(axis=0)
    apart = np.flatnonzero(d > tol * np.abs(a).max())
    return (int(apart[0]) if len(apart) else None), float(d[-1])


def main():
    max_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    port = dict(torch_device="cpu")
    jax_b = run(jtdgl, jax_sweep, SCALES, max_steps)
    port_b = run(ttdgl, port_sweep, SCALES, max_steps, **port)
    out = {"max_steps": max_steps, "members": []}
    for b, scale in enumerate(SCALES):
        jax_1 = run(jtdgl, jax_sweep, [scale], max_steps)
        port_1 = run(ttdgl, port_sweep, [scale], max_steps, **port)
        row = {"scale": scale}
        for key, (x, y) in {
                "jax batch vs jax alone": (jax_b.dynamics_mu[b],
                                           jax_1.dynamics_mu[0]),
                "port batch vs port alone": (port_b.dynamics_mu[b],
                                             port_1.dynamics_mu[0]),
                "port batch vs jax batch": (port_b.dynamics_mu[b],
                                            jax_b.dynamics_mu[b])}.items():
            step, last = parting(x, y)
            row[key] = {"apart_from_step": step, "last_step_diff": last}
        out["members"].append(row)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
