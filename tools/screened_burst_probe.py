"""How far a screened sweep member's final state moves under a rounding-
level perturbation, in the JAX package, against how far the port's is
from it, on the CPU at float64.

Usage (CPU, about a minute at the default 0.1 time units):

    python tools/screened_burst_probe.py [solve_time]

The ELL bridge film of ``tests/test_torch_screened_sweep.py`` (~300
Delaunay sites, a source and a drain), field sweep 0, 300 and 600 uT,
screened (the pairwise sum, Anderson, tolerance 1e-3, the fixed point
capped at 140 iterations), ``dt_init`` 1e-4. The dt jump at step 12 gives
the 300 uT member a fixed-point burst of 134 iterations and the 600 uT
member 141 iterations that do not converge (it fails at step 13). For
each member the script prints the largest relative difference of the
final ``psi``, ``mu``, ``supercurrent`` and ``normal_current`` between:
the port's sweep and the JAX package's; the JAX package's sweep and the
same sweep with every field perturbed by 1e-15 relative; and the JAX
package's batch and the member run alone. It also prints each package's
steps per member. Prints one JSON line.

As in the tests, JAX runs on 8 virtual CPU devices (its sweep shards the
3 members over 3 of them, so a member equals its single run bit for bit)
with one BLAS thread; on one device its batch rounds differently from its
single runs, and the differences below change accordingly.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

import tdgl_tpu as jtdgl  # noqa: E402
import tdgl_tpu_torch as ttdgl  # noqa: E402
from tdgl_tpu.parallel import solve_sweep as jax_sweep  # noqa: E402
from tdgl_tpu_torch.parallel import solve_sweep as port_sweep  # noqa: E402

FIELDS = np.array([0.0, 300.0, 600.0])
NAMES = ("psi", "mu", "supercurrent", "normal_current")


def bridge(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2, thickness=0.1,
                      conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(12, 5)).resample(120)
    source = pkg.Polygon(points=pkg.box(0.5, 5, center=(-6, 0))).set_name(
        "source")
    drain = source.copy().scale(xfact=-1).set_name("drain")
    device = pkg.Device("bridge", layer=layer, film=film,
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)])
    device.make_mesh(min_points=300, smooth=20)
    return device


def run(pkg, sweep, fields, solve_time, **extra):
    options = pkg.SolverOptions(
        solve_time=solve_time, dt_init=1e-4, save_every=50,
        field_units="uT", current_units="uA", dtype="float64",
        include_screening=True, max_iterations_per_step=140)
    return sweep(bridge(pkg), options, field_scales=fields,
                 applied_vector_potential=pkg.ConstantField(
                     1.0, field_units="uT"),
                 max_steps=20000, raise_on_failure=False, **extra)


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def main():
    solve_time = float(sys.argv[1]) if len(sys.argv) > 1 else 0.1
    torch.set_num_threads(1)
    threadpool_limits(limits=1)
    port = run(ttdgl, port_sweep, FIELDS, solve_time, torch_device="cpu")
    ref = run(jtdgl, jax_sweep, FIELDS, solve_time)
    perturbed = run(jtdgl, jax_sweep, FIELDS * (1 + 1e-15), solve_time)
    out = {"solve_time": solve_time, "steps": {
        "port": port.steps.tolist(), "jax": ref.steps.tolist(),
        "jax perturbed": perturbed.steps.tolist()},
        "failed": ref.failed.tolist(), "members": []}
    for b, field in enumerate(FIELDS):
        alone = run(jtdgl, jax_sweep, FIELDS[b:b + 1], solve_time)
        row = {"field_uT": field}
        for key, (x, y, i) in {
                "port vs jax": (port, ref, b),
                "jax perturbed vs jax": (perturbed, ref, b),
                "jax alone vs jax batch": (alone, ref, 0)}.items():
            row[key] = {n: rel(getattr(x, n)[i], getattr(y, n)[b])
                        for n in NAMES}
        out["members"].append(row)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
