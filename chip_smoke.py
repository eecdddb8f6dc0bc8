#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

The workload is the benchmark's: a structured (hex-lattice) film of
~50,000 sites padded to a (256, 384) grid, float32, a static 0.5 mT applied
field, screening off, adaptive dt, and the gated fast chunk program with
failover to the robust program. Phases (each prints its seconds):

1. the card's name and power limit (``nvidia-smi``); fails without CUDA;
2. build of the CUDA kernels from ``tdgl_tpu_torch/csrc`` with ``nvcc``;
3. the benchmark device and solver (host meshing, stencils, multigrid);
4. each kernel against its plain PyTorch version at the benchmark grid in
   float32 (raw and factored link phases) and on a small grid in float64,
   with CUDA-event timings (median of 50 launches);
5. a small-input reference check: a float64 chunk on the card against the
   same solver on the CPU (plain versions);
6. the main path: ``TDGLSolver(..., torch_device="cuda")``,
   ``_initial_state()`` and several ``chunk_fn`` calls, with the kernels'
   launch counters reset just before and read just after;
7. where a step's time goes, from the main path's final state: wall time,
   torch ops and device kernel time per step (``torch.profiler``), for
   the fast and the robust program.

The last two stdout lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Usage: ``python3 chip_smoke.py`` (one
GPU); ``--chunk`` and ``--chunks`` resize the main-path run.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# Tolerances of the kernel checks (the CPU pins of the JAX package's
# Pallas parity test): float32 psi 3e-5 absolute, RHS 3e-5 x RHS scale;
# float64 1e-12 relative.
F32_TOL = 3e-5
F64_TOL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.seconds = time.perf_counter() - self.t0
            log(f"[phase] {self.name}: {self.seconds:.2f} s")


def bench_device(pkg, target_sites: int = 50_000):
    """The benchmark film (``bench.build_device``), built with the port."""
    import numpy as np

    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    side = float(np.sqrt(target_sites * 0.238))
    film = pkg.Polygon("film", points=pkg.box(side)).resample(
        max(200, int(11 * side))
    )
    device = pkg.Device("bench", layer=layer, film=film, length_units="um")
    device.make_mesh(min_points=target_sites, max_edge_length=0.75,
                     structured=True)
    return device


def cuda_times(fn, n: int = 50, warmup: int = 5):
    """Medians over ``n`` runs of one ``fn()`` call, in ms, from CUDA events.

    ``device``: the call's kernels run back to back, because the stream is
    held by a ~5 ms device-side sleep while the host queues them — the
    device time of the call. ``paced``: the same call from an idle stream,
    so host dispatch gaps between its kernels count — what a host-bound
    caller pays.
    """
    import torch

    for _ in range(warmup):
        fn()
    times = {"device": [], "paced": []}
    for _ in range(n):
        for mode in times:
            torch.cuda.synchronize()
            if mode == "device":
                torch.cuda._sleep(10_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[mode].append(start.elapsed_time(end))
    return {mode: statistics.median(t) for mode, t in times.items()}


def random_inputs(solver, seed: int):
    """Seeded psi (|psi| <= 1), mu and dA/dt on the solver's grid."""
    import numpy as np
    import torch

    shape = solver.maps.shape
    valid = np.asarray(solver.host_sten.valid)
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.0, 1.0, shape)
    phase = rng.uniform(-np.pi, np.pi, shape)

    def t(a):
        return torch.tensor(a, dtype=solver.torch_dtype,
                            device=solver.torch_device)

    return dict(
        pr=t(amp * np.cos(phase) * valid), pi=t(amp * np.sin(phase) * valid),
        mu=t(rng.normal(size=shape) * valid),
        eps=t(np.ones(shape) * valid),
        dA=t(rng.normal(size=(3,) + shape) * 0.05
             * np.asarray(solver.host_sten.edge_valid)),
    )


def check_kernels(solver, state, f64: bool, timed: bool):
    """Each kernel vs its plain version on the same inputs, in both link
    forms. Returns ``{kernel: {form: {err[, ms, plain_ms, paced_ms,
    plain_paced_ms]}}}``."""
    import torch

    from tdgl_tpu_torch.models import gtdgl_stencil as gs
    from tdgl_tpu_torch.ops import step_kernels as sk

    x = random_inputs(solver, seed=7)
    dt = torch.tensor(1e-2, dtype=solver.torch_dtype,
                      device=solver.torch_device)
    g, u, sten = solver.cfg.gamma, solver.cfg.u, solver.sten
    links = {"raw": gs.edge_link_phases(sten, state.A_applied),
             "factored": gs.factor_link_phases(sten, state.A_applied)}
    out = {"fused_psi_update": {}, "fused_poisson_rhs": {}}
    for form, U in links.items():
        psi_args = (g, u, sten, U, x["pr"], x["pi"], x["mu"], x["eps"], dt)
        rhs_args = (sten, U, x["pr"], x["pi"], x["dA"], state.neumann_term)
        got = sk.fused_psi_update(*psi_args)
        ref = sk.plain_psi_update(*psi_args)
        rhs = sk.fused_poisson_rhs(*rhs_args)
        rhs_ref = sk.plain_poisson_rhs(*rhs_args)
        torch.cuda.synchronize()
        psi_err = max((a - b).abs().max().item()
                      for a, b in zip(got[:3], ref[:3]))
        psi_scale = max(max(b.abs().max().item() for b in ref[:3]), 1.0)
        rhs_err = (rhs - rhs_ref).abs().max().item()
        rhs_scale = max(rhs_ref.abs().max().item(), 1.0)
        ok_agrees = bool(got[3]) == bool(ref[3])
        if f64:
            psi_pass = psi_err <= F64_TOL * psi_scale
            rhs_pass = rhs_err <= F64_TOL * rhs_scale
        else:
            psi_pass = psi_err < F32_TOL
            rhs_pass = rhs_err < F32_TOL * rhs_scale
        dtype = "float64" if f64 else "float32"
        log(f"  {dtype} {form:8s} psi max|err| {psi_err:.3e} (ok agrees:"
            f" {ok_agrees}); rhs max|err| {rhs_err:.3e} (scale"
            f" {rhs_scale:.3e})")
        assert ok_agrees, f"psi kernel ok flag disagrees ({dtype}, {form})"
        assert psi_pass, f"psi kernel disagrees ({dtype}, {form})"
        assert rhs_pass, f"rhs kernel disagrees ({dtype}, {form})"
        calls = {
            "fused_psi_update": (psi_err, lambda: sk.fused_psi_update(
                *psi_args), lambda: sk.plain_psi_update(*psi_args)),
            "fused_poisson_rhs": (rhs_err, lambda: sk.fused_poisson_rhs(
                *rhs_args), lambda: sk.plain_poisson_rhs(*rhs_args)),
        }
        for name, (err, kernel, plain) in calls.items():
            rec = dict(err=err)
            if timed:
                k, p = cuda_times(kernel), cuda_times(plain)
                rec.update(ms=k["device"], plain_ms=p["device"],
                           paced_ms=k["paced"], plain_paced_ms=p["paced"])
                log(f"  {dtype} {form:8s} {name}: device {k['device']:.4f}"
                    f" ms (plain {p['device']:.4f} ms); paced"
                    f" {k['paced']:.4f} ms (plain {p['paced']:.4f} ms)")
            out[name][form] = rec
    return out


def time_breakdown(solver, state, steps: int = 200, prof_steps: int = 20):
    """Where a step's time goes, for the fast and the robust chunk program
    started from ``state``: wall ms per step (3 runs of ``steps`` steps),
    torch ops dispatched per step, and, from ``torch.profiler`` over
    ``prof_steps`` steps, the device kernel time per step, its share of the
    unprofiled wall (median run) and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from tdgl_tpu_torch.solver.grid_step import make_grid_chunk_fn

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    for name, cfg in (("fast", solver._fast_cfg), ("robust", solver.cfg)):
        run = make_grid_chunk_fn(cfg, steps)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(solver.sten, solver.amg, state)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / steps * 1e3)
        short = make_grid_chunk_fn(cfg, prof_steps)
        counter = OpCount()
        with counter:
            short(solver.sten, solver.amg, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            short(solver.sten, solver.amg, state)
            torch.cuda.synchronize()
        # Device-side records only (kernels, memsets, copies).
        kernels = sorted(
            ((e.self_device_time_total / prof_steps, e.count / prof_steps,
              e.key) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA),
            reverse=True)
        device_ms = sum(k[0] for k in kernels) / 1e3
        busy = 100 * device_ms / statistics.median(walls)
        log(f"  {name}: wall ms/step {', '.join(f'{w:.2f}' for w in walls)};"
            f" torch ops/step {counter.n / prof_steps:.1f}; device kernel"
            f" time {device_ms:.3f} ms/step, {sum(k[1] for k in kernels):.0f}"
            f" launches/step, busy {busy:.1f}% of the median wall")
        for us, count, key in kernels[:8]:
            log(f"    {us:8.2f} us/step x {count:6.1f}  {key[:70]}")


def small_device(pkg):
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(14, 8)).resample(200)
    hole = pkg.Polygon("hole", points=pkg.circle(1.0, center=(2, 1)))
    source = pkg.Polygon("source", points=pkg.box(1, 6, center=(-7, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, 6, center=(7, 0)))
    device = pkg.Device("small", layer=layer, film=film, holes=[hole],
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=700, structured=True)
    return device


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunk", type=int, default=2000,
                        help="steps per chunk on the main path")
    parser.add_argument("--chunks", type=int, default=4,
                        help="chunks on the main path (at least 3)")
    args = parser.parse_args()
    if args.chunks < 3:
        parser.error("--chunks must be at least 3")

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an"
                           " NVIDIA GPU.")
    import numpy as np

    import tdgl_tpu_torch as ttdgl
    from tdgl_tpu_torch.ops import kernel_build
    from tdgl_tpu_torch.ops import step_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("gpu"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        log(f"gpu: {smi} | torch {torch.__version__} cuda"
            f" {torch.version.cuda}")

    with Phase("build kernels (nvcc, sm_90a)"):
        kernel_build.load_library()
        info = kernel_build.BUILD_INFO
        log(f"  library {os.path.relpath(info['path'])} (cached:"
            f" {info['cached']}, {info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    options = dict(solve_time=1e9, dt_init=1e-4, dt_max=1e-2,
                   save_every=args.chunk, steps_per_chunk=args.chunk,
                   field_units="mT", current_units="uA", dtype="float32")
    with Phase("benchmark device + solver setup"):
        device = bench_device(ttdgl)
        solver = ttdgl.TDGLSolver(device, ttdgl.SolverOptions(**options),
                                  applied_vector_potential=0.5,
                                  torch_device="cuda")
        n_sites = len(device.mesh.sites)
        log(f"  {n_sites} sites, grid {solver.maps.shape}, multigrid"
            f" {solver.amg.shapes}, factored links"
            f" {solver.cfg.factor_link_phases}, chunk {solver.chunk_size}")
        assert solver.maps.shape == (256, 384), solver.maps.shape
        assert solver.cfg.factor_link_phases

    with Phase("kernels vs plain versions"):
        results = check_kernels(solver, solver._initial_state(), f64=False,
                                timed=True)
        small64 = ttdgl.TDGLSolver(
            small_device(ttdgl),
            ttdgl.SolverOptions(solve_time=1e9, dtype="float64",
                                field_units="mT", current_units="uA",
                                factor_link_phases=True),
            applied_vector_potential=0.5,
            terminal_currents=dict(source=3.0, drain=-3.0),
            torch_device="cuda")
        check_kernels(small64, small64._initial_state(), f64=True,
                      timed=False)

    with Phase("small-input reference (float64, card vs CPU)"):
        small_opts = ttdgl.SolverOptions(
            solve_time=1e9, dtype="float64", adaptive=False, dt_init=1e-3,
            save_every=40, steps_per_chunk=40, field_units="mT",
            current_units="uA")
        dev_small = small_device(ttdgl)
        ref = {}
        for key, where in (("card", "cuda"), ("host", "cpu")):
            s = ttdgl.TDGLSolver(dev_small, small_opts,
                                 applied_vector_potential=0.5,
                                 terminal_currents=dict(source=3.0,
                                                        drain=-3.0),
                                 torch_device=where)
            st, _, _ = s.chunk_fn(s._initial_state())
            ref[key] = st
        for name in ("psi_r", "psi_i", "mu"):
            a = getattr(ref["card"], name).cpu()
            b = getattr(ref["host"], name)
            rel = ((a - b).abs().max() / b.abs().max()).item()
            log(f"  {name}: max rel err {rel:.3e} after 40 steps")
            assert rel < 1e-10, name
        assert int(ref["card"].step) == 40 and not bool(ref["card"].failed)

    with Phase("main path") as ph:
        state = solver._initial_state()
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        cg_iters = []
        for c in range(args.chunks):
            tc = time.perf_counter()
            before = solver._failover_count
            state, outputs, exported = solver.chunk_fn(state)
            cg_iters.append(outputs.cg_iterations.float().mean().item())
            log(f"  chunk {c}: {time.perf_counter() - tc:.2f} s, failover"
                f" {solver._failover_count - before}, t ="
                f" {state.time.item():.4f}, dt = {state.prev_dt.item():.3e},"
                f" mean CG its {cg_iters[-1]:.2f}")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
    steps = args.chunks * solver.chunk_size
    rewound = solver._failover_count * solver.chunk_size
    psi_abs = torch.sqrt(state.psi_r**2 + state.psi_i**2)
    psi_sites = solver.maps.grid_to_site(psi_abs.cpu().numpy())
    log(f"  sites {n_sites}, grid {solver.maps.shape}, {steps} steps in"
        f" {elapsed:.2f} s = {steps / elapsed:.2f} steps/s (failover"
        f" re-runs included), failovers {solver._failover_count}, mean CG"
        f" its {np.mean(cg_iters):.3f}, |psi| in [{psi_sites.min():.4f},"
        f" {psi_sites.max():.4f}], launches {launches}")
    assert int(state.step) == steps, (int(state.step), steps)
    assert not bool(state.failed)
    for name in ("psi_r", "psi_i", "mu", "supercurrent", "normal_current"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    assert tuple(state.psi_r.shape) == (256, 384)
    assert launches["fused_psi_update"] >= steps + rewound
    assert launches["fused_poisson_rhs"] == steps + rewound

    with Phase("where the time goes (from the final state)"):
        time_breakdown(solver, state)

    smi_after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"gpu after: {smi_after}")

    def record(name, source, replaces):
        fac = results[name]["factored"]
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["err"] for r in results[name].values()),
            ms=fac["ms"], plain_ms=fac["plain_ms"],
        )

    kernels = [
        record("fused_psi_update", "tdgl_tpu_torch/csrc/psi_update.cu",
               "tdgl_tpu/ops/pallas_step.py:61"),
        record("fused_poisson_rhs", "tdgl_tpu_torch/csrc/poisson_rhs.cu",
               "tdgl_tpu/ops/pallas_step.py:162"),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
