#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

The workload is the benchmark's film: a structured (hex-lattice) film of
~50,000 sites padded to a (256, 384) grid, here with a source and a drain
terminal on its left and right edges and two probe points at +-side/4;
float32, adaptive dt, and the gated fast chunk program with failover to
the robust program. Phases (each prints its seconds):

1. the card's name and power limit (``nvidia-smi``); fails without CUDA;
2. build of the CUDA kernels from ``tdgl_tpu_torch/csrc`` with ``nvcc``
   (one process per source, started together);
3. the device and solver (host meshing, stencils, multigrid);
4. each kernel against its plain PyTorch version at the benchmark grid in
   float32 (raw and factored link phases) and on a small grid in float64,
   on the real stencil and on a periodic one (every edge live, so edge
   tiles must read the wrapped halo), both forms of the RHS kernel (the
   second also writes the edge supercurrent J_s), the ``ok`` flag through
   a fail/pass/fail/pass sequence, and CUDA-event timings: device ms per
   call over 200 back-to-back calls (warm L2, and with L2 flushed before
   each call), the paced ms of one call from an idle stream, the plain
   version's ms, and the bound from shapes with the share of it reached,
   beside two floors timed the same way: a fill of one plane (the launch
   floor) and a copy of 7 planes into 7 (the same ~5.5 MB as a factored
   kernel call, streamed by one library kernel);
5. small-input reference checks, float64 on the card against the same
   solver on the CPU (plain versions): a static chunk, a traced field and
   current ramp, and a screened chunk in the robust and the fast program;
6. the bare chunk loop: ``TDGLSolver(..., torch_device="cuda")``,
   ``_initial_state()`` and ``chunk_fn`` calls until ``solve_time`` (about
   2,000 steps), one host read per chunk, nothing written; static 0.5 mT
   field and 20 uA source current, screening off;
7. ``tdgl_tpu_torch.solve()`` on the same device with the same options
   (the package's entry point: the same chunks, plus the Runner's
   snapshots, checkpoints and the output file), its ``Solution`` read back
   with ``Solution.from_hdf5``; the difference from phase 6 is the
   Runner's cost;
8. where a step's time goes, from phase 6's final state: wall time,
   torch ops and device kernel time per step (``torch.profiler``), for
   the fast and the robust program, and the device records of one psi
   wrapper call (one kernel, no fill or compare);
9. a traced ramp through ``solve()``: the applied field ramps as
   ``ConstantField(0.5) * LinearRamp`` and a ``jittable`` source current
   from 0 to 20 uA over the first half of ``--ramp-time`` (about 2,000
   steps in chunks of 500, inputs evaluated on the card inside the
   chunk), its steps/s beside phase 7's, the fast step's ops and device
   time, and the mean probe voltage over the first and the last chunk;
   then the host path: the same current as a plain callable, evaluated
   before every step (chunk size 1, about 50 steps);
10. screening through ``solve()`` at ``bench.py``'s screened operating
    point (0.5 mT, tolerance 1e-3, the fft kernel, Anderson, the fast
    program with site evaluation and failover; about 1,000 steps in chunks
    of 200): steps/s, failovers, screening iterations, launches per step
    slot (exactly one of each kernel in every committed fast chunk), the
    fast and robust screened step's ops and device time, and the device ms
    of one induced-potential evaluation (exact and site-evaluated).

Phases 6, 7, 9 and 10 each reset the kernels' launch counters just before
each of their runs and read them just after; each count must match the
step slots that run executed (chunks times chunk size, robust re-runs
included). The last two stdout lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Usage: ``python3 chip_smoke.py`` (one
GPU); ``--chunk`` and ``--solve-time`` resize phases 6 and 7,
``--ramp-time``/``--ramp-chunk`` phase 9, ``--screen-time``/
``--screen-chunk`` phase 10.
"""

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Tolerances of the kernel checks (the CPU pins of the JAX package's
# Pallas parity test): float32 psi 3e-5 absolute, RHS 3e-5 x RHS scale;
# float64 1e-12 relative.
F32_TOL = 3e-5
F64_TOL = 1e-12

# The bound from shapes: an NVIDIA H100 SXM's published HBM rate and
# float32 peak outside the tensor cores (the operations of both kernels
# are float32 adds, multiplies and a few sqrt/cos/sin, no matrix product).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per grid site, counted from csrc/*.cu (each add, multiply,
# divide, sqrt, cos or sin is one): the psi update 139 raw + 36 for
# rebuilding the 6 links from the factored vectors; the RHS 50 raw + 18.
OPS_PER_SITE = {"fused_psi_update": {"raw": 139, "factored": 175},
                "fused_poisson_rhs": {"raw": 50, "factored": 68}}
# The J_s-writing form of the RHS kernel does the same operations and
# writes three more planes.
OPS_PER_SITE["fused_poisson_rhs (J_s form)"] = OPS_PER_SITE["fused_poisson_rhs"]


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
    """The benchmark film (``bench.build_device``), built with the port,
    with a source and a drain terminal on its left and right edges and
    two probe points at +-side/4 (the terminals do not change the
    mesh)."""
    import numpy as np

    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    side = float(np.sqrt(target_sites * 0.238))
    film = pkg.Polygon("film", points=pkg.box(side)).resample(
        max(200, int(11 * side))
    )
    source = pkg.Polygon("source", points=pkg.box(1, side / 2,
                                                  center=(-side / 2, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, side / 2,
                                                center=(side / 2, 0)))
    device = pkg.Device("bench", layer=layer, film=film,
                        terminals=[source, drain],
                        probe_points=[(-side / 4, 0), (side / 4, 0)],
                        length_units="um")
    device.make_mesh(min_points=target_sites, max_edge_length=0.75,
                     structured=True)
    return device


class FailoverCount(logging.Handler):
    """Counts the solver's failover records (the log line it writes each
    time a fast chunk is rewound and re-run with the robust program)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.n = 0

    def emit(self, record):
        if "fast chunk flagged" in record.getMessage():
            self.n += 1


def timed_calls(cls, names, seconds):
    """Wrap methods ``names`` of ``cls`` to append their wall seconds to
    ``seconds``; returns a function that restores them."""
    saved = {name: getattr(cls, name) for name in names}

    def wrap(fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds.append(time.perf_counter() - t0)
        return timed

    for name, fn in saved.items():
        setattr(cls, name, wrap(fn))
    return lambda: [setattr(cls, n, fn) for n, fn in saved.items()]


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms, from CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def queued_ms(fn, n: int, cycles_per_ms: float, flush=None,
              repeats: int = 1):
    """Device ms per ``fn()`` call over ``n`` back-to-back calls (the
    median of ``repeats`` such runs).

    The calls are queued behind a device-side sleep that outlasts the
    host's enqueueing (checked: the start event must still be pending when
    the last call is queued; else the sleep grows and the run repeats), so
    host dispatch never starves the stream. CUDA's launch queue holds
    about a thousand entries, so a call of many kernels (a plain
    version) is timed with a small ``n`` and several ``repeats``. Without
    ``flush``: CUDA events around the whole run, divided by ``n`` (inputs
    warm in L2). With ``flush`` (a large tensor), it is zeroed before each
    call, evicting L2, and only the calls' own event intervals are summed
    (cold L2).
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        if flush is not None:
            flush.zero_()
        fn()
    hold_ms = 2.0 * (time.perf_counter() - t0) / 5 * 1e3 * n + 2.0
    torch.cuda.synchronize()
    runs = []
    while len(runs) < repeats:
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(2 * n if flush is not None else 2)]
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        if flush is None:
            events[0].record()
            for _ in range(n):
                fn()
            events[1].record()
        else:
            for i in range(n):
                flush.zero_()
                events[2 * i].record()
                fn()
                events[2 * i + 1].record()
        queued = not events[0].query()
        events[-1].synchronize()
        if queued:
            runs.append(sum(events[i].elapsed_time(events[i + 1])
                            for i in range(0, len(events), 2)) / n)
        elif hold_ms > 5_000:
            raise RuntimeError("the host could not queue the calls ahead"
                               " of the device")
        else:
            hold_ms *= 4
    return statistics.median(runs)


def paced_ms(fn, n: int = 50):
    """Median ms of one ``fn()`` call from an idle stream (CUDA events):
    host dispatch gaps between its kernels count — what a host-bound
    caller pays."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(name: str, form: str, inputs, outputs):
    """The least time for one call: each input read once and each output
    written once at the HBM rate, against the operations at the float32
    peak. Returns ``(ms, "bytes" or "operations")``."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    sites = outputs[0].numel()
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = OPS_PER_SITE[name][form] * sites / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def random_inputs(solver, seed: int, sten=None):
    """Seeded psi (|psi| <= 1), mu and dA/dt on the grid of ``sten``
    (host arrays; default: the solver's), zero off its valid sites."""
    import numpy as np
    import torch

    shape = solver.maps.shape
    sten = solver.host_sten if sten is None else sten
    valid = np.asarray(sten.valid)
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
             * np.asarray(sten.edge_valid)),
    )


def check_kernels(solver, state, f64: bool, periodic: bool = False):
    """Each kernel vs its plain version on the same inputs, in both link
    forms, on the solver's stencil or (``periodic``) on
    ``testing.periodic_stencil`` of it. Asserts the tolerances and
    returns ``{kernel: {form: max |err|}}`` and, per form, the bound
    operands and inputs of the check."""
    import torch

    from tdgl_tpu_torch import convert
    from tdgl_tpu_torch.models import gtdgl_stencil as gs
    from tdgl_tpu_torch.ops import step_kernels as sk
    from tdgl_tpu_torch.testing import periodic_stencil

    host = solver.host_sten
    if periodic:
        host = periodic_stencil(host, seed=5)
    sten = convert.stencil_to_torch(host, solver.torch_device)
    x = random_inputs(solver, seed=7, sten=host)
    neumann = (x["mu"] * 0.1 if periodic else state.neumann_term)
    dt = torch.tensor(1e-2, dtype=solver.torch_dtype,
                      device=solver.torch_device)
    g, u = solver.cfg.gamma, solver.cfg.u
    links = {"raw": gs.edge_link_phases(sten, state.A_applied),
             "factored": gs.factor_link_phases(sten, state.A_applied)}
    errs = {"fused_psi_update": {}, "fused_poisson_rhs": {}}
    cases = {}
    for form, U in links.items():
        ops = sk.StepOperands(sten, U, x["dA"], neumann)
        psi_in = (x["pr"], x["pi"], x["mu"], x["eps"], dt)
        got = ops.psi_update(g, u, *psi_in)
        ref = sk.plain_psi_update(g, u, sten, U, *psi_in)
        rhs = ops.poisson_rhs(x["pr"], x["pi"])
        rhs_ref = sk.plain_poisson_rhs(sten, U, x["pr"], x["pi"], x["dA"],
                                       neumann)
        rhs_js, js = ops.poisson_rhs(x["pr"], x["pi"], with_supercurrent=True)
        rhs_js_ref, js_ref = sk.plain_poisson_rhs(
            sten, U, x["pr"], x["pi"], x["dA"], neumann,
            with_supercurrent=True)
        torch.cuda.synchronize()
        psi_err = max((a - b).abs().max().item()
                      for a, b in zip(got[:3], ref[:3]))
        psi_scale = max(max(b.abs().max().item() for b in ref[:3]), 1.0)
        rhs_err = (rhs - rhs_ref).abs().max().item()
        rhs_scale = max(rhs_ref.abs().max().item(), 1.0)
        # The J_s form: both outputs, each against its own scale.
        js_errs = [((a - b).abs().max().item(),
                    max(b.abs().max().item(), 1.0))
                   for a, b in ((rhs_js, rhs_js_ref), (js, js_ref))]
        ok_agrees = bool(got[3]) == bool(ref[3])
        tol = F64_TOL if f64 else F32_TOL
        if f64:
            psi_pass = psi_err <= F64_TOL * psi_scale
            rhs_pass = rhs_err <= F64_TOL * rhs_scale
        else:
            psi_pass = psi_err < F32_TOL
            rhs_pass = rhs_err < F32_TOL * rhs_scale
        js_pass = all(err <= tol * scale for err, scale in js_errs)
        label = (f"{'float64' if f64 else 'float32'}"
                 f" {'periodic' if periodic else 'real'} {form}")
        log(f"  {label:25s} psi max|err| {psi_err:.3e} (ok agrees:"
            f" {ok_agrees}); rhs max|err| {rhs_err:.3e} (scale"
            f" {rhs_scale:.3e}); J_s form: rhs {js_errs[0][0]:.3e}, J_s"
            f" {js_errs[1][0]:.3e} (scale {js_errs[1][1]:.3e})")
        assert ok_agrees, f"psi kernel ok flag disagrees ({label})"
        assert psi_pass, f"psi kernel disagrees ({label})"
        assert rhs_pass, f"rhs kernel disagrees ({label})"
        assert js_pass, f"rhs kernel's J_s form disagrees ({label})"
        errs["fused_psi_update"][form] = psi_err
        errs["fused_poisson_rhs"][form] = max(rhs_err, *(e for e, _ in
                                                        js_errs))
        cases[form] = dict(ops=ops, sten=sten, U=U, x=x, dt=dt,
                           neumann=neumann)
    return errs, cases


def check_flag_sequence(solver, case):
    """``ok`` through fail, pass, fail, pass calls of one bound operand
    set (a huge dt and mu fail; a tiny dt passes): each agrees with the
    plain version, so the kernel's flag word resets between launches."""
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk

    ops, x = case["ops"], case["x"]
    g, u = solver.cfg.gamma, solver.cfg.u
    seen = []
    for dt, mu_scale in ((50.0, 40.0), (1e-5, 1.0)) * 2:
        args = (x["pr"], x["pi"], mu_scale * x["mu"], x["eps"],
                torch.tensor(dt, dtype=solver.torch_dtype,
                             device=solver.torch_device))
        seen.append((bool(ops.psi_update(g, u, *args)[3]),
                     bool(sk.plain_psi_update(g, u, ops.sten, ops.U,
                                              *args)[3])))
    log(f"  ok flag sequence (kernel, plain): {seen}")
    assert seen == [(False, False), (True, True)] * 2, seen


def time_kernels(solver, cases, cycles_per_ms: float):
    """Device, cold-L2, paced and plain ms of each kernel call in each
    link form, with its bound from shapes and the share of it reached."""
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                        device="cuda")
    plane = cases["factored"]["x"]["pr"]
    src = torch.randn((7,) + tuple(plane.shape), device="cuda")
    dst = torch.empty_like(src)
    floors = (("launch floor: fill of one plane", plane.clone().zero_),
              ("streaming floor: copy of 7 planes into 7",
               lambda: dst.copy_(src)))
    for name, fn in floors:
        warm = queued_ms(fn, 200, cycles_per_ms)
        cold = queued_ms(fn, 200, cycles_per_ms, flush=flush)
        log(f"  {name}: device {warm:.5f} ms (cold L2 {cold:.5f})")
    g, u = solver.cfg.gamma, solver.cfg.u
    out = {"fused_psi_update": {}, "fused_poisson_rhs": {},
           "fused_poisson_rhs (J_s form)": {}}
    for form, c in cases.items():
        ops, x, dt = c["ops"], c["x"], c["dt"]
        psi_in = (x["pr"], x["pi"], x["mu"], x["eps"], dt)
        # The link operands the kernels read: the four factored vectors,
        # or the raw form's ur and ui planes (not its pre-shifted views).
        links = (list(c["U"]) if form == "factored"
                 else [c["U"].ur, c["U"].ui])
        sten = c["sten"]
        calls = {
            "fused_psi_update": (
                lambda: ops.psi_update(g, u, *psi_in),
                lambda: sk.plain_psi_update(g, u, sten, c["U"], *psi_in),
                list(psi_in) + [sten.w, sten.sym_diag, sten.inv_area,
                                sten.fixed_mask, sten.valid] + links,
                ops.psi_update(g, u, *psi_in)),
            "fused_poisson_rhs": (
                lambda: ops.poisson_rhs(x["pr"], x["pi"]),
                lambda: sk.plain_poisson_rhs(sten, c["U"], x["pr"], x["pi"],
                                             x["dA"], c["neumann"]),
                [x["pr"], x["pi"], sten.inv_len, sten.dual, x["dA"],
                 sten.inv_area, c["neumann"]] + links,
                [ops.poisson_rhs(x["pr"], x["pi"])]),
            "fused_poisson_rhs (J_s form)": (
                lambda: ops.poisson_rhs(x["pr"], x["pi"],
                                        with_supercurrent=True),
                lambda: sk.plain_poisson_rhs(sten, c["U"], x["pr"], x["pi"],
                                             x["dA"], c["neumann"],
                                             with_supercurrent=True),
                [x["pr"], x["pi"], sten.inv_len, sten.dual, x["dA"],
                 sten.inv_area, c["neumann"]] + links,
                list(ops.poisson_rhs(x["pr"], x["pi"],
                                     with_supercurrent=True))),
        }
        for name, (kernel, plain, ins, outs) in calls.items():
            bound, by = bound_ms(name, form, ins, list(outs))
            rec = dict(ms=queued_ms(kernel, 200, cycles_per_ms),
                       cold_ms=queued_ms(kernel, 200, cycles_per_ms,
                                         flush=flush),
                       paced_ms=paced_ms(kernel),
                       plain_ms=queued_ms(plain, 1, cycles_per_ms,
                                          repeats=21),
                       bound_ms=bound, bound_by=by)
            rec["bound_share"] = bound / rec["ms"]
            log(f"  float32 {form:8s} {name}: device {rec['ms']:.5f} ms"
                f" (cold L2 {rec['cold_ms']:.5f}), paced"
                f" {rec['paced_ms']:.5f} ms, plain {rec['plain_ms']:.5f}"
                f" ms; bound {bound:.5f} ms ({by}), share"
                f" {100 * rec['bound_share']:.1f}% (cold"
                f" {100 * bound / rec['cold_ms']:.1f}%)")
            out[name][form] = rec
    return out


def time_breakdown(solver, state, steps: int = 100, prof_steps: int = 20,
                   programs=("fast", "robust"), psi_records: bool = True):
    """Where a step's time goes, for the fast and the robust chunk program
    (``programs``) started from ``state``: wall ms per step (3 runs of
    ``steps`` steps), torch ops dispatched per step, and, from
    ``torch.profiler`` over ``prof_steps`` steps, the device kernel time
    per step, its share of the unprofiled wall (median run) and the
    largest kernels. Returns ``{program: {wall_ms, ops, device_ms}}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from torch.utils._python_dispatch import TorchDispatchMode

    from tdgl_tpu_torch.models import gtdgl_stencil as gs
    from tdgl_tpu_torch.ops.step_kernels import StepOperands
    from tdgl_tpu_torch.solver.grid_step import make_grid_chunk_fn

    def profiled(fn):
        """``torch.profiler`` over one ``fn()`` run, after a warm-up run
        under the same profiler (its tracer drops the first records after
        it starts)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        return prof

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    result = {}
    screening = solver._screening
    cfgs = {"fast": solver._fast_cfg, "robust": solver.cfg}
    for name in programs:
        cfg = cfgs[name]
        run = make_grid_chunk_fn(cfg, steps)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(solver.sten, solver.amg, state, screening)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / steps * 1e3)
        short = make_grid_chunk_fn(cfg, prof_steps)
        counter = OpCount()
        with counter:
            short(solver.sten, solver.amg, state, screening)
        torch.cuda.synchronize()
        prof = profiled(lambda: short(solver.sten, solver.amg, state,
                                      screening))
        # Device-side records only (kernels, memsets, copies).
        kernels = sorted(
            ((e.self_device_time_total / prof_steps, e.count / prof_steps,
              e.key) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("ProfilerStep")),
            reverse=True)
        device_ms = sum(k[0] for k in kernels) / 1e3
        busy = 100 * device_ms / statistics.median(walls)
        log(f"  {name}: wall ms/step {', '.join(f'{w:.2f}' for w in walls)};"
            f" torch ops/step {counter.n / prof_steps:.1f}; device kernel"
            f" time {device_ms:.3f} ms/step, {sum(k[1] for k in kernels):.1f}"
            f" device records/step, busy {busy:.1f}% of the median wall")
        for us, count, key in kernels[:8]:
            log(f"    {us:8.2f} us/step x {count:6.1f}  {key[:70]}")
        result[name] = dict(wall_ms=statistics.median(walls),
                            ops=counter.n / prof_steps, device_ms=device_ms)
    if not psi_records:
        return result

    # The psi wrapper's device records, called as the main path calls it.
    ops = StepOperands(solver.sten,
                       gs.factor_link_phases(solver.sten, state.A_applied),
                       state.dA_dt, state.neumann_term)
    calls = 20

    def psi_calls():
        for _ in range(calls):
            ops.psi_update(solver.cfg.gamma, solver.cfg.u, state.psi_r,
                           state.psi_i, state.mu, state.epsilon,
                           state.tentative_dt)

    prof = profiled(psi_calls)
    records = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")}
    others = {k: n for k, n in records.items()
              if "psi_update_kernel" not in k}
    per_call = sum(records.values()) / calls
    log(f"  psi wrapper: {per_call:.2f} device records per call"
        f" ({records}); fill or compare records from it:"
        f" {others or 'none'}")
    assert per_call == 1 and not others, records
    return result


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


class CurrentRamp:
    """Terminal currents ramping from 0 to ``peak`` (into the source, out of
    the drain) over ``t_ramp``, then flat. ``jittable``: on the traced path
    ``t`` is a 0-d tensor on the card and the currents stay there."""

    jittable = True

    def __init__(self, peak: float, t_ramp: float):
        self.peak, self.t_ramp = float(peak), float(t_ramp)

    def __call__(self, t):
        import torch

        current = self.peak * torch.clamp(t / self.t_ramp, 0.0, 1.0)
        return {"source": current, "drain": -current}

    def __eq__(self, other):
        return (type(other) is type(self)
                and (other.peak, other.t_ramp) == (self.peak, self.t_ramp))


class HostCurrentRamp(CurrentRamp):
    """The same ramp as a plain callable of a float ``t`` (the host path:
    evaluated before every step, chunk size 1)."""

    jittable = False

    def __call__(self, t):
        current = self.peak * min(max(float(t) / self.t_ramp, 0.0), 1.0)
        return {"source": current, "drain": -current}


class ChunkLog:
    """While active, wraps ``TDGLSolver._failover_chunk_fn`` (the chunk
    calls of ``solve()`` with failover on): per call, the launches of each
    kernel and the failovers, the launches of each run of the fast program
    (``fast_calls``, committed or not), and the last solver and state."""

    def __enter__(self):
        from tdgl_tpu_torch import TDGLSolver
        from tdgl_tpu_torch.ops import step_kernels as sk

        self.calls, self.fast_calls = [], []
        self.solver, self.state = None, None
        self._orig = orig = TDGLSolver._failover_chunk_fn

        def counted(fast):
            def run(*args):
                before = [fn.launches for fn in sk.KERNELS]
                out = fast(*args)
                self.fast_calls.append(
                    [fn.launches - b for fn, b in zip(sk.KERNELS, before)])
                return out
            return run

        def logged(solver, state):
            if solver is not self.solver:
                solver._fast_chunk_fn = counted(solver._fast_chunk_fn)
            before = [fn.launches for fn in sk.KERNELS]
            failovers = solver._failover_count
            out = orig(solver, state)
            self.calls.append((
                [fn.launches - b for fn, b in zip(sk.KERNELS, before)],
                solver._failover_count - failovers))
            self.solver, self.state = solver, out[0]
            return out

        TDGLSolver._failover_chunk_fn = logged
        return self

    def __exit__(self, *exc):
        from tdgl_tpu_torch import TDGLSolver

        TDGLSolver._failover_chunk_fn = self._orig

    @property
    def slots(self) -> int:
        """Step slots executed: every chunk call, robust re-runs included."""
        chunk = self.solver.chunk_size
        return sum(chunk * (1 + failed) for _, failed in self.calls)


def check_small_dynamic_chunks(pkg):
    """Float64 chunks of 20 steps on the small device, on the card against
    the CPU (plain versions): a traced field and current ramp, and a
    screened chunk in the robust and in the fast program."""
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk

    dev = small_device(pkg)
    base = dict(solve_time=1e9, dt_init=1e-4, adaptive=False, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    screened = dict(base, include_screening=True, screening_tolerance=1e-4,
                    screening_error_norm="global")
    cases = {
        "traced ramp": (base, dict(
            applied_vector_potential=pkg.ConstantField(0.5)
            * pkg.LinearRamp(tmin=0.0, tmax=1e-3),
            terminal_currents=CurrentRamp(3.0, 1e-3))),
        "screened robust": (dict(screened, chunk_failover="off"),
                            dict(applied_vector_potential=0.5)),
        "screened fast": (screened, dict(applied_vector_potential=0.5)),
    }
    for case, (opts, inputs) in cases.items():
        out = {}
        for where in ("cuda", "cpu"):
            solver = pkg.TDGLSolver(dev, pkg.SolverOptions(**opts),
                                    torch_device=where, **inputs)
            sk.reset_launch_counts()
            state = solver._initial_state()
            if case == "screened fast":
                state, outputs, _ = solver._fast_chunk_fn(
                    solver.sten, solver.amg, state, solver._screening)
            else:
                state, outputs, _ = solver.chunk_fn(state)
            out[where] = (state, outputs,
                          [fn.launches for fn in sk.KERNELS])
        (g, g_out, launches), (c, c_out, _) = out["cuda"], out["cpu"]
        rel = {}
        for name in ("psi_r", "psi_i", "mu", "A_induced", "A_applied",
                     "neumann_term"):
            a, b = getattr(g, name).cpu(), getattr(c, name)
            rel[name] = ((a - b).abs().max()
                         / max(b.abs().max().item(), 1e-30)).item()
        its = g_out.screening_iterations.tolist()
        log(f"  {case}: max rel err {max(rel.values()):.3e} ({rel}),"
            f" screening iterations {its}, launches {launches}")
        assert max(rel.values()) < 1e-10, (case, rel)
        assert torch.equal(g_out.screening_iterations.cpu(),
                           c_out.screening_iterations), case
        assert int(g.step) == int(c.step) and launches[1] >= 20, case
        if case == "screened fast":
            # Every slot launches both kernels once, frozen ones included
            # (a cold start trips the fast program's gate).
            assert launches == [20, 20], launches
        else:
            assert int(g.step) == 20, case


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunk", type=int, default=500,
                        help="steps per chunk and per snapshot (phases 6-7)")
    parser.add_argument("--solve-time", type=float, default=19.8,
                        help="simulated time of phases 6-7 (the default"
                        " takes about 2,000 steps)")
    parser.add_argument("--ramp-time", type=float, default=19.8,
                        help="simulated time of phase 9's traced ramp (the"
                        " inputs ramp over its first half)")
    parser.add_argument("--ramp-chunk", type=int, default=500,
                        help="steps per chunk of phase 9")
    parser.add_argument("--screen-time", type=float, default=9.8,
                        help="simulated time of phase 10's screened solve")
    parser.add_argument("--screen-chunk", type=int, default=200,
                        help="steps per chunk of phase 10")
    args = parser.parse_args()

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

    options = dict(solve_time=args.solve_time, dt_init=1e-4, dt_max=1e-2,
                   save_every=args.chunk, field_units="mT",
                   current_units="uA", dtype="float32")
    inputs = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=20.0, drain=-20.0))
    with Phase("device + solver setup"):
        device = bench_device(ttdgl)
        t0 = time.perf_counter()
        solver = ttdgl.TDGLSolver(device, ttdgl.SolverOptions(**options),
                                  torch_device="cuda", **inputs)
        setup_s = time.perf_counter() - t0
        n_sites = len(device.mesh.sites)
        log(f"  {n_sites} sites, grid {solver.maps.shape}, multigrid"
            f" {solver.amg.shapes}, factored links"
            f" {solver.cfg.factor_link_phases}, chunk {solver.chunk_size},"
            f" solver set-up {setup_s:.2f} s")
        assert solver.maps.shape == (256, 384), solver.maps.shape
        assert solver.cfg.factor_link_phases

    with Phase("kernels vs plain versions"):
        state0 = solver._initial_state()
        errs, cases = check_kernels(solver, state0, f64=False)
        periodic_errs, _ = check_kernels(solver, state0, f64=False,
                                         periodic=True)
        check_flag_sequence(solver, cases["factored"])
        timings = time_kernels(solver, cases, sleep_cycles_per_ms())
        small64 = ttdgl.TDGLSolver(
            small_device(ttdgl),
            ttdgl.SolverOptions(solve_time=1e9, dtype="float64",
                                field_units="mT", current_units="uA",
                                factor_link_phases=True),
            applied_vector_potential=0.5,
            terminal_currents=dict(source=3.0, drain=-3.0),
            torch_device="cuda")
        for periodic in (False, True):
            check_kernels(small64, small64._initial_state(), f64=True,
                          periodic=periodic)

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
        check_small_dynamic_chunks(ttdgl)

    with Phase("bare chunk loop"):
        state = solver._initial_state()
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        chunks, cg_iters = 0, []
        while True:
            tc = time.perf_counter()
            before = solver._failover_count
            state, outputs, exported = solver.chunk_fn(state)
            chunks += 1
            diag = exported["diagnostics"].cpu().numpy()
            n_valid = int(outputs.valid.sum())
            cg_iters.append(outputs.cg_iterations.float().mean().item())
            log(f"  chunk {chunks - 1}: {time.perf_counter() - tc:.2f} s,"
                f" failover {solver._failover_count - before}, t ="
                f" {diag[0]:.4f}, dt = {diag[1]:.3e}, mean CG its"
                f" {cg_iters[-1]:.2f}")
            if diag[4] or n_valid < solver.chunk_size:
                break
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        loop_launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
    loop_steps = int(state.step)
    loop_slots = (chunks + solver._failover_count) * solver.chunk_size
    psi_abs = torch.sqrt(state.psi_r**2 + state.psi_i**2)
    psi_sites = solver.maps.grid_to_site(psi_abs.cpu().numpy())
    log(f"  sites {n_sites}, {loop_steps} steps in {chunks} chunks,"
        f" {loop_slots} step slots executed (robust re-runs included),"
        f" {loop_s:.2f} s = {loop_steps / loop_s:.2f} steps/s"
        f" ({loop_steps / (loop_s + setup_s):.2f} with the"
        f" {setup_s:.2f} s solver set-up), failovers"
        f" {solver._failover_count}, mean CG its {np.mean(cg_iters):.3f},"
        f" |psi| in [{psi_sites.min():.4f}, {psi_sites.max():.4f}],"
        f" launches {loop_launches}")
    assert not bool(state.failed) and bool(state.done)
    for name in ("psi_r", "psi_i", "mu", "supercurrent", "normal_current"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    assert tuple(state.psi_r.shape) == (256, 384)
    assert loop_launches["fused_psi_update"] >= loop_slots
    assert loop_launches["fused_poisson_rhs"] == loop_slots

    with Phase("solve() through the Runner"), \
            tempfile.TemporaryDirectory() as tmp:
        from tdgl_tpu_torch.solver.runner import DataHandler

        path = os.path.join(tmp, "solve.h5")
        # Where solve()'s wall goes: solver set-up, chunks (device steps
        # and the failover read), snapshot and checkpoint writes, and the
        # Solution's load and group; the rest is the mesh and fixed
        # arrays, the Runner's reads from the device and grid-to-mesh
        # conversion.
        spans = {"set-up": [], "chunks": [], "writes": [], "Solution": []}
        restores = [
            timed_calls(ttdgl.TDGLSolver, ("__init__",), spans["set-up"]),
            timed_calls(ttdgl.TDGLSolver, ("_failover_chunk_fn",),
                        spans["chunks"]),
            timed_calls(DataHandler, ("save_time_step", "save_checkpoint"),
                        spans["writes"]),
            timed_calls(ttdgl.Solution, ("__init__", "to_hdf5"),
                        spans["Solution"]),
        ]
        solver_log = logging.getLogger("solver")
        failovers = FailoverCount()
        level = solver_log.level
        solver_log.setLevel(logging.INFO)
        solver_log.addHandler(failovers)
        try:
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            solution = ttdgl.solve(
                device, ttdgl.SolverOptions(output_file=path, **options),
                torch_device="cuda", **inputs)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
        finally:
            for restore in restores:
                restore()
            solver_log.removeHandler(failovers)
            solver_log.setLevel(level)
        file_bytes = os.path.getsize(solution.path)
        t0 = time.perf_counter()
        reread = ttdgl.Solution.from_hdf5(solution.path)
        same = reread.equals(solution)
        read_s = time.perf_counter() - t0
        dyn = solution.dynamics
        snapshots = solution.data_range[1]
        solve_steps = int(solution.tdgl_data.state["step"])
        solve_slots = (snapshots + failovers.n) * solver.chunk_size
        psi_abs = np.abs(solution.tdgl_data.psi)
        moment = solution.magnetic_moment()
        voltage = dyn.mean_voltage()
    log(f"  solve(): {solve_steps} steps ({len(dyn.dt)} recorded dt),"
        f" {solve_s:.2f} s wall = {solve_steps / solve_s:.2f} steps/s"
        f" (bare chunk loop, phase 6: {loop_steps / loop_s:.2f} steps/s,"
        f" {loop_steps / (loop_s + setup_s):.2f} with its set-up); solve()"
        f" wall - bare loop - set-up: {solve_s - loop_s - setup_s:.2f} s")
    span_s = {name: sum(v) for name, v in spans.items()}
    log(f"  snapshots {snapshots} after step 0, failovers {failovers.n},"
        f" {solve_slots} step slots executed; snapshot writes (snapshot +"
        f" checkpoint) {len(spans['writes'])} calls,"
        f" {span_s['writes']:.3f} s in all,"
        f" {span_s['writes'] / max(snapshots, 1):.4f} s per snapshot; file"
        f" {file_bytes} bytes; re-read {read_s:.2f} s")
    log(f"  solve() wall {solve_s:.3f} s: "
        + ", ".join(f"{name} {sec:.3f} s" for name, sec in span_s.items())
        + ", rest (mesh and fixed arrays, device reads, grid-to-mesh"
        f" conversion) "
        f"{solve_s - sum(span_s.values()):.3f} s")
    log(f"  mean probe voltage {voltage:.6g} V0, magnetic moment"
        f" {moment.magnitude:.6g} {moment.units}, |psi| in [{psi_abs.min():.4f},"
        f" {psi_abs.max():.4f}], launches {launches},"
        f" Solution.from_hdf5(path).equals(solution): {same}")
    assert same
    assert np.isfinite(psi_abs).all() and np.isfinite(dyn.mu).all()
    assert np.isfinite(voltage) and np.isfinite(moment.magnitude)
    assert len(dyn.dt) == solve_steps and snapshots >= 2
    assert launches["fused_psi_update"] >= solve_slots
    assert launches["fused_poisson_rhs"] == solve_slots

    with Phase("where the time goes (from phase 6's final state)"):
        phase8 = time_breakdown(solver, state._replace(
            end_time=torch.full_like(state.time, 1e9),
            done=torch.zeros_like(state.done)))

    with Phase("traced ramp through solve()"), \
            tempfile.TemporaryDirectory() as tmp:
        t_ramp = args.ramp_time / 2
        ramp_inputs = dict(
            applied_vector_potential=ttdgl.ConstantField(0.5)
            * ttdgl.LinearRamp(tmin=0.0, tmax=t_ramp),
            terminal_currents=CurrentRamp(20.0, t_ramp))
        ramp_opts = dict(options, solve_time=args.ramp_time,
                         save_every=args.ramp_chunk)
        with ChunkLog() as ramp_log:
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            ramp_sol = ttdgl.solve(
                device, ttdgl.SolverOptions(
                    output_file=os.path.join(tmp, "ramp.h5"), **ramp_opts),
                torch_device="cuda", **ramp_inputs)
            torch.cuda.synchronize()
            ramp_s = time.perf_counter() - t0
            ramp_launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
        ramp_solver = ramp_log.solver
        ramp_same = ttdgl.Solution.from_hdf5(ramp_sol.path).equals(ramp_sol)
        ramp_steps = int(ramp_sol.tdgl_data.state["step"])
        ramp_slots = ramp_log.slots
        ramp_failovers = sum(f for _, f in ramp_log.calls)
        dyn = ramp_sol.dynamics
        chunk = ramp_solver.chunk_size
        volts = dyn.voltage()
        last = (len(volts) - 1) // chunk * chunk
        v_first = float(np.average(volts[:chunk], weights=dyn.dt[:chunk]))
        v_last = float(np.average(volts[last:], weights=dyn.dt[last:]))
        log(f"  traced ramp: {ramp_steps} steps in {len(ramp_log.calls)}"
            f" chunks of {chunk}, {ramp_slots} step slots, failovers"
            f" {ramp_failovers}, {ramp_s:.2f} s wall ="
            f" {ramp_steps / ramp_s:.2f} steps/s (phase 7, static inputs:"
            f" {solve_steps / solve_s:.2f} steps/s); launches"
            f" {ramp_launches}; mean probe voltage {v_first:.6g} V0 over"
            f" the first chunk, {v_last:.6g} V0 over the last;"
            f" Solution.from_hdf5(path).equals(solution): {ramp_same}")
        assert chunk > 1 and not ramp_solver.host_dynamic
        assert ramp_solver.cfg.A_fn is not None
        assert ramp_solver.cfg.mu_boundary_fn is not None
        assert ramp_same and np.isfinite(volts).all()
        assert ramp_launches["fused_poisson_rhs"] == ramp_slots
        assert ramp_launches["fused_psi_update"] >= ramp_slots
        ramp_state = ramp_log.state._replace(
            end_time=torch.full_like(ramp_log.state.time, 1e9),
            done=torch.zeros_like(ramp_log.state.done))
        ramp_breakdown = time_breakdown(ramp_solver, ramp_state,
                                        programs=("fast",),
                                        psi_records=False)

        # The host path: a plain callable, evaluated before every step.
        host_opts = dict(options, solve_time=0.05, adaptive=False,
                         dt_init=1e-3, save_every=50)
        with ChunkLog() as host_log:
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            host_sol = ttdgl.solve(
                device, ttdgl.SolverOptions(
                    output_file=os.path.join(tmp, "host.h5"), **host_opts),
                torch_device="cuda", applied_vector_potential=0.5,
                terminal_currents=HostCurrentRamp(20.0, 0.05))
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            host_launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
        host_steps = int(host_sol.tdgl_data.state["step"])
        log(f"  host path: {host_steps} steps, chunk size"
            f" {host_log.solver.chunk_size}, {host_log.slots} step slots,"
            f" {host_s:.2f} s wall = {host_steps / host_s:.2f} steps/s;"
            f" launches {host_launches}")
        assert host_log.solver.host_dynamic
        assert host_log.solver.chunk_size == 1 and host_steps >= 45
        assert host_launches["fused_poisson_rhs"] == host_log.slots
        assert np.isfinite(host_sol.tdgl_data.psi).all()

    with Phase("screening through solve()"), \
            tempfile.TemporaryDirectory() as tmp:
        from tdgl_tpu_torch.ops import fft_screening as fs

        scr_opts = dict(options, solve_time=args.screen_time,
                        save_every=args.screen_chunk,
                        include_screening=True, screening_tolerance=1e-3,
                        screening_kernel="fft", screening_solver="anderson")
        with ChunkLog() as scr_log:
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            scr_sol = ttdgl.solve(
                device, ttdgl.SolverOptions(
                    output_file=os.path.join(tmp, "screened.h5"),
                    **scr_opts),
                torch_device="cuda", applied_vector_potential=0.5)
            torch.cuda.synchronize()
            scr_s = time.perf_counter() - t0
            scr_launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
        scr_solver = scr_log.solver
        chunk = scr_solver.chunk_size
        scr_steps = int(scr_sol.tdgl_data.state["step"])
        scr_failovers = sum(f for _, f in scr_log.calls)
        fast_calls = scr_log.fast_calls
        committed = sum(1 for _, failed in scr_log.calls if not failed)
        scr_same = ttdgl.Solution.from_hdf5(scr_sol.path).equals(scr_sol)
        scr_its = np.asarray(scr_sol.dynamics.screening_iterations)
        scr_moment = scr_sol.magnetic_moment()
        a_ind = np.abs(scr_sol.tdgl_data.induced_vector_potential).max()
        log(f"  screened: {scr_steps} steps in {len(scr_log.calls)} chunks"
            f" of {chunk}, {scr_log.slots} step slots, failovers"
            f" {scr_failovers}, {scr_s:.2f} s wall ="
            f" {scr_steps / scr_s:.2f} steps/s; mean screening iterations"
            f" per recorded step {scr_its.mean():.3f}; launches"
            f" {scr_launches} ="
            f" {scr_launches['fused_psi_update'] / scr_log.slots:.3f} psi"
            f" and {scr_launches['fused_poisson_rhs'] / scr_log.slots:.3f}"
            f" RHS per slot; launches of each fast-program run"
            f" {fast_calls} ({committed} committed);"
            f" magnetic moment {scr_moment.magnitude:.6g} {scr_moment.units}"
            f" (phase 7, unscreened with 20 uA: {moment.magnitude:.6g});"
            f" max |A_induced| {a_ind:.4g}; Solution.from_hdf5(path)"
            f".equals(solution): {scr_same}")
        assert scr_solver.cfg.include_screening
        assert scr_solver.cfg.screening_use_fft
        assert scr_solver._fast_cfg.screening_site_eval
        assert scr_same and a_ind > 0
        assert np.isfinite(scr_sol.tdgl_data.psi).all()
        assert np.isfinite(scr_moment.magnitude)
        # Every run of the fast program, committed or rewound, launches
        # each kernel exactly once per step slot.
        assert len(fast_calls) == len(scr_log.calls)
        for launches_c in fast_calls:
            assert launches_c == [chunk, chunk], launches_c
        assert scr_launches["fused_poisson_rhs"] >= scr_log.slots
        scr_state = scr_log.state._replace(
            end_time=torch.full_like(scr_log.state.time, 1e9),
            done=torch.zeros_like(scr_log.state.done))
        scr_breakdown = time_breakdown(scr_solver, scr_state, steps=20,
                                       prof_steps=10, psi_records=False)
        # One induced-potential evaluation, exact per-class and site-
        # evaluated, on a seeded current.
        rng = np.random.default_rng(11)
        valid = np.asarray(scr_solver.host_sten.valid)[..., None]
        Jw = torch.tensor(rng.normal(size=valid.shape[:2] + (2,)) * valid,
                          dtype=torch.float32, device="cuda")
        fft_data = scr_solver._screening[1]
        cycles = sleep_cycles_per_ms()
        induced_ms = {
            "exact": queued_ms(lambda: fs.induced_vector_potential_fft(
                fft_data, scr_solver.sten, Jw), 20, cycles, repeats=5),
            "site": queued_ms(lambda: fs.induced_vector_potential_fft_site(
                fft_data, scr_solver.sten, Jw, scr_solver._site_taps), 4,
                cycles, repeats=5),
        }
        log(f"  one induced-potential evaluation: exact per-class"
            f" {induced_ms['exact']:.4f} ms, site-evaluated"
            f" {induced_ms['site']:.4f} ms (device, queued)")

    smi_after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"gpu after: {smi_after}")

    # Launches on the driven paths: phase 7 (static inputs), phase 9 (the
    # traced ramp and the host path) and phase 10 (screening), each
    # counted from 0 just before its solve() and read just after.
    by_path = {"static solve()": launches, "traced ramp": ramp_launches,
               "host path": host_launches, "screened": scr_launches}
    slots_by_path = {"static solve()": solve_slots,
                     "traced ramp": ramp_slots, "host path": host_log.slots,
                     "screened": scr_log.slots}

    def record(name, source, replaces):
        fac = timings[name]["factored"]
        rec = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(path[name] for path in by_path.values()),
            max_abs_err=max(*errs[name].values(),
                            *periodic_errs[name].values()),
            ms=fac["ms"], plain_ms=fac["plain_ms"],
            bound_ms=fac["bound_ms"], bound_by=fac["bound_by"],
            library_ms=None, bound_share=fac["bound_share"],
            launches_by_path={k: v[name] for k, v in by_path.items()},
            step_slots_by_path=slots_by_path,
            chunk_loop_launches=loop_launches[name],
            cold_ms=fac["cold_ms"], paced_ms=fac["paced_ms"],
            raw_ms=timings[name]["raw"]["ms"],
        )
        if name == "fused_poisson_rhs":
            # The J_s-writing form, in the raw link form that the screened
            # step launches (factored after the slash in PERF.md).
            js = timings["fused_poisson_rhs (J_s form)"]
            rec.update(js_ms=js["raw"]["ms"],
                       js_plain_ms=js["raw"]["plain_ms"],
                       js_bound_ms=js["raw"]["bound_ms"],
                       js_bound_share=js["raw"]["bound_share"],
                       js_factored_ms=js["factored"]["ms"],
                       js_factored_bound_ms=js["factored"]["bound_ms"])
        return rec

    kernels = [
        record("fused_psi_update", "tdgl_tpu_torch/csrc/psi_update.cu",
               "tdgl_tpu/ops/pallas_step.py:61"),
        record("fused_poisson_rhs", "tdgl_tpu_torch/csrc/poisson_rhs.cu",
               "tdgl_tpu/ops/pallas_step.py:162"),
    ]
    log(json.dumps({"breakdown": {"static": phase8, "traced ramp":
                                  ramp_breakdown, "screened": scr_breakdown},
                    "induced_ms": induced_ms}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
