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
   1,000 steps), one host read per chunk, nothing written; static 0.5 mT
   field and 20 uA source current, screening off;
7. ``tdgl_tpu_torch.solve()`` on the same device with the same options
   (the package's entry point: the same chunks, plus the Runner's
   snapshots, checkpoints and the output file), its ``Solution`` read back
   with ``Solution.from_hdf5``; the difference from phase 6 is the
   Runner's cost;
8. where a step's time goes, from phase 6's final state: wall time
   (median of 3 runs of 50 steps), torch ops and device kernel time per
   step (``torch.profiler``), for
   the fast and the robust program, and the device records of one psi
   wrapper call (one kernel, no fill or compare);
9. a traced ramp through ``solve()``: the applied field ramps as
   ``ConstantField(0.5) * LinearRamp`` and a ``jittable`` source current
   from 0 to 20 uA over the first half of ``--ramp-time`` (about 300
   steps in chunks of 500, inputs evaluated on the card inside the
   chunk), its steps/s beside phase 7's, the fast step's ops and device
   time, and the mean probe voltage over the first and the last chunk;
   then the host path: the same current as a plain callable, evaluated
   before every step (chunk size 1, about 50 steps);
10. screening through ``solve()`` at ``bench.py``'s screened operating
    point (0.5 mT, tolerance 1e-3, the fft kernel, Anderson, the fast
    program with site evaluation and failover; about 130 steps in chunks
    of 100): steps/s, failovers, screening iterations, launches per step
    slot (exactly one of each kernel in every committed fast chunk), the
    fast and robust screened step's ops and device time, and the device ms
    of one induced-potential evaluation (exact and site-evaluated);
11. the unstructured (ELL) backend at full width: the same film meshed
    with the default Delaunay mesher (~50,800 sites), the same terminals,
    probes, field, current and float32 options, AMG-preconditioned CG:
    the mesher's, operators' and AMG's set-up seconds, the bare chunk loop
    and ``solve()`` (about 1,000 steps each in chunks of 200; steps/s,
    mean CG iterations, Euler retries, host reads per step), the current
    through the film's vertical centre line on the final snapshot (within
    10% of 20 uA), ops, device time and busy share per step, the device
    ms of one ELL scalar-Laplacian apply, covariant-Laplacian apply and
    AMG V-cycle against their bytes bounds, and a screened run (0.5 mT,
    the pairwise ``xla`` kernel, Anderson, 10 steps: the dt jump at step
    12 and its 121-iteration burst lie past them) with the device ms of
    one pairwise induced-potential evaluation. The two CUDA kernels'
    launch counters must read 0 throughout: the ELL step has no kernel of
    its own (the JAX package's ELL path has no Pallas kernel).

12. checkpoint resume and seed solutions through ``solve()`` on both
    backends at full width (the structured film of phases 6-7 and the
    Delaunay film of phase 11, the same static inputs and float32
    options, chunks of ``--resume-chunk``): an uninterrupted run to
    ``--resume-time``, a run to half of it, and that run resumed from its
    file's ``checkpoint`` group to the end; the resumed final state must
    equal the uninterrupted one bit for bit (psi, mu, step, time, dt).
    Then a 100-step run (fixed dt 1e-3) seeded from the uninterrupted
    solution, whose step-0 snapshot must equal the seed's final psi. It
    prints the checkpoint's step, time and size, each run's steps/s,
    failovers (the first step of each rewound chunk) and seconds spent
    writing checkpoints, and max |dpsi| and |dmu| between the final
    states; the resumed and seeded structured runs launch each kernel once
    per step slot (psi more only on robust retries), the ELL runs neither.

13. batched parameter sweeps (``tdgl_tpu_torch.parallel.solve_sweep``, one
    batch of members on the card): both kernels at 8 members in one
    launch on the (256, 384) film, float32 and float64, raw and factored
    links, each member against the plain version on its own inputs; a
    1-member batch equal bit for bit to a single call; ``ok`` per member
    (members 1 and 5 fail, then all pass); the batched kernels' device
    ms against 8 single calls and their bytes bound. Then 8-member field
    and callable-bias current sweeps on the structured film (float32, the
    robust program, ``--sweep-steps`` steps per member in chunks of
    ``--sweep-chunk``) and the same sweeps at 1 member over the same
    steps: members x steps/s, launches and host reads per step slot, no
    member failed; away from the terminals, ``|psi|`` min < 0.9 on the
    strongest member and its mean ``|psi|^2`` below the weakest's; the
    final voltage growing with the bias (the strongest member's above
    twice the weakest's, as ``tests/test_parallel.py`` checks), with
    members 1, 2 and 7 each run alone as witnesses that each member runs
    its own bias (voltage traces within ``WITNESS_RTOL`` over the first
    ``WITNESS_STEPS`` steps; later they part, as rounding grows in the
    film's phase-slip regime, so neighbouring final voltages may cross); a
    float64 3-member
    sweep on the small
    film against single robust runs (``chunk_failover="off"``) to 1e-10
    with equal step counts; and an 8-member ELL field sweep on the
    Delaunay film of phase 11 (``--sweep-ell-steps`` steps) with its
    members x steps/s and host reads per step (no kernel launches).

Phase 5 also holds float64 ELL chunks on a small Delaunay mesh on the card
against the CPU (static, traced ramp, screened ``xla``; 1e-10, equal step,
retry, CG and screening iteration counts) and runs a float32 ELL chunk
twice (bitwise equal).

14. screened sweeps (``solve_sweep`` with ``include_screening``): the two
    kernel forms a screened batch launches (the RHS kernel writing J_s,
    ``(B, 3, rows, cols)``, and the psi kernel with a ``|psi|^2`` plane,
    ``(B, rows, cols)``) at 8 members with per-member links, raw and
    factored, float32 and float64, each member against the plain version,
    B = 1 bit for bit equal to a single call, and their device ms against
    their bytes bound; an 8-member screened field sweep on the structured
    film at phase 10's operating point (the robust program, the exact FFT
    convolution, ``--screen-sweep-steps`` steps in chunks of
    ``--screen-sweep-chunk``) and a 1-member one at scale 1.0 over the
    same steps: members x steps/s, fixed-point iterations per step and
    member, both kernels launched exactly once per fixed-point iteration
    of the batch (psi more only on retries), no member failed (a failed
    member must fail alone at the same step), members 1 and 7 each run
    alone as witnesses (probe phase traces within ``WITNESS_RTOL`` over
    the ``SCREEN_WITNESS_STEPS`` steps before the dt jump); a float64
    3-member screened sweep on the small film against single robust runs
    (1e-10, equal steps and screening iterations); an 8-member and a
    1-member screened field sweep on the Delaunay film (the pairwise
    ``xla`` kernel, ``--screen-sweep-ell-steps`` steps, host reads per
    slot, no kernel launch) and one pairwise evaluation's device ms at 8
    members and at 1.

15. post-processing and visualization on the card's output: a
    ``solve()`` of the structured film (phase 7's options and inputs,
    ``--post-time`` of simulated time, about 300 steps, snapshots every
    ``--post-chunk`` steps) while a separate process that imports only
    ``tdgl_tpu_torch`` polls the run's ``.h5.tmp`` side file through
    h5lite and ``visualization.io`` every 0.5 s (it must see at least two
    distinct steps, a finite psi of every site and ``solution/device``;
    the side file must be gone when ``solve()`` returns), with the
    seconds per snapshot write and the in-place side-file share;
    ``get_plot_data`` for every ``Quantity`` on the finished file equal
    to the ``Solution``'s own arrays; ``convert_to_xdmf`` read back
    through h5lite (one frame per snapshot); the wall seconds of eight
    ``Solution`` post-processing methods at full width, with the current
    through the centre line within 10% of the 20 uA bias; and, where
    matplotlib is installed, one rendered snapshot (else one line saying
    it is not).

Phases 6, 7, 9, 10, 12, 13, 14 and 15 each reset the kernels' launch
counters just before each of their runs and read them just after; each
count must match the step slots that run executed (chunks times chunk
size, robust re-runs included), or in phase 14 the fixed-point iterations
of the batch. The last two stdout lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Usage: ``python3 chip_smoke.py`` (one
GPU); ``--chunk`` and ``--solve-time`` resize phases 6 and 7,
``--ramp-time``/``--ramp-chunk`` phase 9, ``--screen-time``/
``--screen-chunk`` phase 10, ``--ell-time``/``--ell-chunk``/
``--ell-screen-steps`` phase 11, ``--resume-time``/``--resume-chunk``
phase 12, ``--sweep-steps``/``--sweep-chunk``/``--sweep-ell-steps`` phase
13, ``--screen-sweep-steps``/``--screen-sweep-chunk``/
``--screen-sweep-ell-steps`` phase 14, ``--post-time``/``--post-chunk``
phase 15.
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
# Phase 13's current-sweep witnesses (float32, one member alone against
# the same member in the batch): their voltage traces over the first
# WITNESS_STEPS steps, relative to the largest |voltage| alone. Members
# 1 and 2 differ in bias by half, and their traces by far more than this.
WITNESS_STEPS = 20
WITNESS_RTOL = 1e-2
# Phase 14's screened witnesses compare the probe phases over the steps
# before the adaptive dt first leaves dt_init (it jumps 100-fold at step
# 12): at the jump the screening fixed point exits at its tolerance on a
# path that float32 rounding differences (the multigrid's coarse solve is
# one matmul for a batch, a matvec alone) already choose, and the probe
# phases of batched and single runs part.
SCREEN_WITNESS_STEPS = 12

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


def bench_device(pkg, target_sites: int = 50_000, structured: bool = True):
    """The benchmark film (``bench.build_device``), built with the port,
    with a source and a drain terminal on its left and right edges and
    two probe points at +-side/4 (the terminals do not change the mesh);
    on the structured lattice, or (``structured=False``) with the default
    Delaunay mesher (the unstructured backend's film)."""
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
                     structured=structured)
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


def device_records(fn):
    """``(device us, count, name)`` of each device record class (kernels,
    memsets, copies) of one ``fn()`` run under ``torch.profiler``, after a
    warm-up run under the same profiler (its tracer drops the first
    records after it starts), largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")), reverse=True)


def count_ops(fn) -> int:
    """Torch ops dispatched by one ``fn()`` call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counter = OpCount()
    with counter:
        fn()
    return counter.n


def profile_steps(name, run, prof_steps, walls):
    """Torch ops, device kernel time and device busy share per step of
    ``run()`` (``prof_steps`` steps), beside ``walls`` (unprofiled wall ms
    per step); logs the largest kernel classes and returns
    ``{wall_ms, ops, device_ms, busy}``."""
    import torch

    ops = count_ops(run) / prof_steps
    torch.cuda.synchronize()
    kernels = [(us / prof_steps, count / prof_steps, key)
               for us, count, key in device_records(run)]
    device_ms = sum(k[0] for k in kernels) / 1e3
    busy = 100 * device_ms / statistics.median(walls)
    log(f"  {name}: wall ms/step {', '.join(f'{w:.2f}' for w in walls)};"
        f" torch ops/step {ops:.1f}; device kernel"
        f" time {device_ms:.3f} ms/step, {sum(k[1] for k in kernels):.1f}"
        f" device records/step, busy {busy:.1f}% of the median wall")
    for us, count, key in kernels[:8]:
        log(f"    {us:8.2f} us/step x {count:6.1f}  {key[:70]}")
    return dict(wall_ms=statistics.median(walls), ops=ops,
                device_ms=device_ms, busy=busy / 100)


def time_breakdown(solver, state, steps: int = 100, prof_steps: int = 20,
                   programs=("fast", "robust"), psi_records: bool = True):
    """Where a step's time goes, for the fast and the robust chunk program
    (``programs``) started from ``state``: wall ms per step (3 runs of
    ``steps`` steps), torch ops dispatched per step, and, from
    ``torch.profiler`` over ``prof_steps`` steps, the device kernel time
    per step, its share of the unprofiled wall (median run) and the
    largest kernels. Returns ``{program: {wall_ms, ops, device_ms}}``."""
    import torch

    from tdgl_tpu_torch.models import gtdgl_stencil as gs
    from tdgl_tpu_torch.ops.step_kernels import StepOperands
    from tdgl_tpu_torch.solver.grid_step import make_grid_chunk_fn

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
        result[name] = profile_steps(
            name, lambda: short(solver.sten, solver.amg, state, screening),
            prof_steps, walls)
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

    # The tracer can drop records (one H100 call saw 13 of 20 psi kernels
    # while the launch counter read 20): profile again, up to three times,
    # while it reports fewer records than calls. More than one record per
    # call, or any other record, fails at once.
    for _ in range(3):
        records = {key: count
                   for _, count, key in device_records(psi_calls)}
        others = {k: n for k, n in records.items()
                  if "psi_update_kernel" not in k}
        per_call = sum(records.values()) / calls
        log(f"  psi wrapper: {per_call:.2f} device records per call"
            f" ({records}); fill or compare records from it:"
            f" {others or 'none'}")
        if per_call >= 1 or others:
            break
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


def small_ell_device(pkg):
    """The small film of :func:`small_device` on the default (Delaunay)
    mesh: the unstructured (ELL) backend."""
    layer = pkg.Layer(coherence_length=1.0, london_lambda=2.0,
                      thickness=0.1, conductivity=10.0)
    film = pkg.Polygon("film", points=pkg.box(14, 8)).resample(200)
    hole = pkg.Polygon("hole", points=pkg.circle(1.0, center=(2, 1)))
    source = pkg.Polygon("source", points=pkg.box(1, 6, center=(-7, 0)))
    drain = pkg.Polygon("drain", points=pkg.box(1, 6, center=(7, 0)))
    device = pkg.Device("small_ell", layer=layer, film=film, holes=[hole],
                        terminals=[source, drain],
                        probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=700)
    return device


class EulerCalls:
    """While active, counts the ELL step's psi updates
    (``models.gtdgl.implicit_euler_psi`` calls): one per step, or per
    screening fixed-point iteration, plus one per discriminant retry."""

    def __enter__(self):
        from tdgl_tpu_torch.models import gtdgl

        self.n = 0
        self._orig = orig = gtdgl.implicit_euler_psi

        def counted(*args, **kwargs):
            self.n += 1
            return orig(*args, **kwargs)

        gtdgl.implicit_euler_psi = counted
        return self

    def __exit__(self, *exc):
        from tdgl_tpu_torch.models import gtdgl

        gtdgl.implicit_euler_psi = self._orig


class HostReads:
    """While active, counts reads of a tensor's value on the card by the
    host (``bool()``, ``int()``, ``float()``, ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` of a CUDA tensor): each waits for the card."""

    NAMES = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu",
             "numpy")

    def __enter__(self):
        import torch

        self.n = 0
        self._saved = {name: torch.Tensor.__dict__.get(name)
                       for name in self.NAMES}

        def counted(name):
            base = getattr(torch.Tensor, name)

            def read(tensor, *args, **kwargs):
                if tensor.is_cuda:
                    self.n += 1
                return base(tensor, *args, **kwargs)
            return read

        for name in self.NAMES:
            setattr(torch.Tensor, name, counted(name))
        return self

    def __exit__(self, *exc):
        import torch

        for name, fn in self._saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


def check_small_ell_chunks(pkg):
    """Float64 ELL chunks of 20 steps on a small Delaunay mesh with
    terminals, on the card against the CPU (1e-10 relative; equal step,
    retry, CG and screening iteration counts): static inputs with the
    adaptive dt, a traced field and current ramp, and a screened (``xla``)
    chunk; none launches a CUDA step kernel. Then a float32 chunk twice on
    the card: bitwise equal."""
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk

    dev = small_ell_device(pkg)
    base = dict(solve_time=1e9, dt_init=1e-3, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    static = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=3.0, drain=-3.0))
    cases = {
        "ELL static": (base, static),
        "ELL traced ramp": (base, dict(
            applied_vector_potential=pkg.ConstantField(0.5)
            * pkg.LinearRamp(tmin=0.0, tmax=1e-2),
            terminal_currents=CurrentRamp(3.0, 1e-2))),
        "ELL screened (xla)": (dict(
            base, dt_init=1e-4, adaptive=False, include_screening=True,
            screening_tolerance=1e-4, screening_error_norm="global"),
            dict(applied_vector_potential=0.5)),
    }
    for case, (opts, inputs) in cases.items():
        out = {}
        for where in ("cuda", "cpu"):
            solver = pkg.TDGLSolver(dev, pkg.SolverOptions(**opts),
                                    torch_device=where, **inputs)
            assert not solver.structured
            sk.reset_launch_counts()
            with EulerCalls() as calls:
                state, outputs, _ = solver.chunk_fn(solver._initial_state())
            out[where] = (state, outputs, calls.n,
                          [fn.launches for fn in sk.KERNELS])
        (g, g_out, g_calls, launches), (c, c_out, c_calls, _) = (
            out["cuda"], out["cpu"])
        rel = {}
        for name in ("psi", "mu", "supercurrent", "normal_current",
                     "A_induced", "A_applied", "mu_boundary"):
            a, b = getattr(g, name).cpu(), getattr(c, name)
            rel[name] = ((a - b).abs().max()
                         / max(b.abs().max().item(), 1e-30)).item()
        its = g_out.screening_iterations.tolist()
        psi_updates = max(sum(its), int(g.step))
        log(f"  {case}: max rel err {max(rel.values()):.3e} ({rel}), steps"
            f" {int(g.step)}, psi updates {g_calls} (retries"
            f" {g_calls - psi_updates}), CG iterations"
            f" {g_out.cg_iterations.tolist()}, screening iterations {its},"
            f" CUDA kernel launches {launches}")
        assert max(rel.values()) < 1e-10, (case, rel)
        assert int(g.step) == int(c.step) == 20, case
        assert g_calls == c_calls, (case, g_calls, c_calls)
        for field in ("cg_iterations", "screening_iterations", "valid"):
            assert torch.equal(getattr(g_out, field).cpu(),
                               getattr(c_out, field)), (case, field)
        assert launches == [0, 0], (case, launches)
    solver = pkg.TDGLSolver(dev, pkg.SolverOptions(**dict(
        base, dtype="float32")), torch_device="cuda", **static)
    start = solver._initial_state()
    runs = [solver.chunk_fn(start)[0] for _ in range(2)]
    same = all(torch.equal(getattr(runs[0], name), getattr(runs[1], name))
               for name in ("psi", "mu", "supercurrent", "normal_current",
                            "tentative_dt"))
    log(f"  ELL float32 chunk twice on the card: bitwise equal {same}")
    assert same


def ell_breakdown(solver, state, steps: int = 100, prof_steps: int = 20):
    """Where an ELL step's time goes, from ``state``: wall ms per step (3
    runs of ``steps`` steps), torch ops, device kernel time and busy share
    per step (``torch.profiler`` over ``prof_steps`` steps), host reads
    and psi updates per step."""
    import torch

    from tdgl_tpu_torch.solver.step import make_chunk_fn

    run = make_chunk_fn(solver.cfg, steps)
    args = (solver.op, solver._screening, solver.amg, state)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / steps * 1e3)
    short = make_chunk_fn(solver.cfg, prof_steps)
    with HostReads() as reads, EulerCalls() as calls:
        _, outputs, _ = short(*args)
    rec = profile_steps("ELL step", lambda: short(*args), prof_steps, walls)
    rec.update(host_reads=reads.n / prof_steps,
               psi_updates=calls.n / prof_steps,
               cg_its=float(outputs.cg_iterations.float().mean()))
    log(f"  ELL step: {rec['host_reads']:.2f} host reads, "
        f"{rec['psi_updates']:.2f} psi updates and {rec['cg_its']:.2f} CG"
        f" iterations per step over the profiled window")
    return rec


def time_ell_applies(solver, state, cycles_per_ms: float):
    """Device ms per call of one ELL scalar-Laplacian apply, one
    covariant-Laplacian apply and one AMG V-cycle at the film's shapes
    (queued CUDA events; the call counts keep each run of calls, ~5, ~25
    and ~26 kernels per call, inside CUDA's launch queue), each beside
    its bytes bound at the HBM rate:
    each input read once (the index tables as stored, int64) and the
    output written once."""
    import numpy as np
    import torch

    from tdgl_tpu_torch.models import gtdgl
    from tdgl_tpu_torch.ops.amg import make_amg_apply

    op, amg = solver.op, solver.amg
    n, k = op.nbr_site.shape
    e = op.edges.shape[0]
    nc, m = amg.members.shape
    rng = np.random.default_rng(13)
    f32 = dict(dtype=torch.float32, device=solver.torch_device)
    x = torch.tensor(rng.normal(size=n), **f32)
    psi = torch.tensor(rng.normal(size=(n, 2)) * 0.5, **f32)
    U = gtdgl.edge_link_phases(state.A_applied, op.edge_directions)
    apply_amg = make_amg_apply(solver.cfg.amg_omega)

    def apply_A(v):
        return -gtdgl.scalar_laplacian_sym(op, v)

    f, i = 4, 8   # bytes of a float32 value and of an int64 index
    applies = {
        # x, nbr_site, w_sym, w_sym_rowsum in; S x out.
        "scalar_laplacian_sym": (
            lambda: gtdgl.scalar_laplacian_sym(op, x), 100,
            f * n + i * n * k + f * n * k + f * n + f * n),
        # U, psi, nbr_edge, nbr_sign, nbr_site, w_lap, w_lap_rowsum,
        # fixed_mask in; (N, 2) out.
        "covariant_laplacian": (
            lambda: gtdgl.covariant_laplacian(op, U, psi), 20,
            2 * f * e + 2 * f * n + 2 * i * n * k + 2 * f * n * k
            + 2 * f * n + 2 * f * n),
        # r, inv_diag, cluster_ids, members, Ac_inv, and the tables of
        # the two applies (nbr_site, w_sym, w_sym_rowsum) in; z out.
        "amg_vcycle": (
            lambda: apply_amg(apply_A, amg, x), 15,
            f * n + f * n + i * n + i * nc * m + f * nc * nc
            + i * n * k + f * n * k + f * n + f * n),
    }
    out = {}
    for name, (fn, calls, nbytes) in applies.items():
        ms = queued_ms(fn, calls, cycles_per_ms, repeats=5)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, bound_ms=bound, bound_by="bytes",
                         bound_share=bound / ms, bytes=nbytes)
        log(f"  {name}: device {ms:.5f} ms per call (queued); bytes bound"
            f" {bound:.5f} ms ({nbytes} bytes at 3.35 TB/s), share"
            f" {100 * bound / ms:.1f}% (N {n}, K {k}, E {e}, nc {nc},"
            f" M {m})")
    return out


def run_ell_main_path(pkg, args, inputs):
    """Phase 11: the unstructured (ELL) backend at full width (see the
    module docstring). Returns the numbers it prints."""
    import numpy as np
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk
    from tdgl_tpu_torch.ops.screening import induced_vector_potential
    from tdgl_tpu_torch.solver import solver as solver_module

    rec = {}
    t0 = time.perf_counter()
    device = bench_device(pkg, structured=False)
    rec["mesher_s"] = time.perf_counter() - t0
    n_sites = len(device.mesh.sites)
    options = dict(solve_time=args.ell_time, dt_init=1e-4, dt_max=1e-2,
                   save_every=args.ell_chunk, field_units="mT",
                   current_units="uA", dtype="float32")
    spans = {"operators": [], "AMG": []}
    saved = (solver_module.build_operators, solver_module.build_amg)

    def timed(fn, span):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans[span].append(time.perf_counter() - t)
        return run

    solver_module.build_operators = timed(saved[0], "operators")
    solver_module.build_amg = timed(saved[1], "AMG")
    try:
        t0 = time.perf_counter()
        solver = pkg.TDGLSolver(device, pkg.SolverOptions(**options),
                                torch_device="cuda", **inputs)
        rec["solver_setup_s"] = time.perf_counter() - t0
    finally:
        solver_module.build_operators, solver_module.build_amg = saved
    rec.update(sites=n_sites, operators_s=spans["operators"][0],
               amg_s=spans["AMG"][0], K=int(solver.op.nbr_site.shape[1]),
               edges=int(solver.op.edges.shape[0]),
               aggregates=int(solver.amg.Ac_inv.shape[0]))
    log(f"  {n_sites} sites, {rec['edges']} edges, K {rec['K']},"
        f" {rec['aggregates']} AMG aggregates; mesher"
        f" {rec['mesher_s']:.2f} s, operators {rec['operators_s']:.2f} s,"
        f" AMG {rec['amg_s']:.2f} s, solver set-up"
        f" {rec['solver_setup_s']:.2f} s")
    assert not solver.structured and solver.cfg.use_amg
    assert all(t.device.type == solver.torch_device.type
               for t in list(solver.op) + list(solver.amg))

    # The bare chunk loop.
    state = solver._initial_state()
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    chunks, cg, valid = 0, [], 0
    with HostReads() as reads, EulerCalls() as calls:
        t0 = time.perf_counter()
        while True:
            state, outputs, exported = solver.chunk_fn(state)
            chunks += 1
            diag = exported["diagnostics"].cpu().numpy()
            n_valid = int(outputs.valid.sum())
            valid += n_valid
            cg.append(outputs.cg_iterations[:n_valid].float())
            if diag[4] or n_valid < solver.chunk_size:
                break
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    loop_launches = [fn.launches for fn in sk.KERNELS]
    steps = int(state.step)
    rec.update(loop_steps=steps, loop_s=loop_s,
               loop_steps_per_s=steps / loop_s,
               cg_per_step=float(torch.cat(cg).mean()),
               retries=calls.n - steps, reads_per_step=reads.n / steps,
               loop_launches=loop_launches)
    psi_abs = torch.sqrt(torch.sum(state.psi**2, dim=-1))
    log(f"  bare chunk loop: {steps} steps in {chunks} chunks,"
        f" {loop_s:.2f} s = {steps / loop_s:.2f} steps/s, mean CG"
        f" iterations {rec['cg_per_step']:.3f} per step, Euler retries"
        f" {rec['retries']}, host reads {rec['reads_per_step']:.2f} per"
        f" step, |psi| in [{psi_abs.min().item():.4f},"
        f" {psi_abs.max().item():.4f}], CUDA kernel launches"
        f" {loop_launches}")
    assert not bool(state.failed) and bool(state.done)
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    assert tuple(state.psi.shape) == (n_sites, 2)
    assert loop_launches == [0, 0], loop_launches

    # solve(): the Runner, the output file, the Solution.
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        solution = pkg.solve(device, pkg.SolverOptions(
            output_file=os.path.join(tmp, "ell.h5"), **options),
            torch_device="cuda", **inputs)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        solve_launches = [fn.launches for fn in sk.KERNELS]
        same = pkg.Solution.from_hdf5(solution.path).equals(solution)
        solve_steps = int(solution.tdgl_data.state["step"])
        side = float(np.sqrt(50_000 * 0.238))
        ys = np.linspace(-side / 2, side / 2, 2001)
        coords = np.stack([np.zeros_like(ys), ys], axis=1)
        t0 = time.perf_counter()
        current = solution.current_through_path(coords, with_units=False)
        current_s = time.perf_counter() - t0
        psi = np.abs(solution.tdgl_data.psi)
        voltage = solution.dynamics.mean_voltage()
    rec.update(solve_steps=solve_steps, solve_s=solve_s,
               solve_steps_per_s=solve_steps / solve_s,
               current_uA=current, solve_launches=solve_launches)
    log(f"  solve(): {solve_steps} steps, {solve_s:.2f} s wall ="
        f" {solve_steps / solve_s:.2f} steps/s (bare loop"
        f" {steps / loop_s:.2f}); current through x = 0 on the final"
        f" snapshot {current:.6g} uA (applied 20 uA; {current_s:.2f} s to"
        f" compute), mean probe voltage {voltage:.6g} V0, |psi| in"
        f" [{psi.min():.4f}, {psi.max():.4f}], CUDA kernel launches"
        f" {solve_launches}, Solution.from_hdf5(path).equals(solution):"
        f" {same}")
    assert same and np.isfinite(psi).all() and np.isfinite(voltage)
    assert solve_launches == [0, 0], solve_launches
    assert abs(current - 20.0) <= 0.1 * 20.0, current

    # Where the step's time goes, and the ELL applies against their bounds.
    sk.reset_launch_counts()
    rec["breakdown"] = ell_breakdown(solver, state._replace(
        end_time=torch.full_like(state.time, 1e9),
        done=torch.zeros_like(state.done)), steps=50, prof_steps=10)
    rec["applies"] = time_ell_applies(solver, state, sleep_cycles_per_ms())

    # Screened: the same film, 0.5 mT, no current, the pairwise kernel.
    scr_opts = dict(options, solve_time=1e9,
                    save_every=args.ell_screen_steps,
                    include_screening=True, screening_tolerance=1e-3,
                    screening_solver="anderson")
    scr = pkg.TDGLSolver(device, pkg.SolverOptions(**scr_opts),
                         torch_device="cuda", applied_vector_potential=0.5)
    assert scr._screening_kernel == "xla" and scr.cfg.screening_cg_iters == 32
    scr_state = scr._initial_state()
    torch.cuda.synchronize()
    with HostReads() as scr_reads:
        t0 = time.perf_counter()
        scr_state, scr_out, _ = scr.chunk_fn(scr_state)
        torch.cuda.synchronize()
        scr_s = time.perf_counter() - t0
    scr_steps = int(scr_state.step)
    its = scr_out.screening_iterations.float()
    a_ind = torch.abs(scr_state.A_induced).max().item()
    rng = np.random.default_rng(17)
    Jw = torch.tensor(rng.normal(size=(n_sites, 2)), dtype=torch.float32,
                      device=scr.torch_device)
    ec = scr.op.edge_centers
    sites = scr.op.sites
    records = device_records(lambda: induced_vector_potential(ec, sites,
                                                              Jw))
    eval_ms = sum(us for us, _, _ in records) / 1e3
    e = ec.shape[0]
    # Each (edge, site) pair: 2 differences, 2 squares, an add, a clamp,
    # an rsqrt and 2 multiply-adds of the product.
    eval_bound = max(4 * (2 * e + 4 * n_sites + 2 * e) / HBM_BYTES_PER_S,
                     11 * e * n_sites / F32_OPS_PER_S) * 1e3
    rec.update(screened_steps=scr_steps, screened_s=scr_s,
               screened_steps_per_s=scr_steps / scr_s,
               screening_its_per_step=float(its.mean()),
               screened_reads_per_step=scr_reads.n / max(scr_steps, 1),
               pairwise_eval_ms=eval_ms, pairwise_eval_bound_ms=eval_bound)
    log(f"  screened (xla): {scr_steps} steps in {scr_s:.2f} s ="
        f" {scr_steps / scr_s:.3f} steps/s, screening iterations"
        f" {scr_out.screening_iterations.tolist()} (mean"
        f" {rec['screening_its_per_step']:.3f} per step), host reads"
        f" {rec['screened_reads_per_step']:.1f} per step, max |A_induced|"
        f" {a_ind:.4g}; one pairwise induced-potential evaluation: device"
        f" {eval_ms:.3f} ms in {sum(c for _, c, _ in records)} records,"
        f" bound {eval_bound:.3f} ms (operations, float32)")
    assert not bool(scr_state.failed) and a_ind > 0
    assert bool(torch.isfinite(scr_state.psi).all())
    return rec, device, scr.op


def run_resume_path(pkg, args, device, options, inputs, tmp):
    """Phase 12 on one backend (see the module docstring): the
    uninterrupted, half and resumed runs and the seeded run. Returns the
    numbers it prints and each run's kernel launches and step slots."""
    import numpy as np
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk
    from tdgl_tpu_torch.solver.runner import DataHandler
    from tdgl_tpu_torch.utils import h5lite

    structured = device.mesh.grid is not None
    tag = "grid" if structured else "ell"
    runs = {}

    def run(name, run_opts, start_step=0, **kw):
        writes = []
        restore = timed_calls(DataHandler, ("save_checkpoint",), writes)
        try:
            with ChunkLog() as chunks:
                torch.cuda.synchronize()
                sk.reset_launch_counts()
                t0 = time.perf_counter()
                sol = pkg.solve(device, pkg.SolverOptions(
                    output_file=os.path.join(tmp, f"{tag}_{name}.h5"),
                    **run_opts), torch_device="cuda", **inputs, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = [fn.launches for fn in sk.KERNELS]
        finally:
            restore()
        steps = int(sol.tdgl_data.state["step"]) - start_step
        chunk = chunks.solver.chunk_size if chunks.solver else None
        rec = dict(steps=steps, s=seconds, steps_per_s=steps / seconds,
                   checkpoint_writes=len(writes),
                   checkpoint_write_s=sum(writes), launches=launches,
                   slots=chunks.slots if chunks.solver else 0,
                   # The first step of each chunk the fast program failed.
                   failover_steps=[start_step + i * chunk for i, (_, f)
                                   in enumerate(chunks.calls) if f])
        log(f"  {tag} {name}: {steps} steps, {seconds:.2f} s ="
            f" {rec['steps_per_s']:.2f} steps/s, failovers at steps"
            f" {rec['failover_steps']}, {rec['slots']} step slots, launches"
            f" {launches}, {len(writes)} checkpoint writes in"
            f" {rec['checkpoint_write_s']:.3f} s")
        runs[name] = rec
        return sol

    half = args.resume_time / 2
    opts = dict(options, save_every=args.resume_chunk)
    full = run("uninterrupted", dict(opts, solve_time=args.resume_time))
    part = run("to half", dict(opts, solve_time=half))
    with h5lite.File(part.path, "r") as f:
        grp = f["checkpoint"]
        ckpt_step = int(grp.attrs["step"])
        ckpt_time = float(grp.attrs["time"])
        ckpt_mb = sum(np.asarray(grp[k]).nbytes for k in grp) / 1e6
    log(f"  {tag} checkpoint: step {ckpt_step}, time {ckpt_time:.6f},"
        f" {ckpt_mb:.3f} MB of arrays")
    resumed = run("resumed", dict(opts, solve_time=args.resume_time),
                  start_step=ckpt_step, resume_from=part.path)
    a, b = full.tdgl_data, resumed.tdgl_data
    dpsi = float(np.abs(a.psi - b.psi).max())
    dmu = float(np.abs(a.mu - b.mu).max())
    bitwise = (np.array_equal(a.psi, b.psi) and np.array_equal(a.mu, b.mu)
               and all(a.state[k] == b.state[k]
                       for k in ("step", "time", "dt")))
    log(f"  {tag} resumed vs uninterrupted: max |dpsi| {dpsi:.3e}, max"
        f" |dmu| {dmu:.3e}, step {b.state['step']} / {a.state['step']},"
        f" time {float(b.state['time'])!r} / {float(a.state['time'])!r},"
        f" dt {float(b.state['dt'])!r} / {float(a.state['dt'])!r}, bitwise"
        f" {bitwise}")
    if not bitwise:
        raise AssertionError(
            f"{tag}: the resumed run differs from the uninterrupted one."
            f" Failovers at steps {runs['uninterrupted']['failover_steps']}"
            f" (uninterrupted) and {runs['resumed']['failover_steps']}"
            f" (resumed from step {ckpt_step}): a chunk that fails over"
            " on one side only runs other programs over the same steps.")
    seeded = run("seeded", dict(opts, solve_time=0.1, adaptive=False,
                                dt_init=1e-3, save_every=100),
                 seed_solution=full)
    final_psi = full.tdgl_data.psi
    seeded.solve_step = 0
    seed_equal = np.array_equal(seeded.tdgl_data.psi.astype(np.complex128),
                                final_psi.astype(np.complex128))
    seeded.solve_step = -1
    log(f"  {tag} seeded: step-0 snapshot equals the seed's final psi:"
        f" {seed_equal}; {int(seeded.tdgl_data.state['step'])} steps,"
        f" |psi| in [{np.abs(seeded.tdgl_data.psi).min():.4f},"
        f" {np.abs(seeded.tdgl_data.psi).max():.4f}]")
    assert seed_equal and runs["seeded"]["steps"] >= 100
    assert np.isfinite(seeded.tdgl_data.psi).all()
    for name in ("resumed", "seeded"):
        psi_n, rhs_n = runs[name]["launches"]
        if not structured:
            assert [psi_n, rhs_n] == [0, 0], (name, psi_n, rhs_n)
            continue
        slots = runs[name]["slots"]
        assert rhs_n == slots and psi_n >= slots, (name, psi_n, rhs_n, slots)
        if not runs[name]["failover_steps"]:
            assert psi_n == slots, (name, psi_n, slots)
    return dict(checkpoint_step=ckpt_step, checkpoint_time=ckpt_time,
                checkpoint_mb=ckpt_mb, max_dpsi=dpsi, max_dmu=dmu,
                bitwise=bitwise, seeded_step0_equal=seed_equal, runs=runs)


class SweepBias:
    """Phase 13's callable bias: ``peak`` into the source (out of the
    drain), ramping from half of it to all of it over ``t_ramp``; a plain
    callable of a float ``t`` (``solve_sweep`` evaluates it for each member
    at its own time at every chunk boundary)."""

    def __init__(self, peak: float, t_ramp: float):
        self.peak, self.t_ramp = float(peak), float(t_ramp)

    def __call__(self, t):
        ramp = min(max(float(t) / self.t_ramp, 0.0), 1.0)
        current = self.peak * (0.5 + 0.5 * ramp)
        return {"source": current, "drain": -current}


def member_inputs(solver, B: int, dtype, sten):
    """B members' seeded psi and mu (``(B, rows, cols)``), shared epsilon
    and dA/dt, per-member Neumann planes and dt, and per-member links of
    the applied potential scaled from 0.25 to 2 (a field sweep), on
    ``sten``, in ``dtype``."""
    import numpy as np
    import torch

    from tdgl_tpu_torch.models import gtdgl_stencil as gs

    xs = [random_inputs(solver, seed=20 + b) for b in range(B)]
    x = {k: torch.stack([m[k] for m in xs]).to(dtype)
         for k in ("pr", "pi", "mu")}
    x["eps"], x["dA"] = xs[0]["eps"].to(dtype), xs[0]["dA"].to(dtype)
    rng = np.random.default_rng(19)
    x["neumann"] = torch.tensor(rng.normal(size=x["pr"].shape) * 0.1,
                                dtype=dtype, device="cuda")
    x["dt"] = torch.tensor([1e-2 * (1 + b / B) for b in range(B)],
                           dtype=dtype, device="cuda")
    scales = torch.linspace(0.25, 2.0, B, dtype=dtype, device="cuda")
    A = (solver._initial_state().A_applied.to(dtype)[None]
         * scales[:, None, None, None, None])
    links = {"raw": gs.edge_link_phases(sten, A),
             "factored": gs.factor_link_phases(sten, A)}
    return x, links


def check_batched_kernels(solver, B: int, cycles_per_ms: float):
    """Phase 13's kernel checks and timings (see the module docstring).
    Returns ``{kernel: record}`` of the float32 factored batch."""
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk

    g, u = solver.cfg.gamma, solver.cfg.u
    out = {}
    for dtype in (torch.float32, torch.float64):
        sten = solver.sten._replace(**{
            f: t.to(dtype) for f, t in solver.sten._asdict().items()
            if t.is_floating_point()})
        x, links = member_inputs(solver, B, dtype, sten)
        f64 = dtype == torch.float64
        for form, U in links.items():
            ops = sk.StepOperands(sten, U, x["dA"], x["neumann"])
            psi_in = (x["pr"], x["pi"], x["mu"], x["eps"], x["dt"])
            before = [fn.launches for fn in sk.KERNELS]
            got = ops.psi_update(g, u, *psi_in)
            rhs = ops.poisson_rhs(x["pr"], x["pi"])
            assert [fn.launches - b for fn, b in
                    zip(sk.KERNELS, before)] == [1, 1]
            psi_err = rhs_err = 0.0
            for b in range(B):
                U_b = type(U)(*(None if f is None else f[b] for f in U))
                ref = sk.plain_psi_update(g, u, sten, U_b, x["pr"][b],
                                          x["pi"][b], x["mu"][b], x["eps"],
                                          x["dt"][b])
                rhs_ref = sk.plain_poisson_rhs(sten, U_b, x["pr"][b],
                                               x["pi"][b], x["dA"],
                                               x["neumann"][b])
                assert bool(got[3][b]) == bool(ref[3]), (form, b)
                scale = max(max(r.abs().max().item() for r in ref[:3]), 1.0)
                e = max((a[b] - r).abs().max().item()
                        for a, r in zip(got[:3], ref[:3]))
                psi_err = max(psi_err, e / scale if f64 else e)
                e = (rhs[b] - rhs_ref).abs().max().item()
                rhs_err = max(rhs_err, e / max(rhs_ref.abs().max().item(),
                                               1.0))
            label = f"{'float64' if f64 else 'float32'} {form}"
            log(f"  B={B} {label:16s} per member vs plain: psi max|err|"
                f" {psi_err:.3e}{' (rel)' if f64 else ''}, rhs max|err|/scale"
                f" {rhs_err:.3e}; ok {got[3].tolist()}")
            assert psi_err < (F64_TOL if f64 else F32_TOL), label
            assert rhs_err < (F64_TOL if f64 else F32_TOL), label
            if f64:
                continue
            if form == "factored":
                fac = dict(ops=ops, U=U, x=x, sten=sten, psi_in=psi_in,
                           err={"fused_psi_update": psi_err,
                                "fused_poisson_rhs": rhs_err})
            # One member through the batched entry == a single call.
            U0 = type(U)(*(None if f is None else f[0] for f in U))
            one = sk.StepOperands(sten, U0, x["dA"], x["neumann"][0])
            single = one.psi_update(g, u, x["pr"][0], x["pi"][0],
                                    x["mu"][0], x["eps"], x["dt"][0])
            batch1 = one.psi_update(g, u, x["pr"][:1], x["pi"][:1],
                                    x["mu"][:1], x["eps"], x["dt"][:1])
            same = all(torch.equal(a, b[0]) for a, b in zip(single, batch1))
            same &= torch.equal(one.poisson_rhs(x["pr"][0], x["pi"][0]),
                                one.poisson_rhs(x["pr"][:1],
                                                x["pi"][:1])[0])
            log(f"  B=1 batch == single call, bit for bit ({form}): {same}")
            assert same, form
    # ok per member: members 1 and 5 fail, then every member passes.
    ops, x = fac["ops"], fac["x"]
    bad = torch.zeros(B, dtype=torch.bool, device="cuda")
    bad[[1, 5]] = True
    dt = torch.where(bad, 50.0, 1e-5).float()
    mu = x["mu"] * torch.where(bad, 40.0, 1.0)[:, None, None]
    ok = ops.psi_update(g, u, x["pr"], x["pi"], mu, x["eps"], dt)[3].tolist()
    ok_plain = sk.plain_psi_update(g, u, ops.sten, ops.U, x["pr"], x["pi"],
                                   mu, x["eps"], dt)[3].tolist()
    ok_pass = ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], x["eps"],
                             torch.full((B,), 1e-5, device="cuda"))[3]
    log(f"  ok per member (members 1 and 5 fail): {ok} (plain {ok_plain});"
        f" then all passing: {ok_pass.tolist()}")
    assert ok == ok_plain == [True, False, True, True, True, False, True,
                              True], ok
    assert ok_pass.tolist() == [True] * B
    # Timings: the batch (factored, per-member links) vs B single calls.
    sten, U, psi_in = fac["sten"], fac["U"], fac["psi_in"]
    singles = [sk.StepOperands(sten, type(U)(*(f[b] for f in U)), x["dA"],
                               x["neumann"][b]) for b in range(B)]
    calls = {
        "fused_psi_update": (
            lambda: ops.psi_update(g, u, *psi_in),
            lambda: [s.psi_update(g, u, x["pr"][b], x["pi"][b], x["mu"][b],
                                  x["eps"], x["dt"][b])
                     for b, s in enumerate(singles)],
            lambda: sk.plain_psi_update(g, u, sten, U, *psi_in),
            list(psi_in) + [sten.w, sten.sym_diag, sten.inv_area,
                            sten.fixed_mask, sten.valid] + list(U),
            list(ops.psi_update(g, u, *psi_in))),
        "fused_poisson_rhs": (
            lambda: ops.poisson_rhs(x["pr"], x["pi"]),
            lambda: [s.poisson_rhs(x["pr"][b], x["pi"][b])
                     for b, s in enumerate(singles)],
            lambda: sk.plain_poisson_rhs(sten, U, x["pr"], x["pi"], x["dA"],
                                         x["neumann"]),
            [x["pr"], x["pi"], sten.inv_len, sten.dual, x["dA"],
             sten.inv_area, x["neumann"]] + list(U),
            [ops.poisson_rhs(x["pr"], x["pi"])]),
    }
    for name, (kernel, single, plain, ins, outs) in calls.items():
        bound, by = bound_ms(name, "factored", ins, outs)
        rec = dict(members=B, max_abs_err=fac["err"][name],
                   ms=queued_ms(kernel, 200, cycles_per_ms),
                   single_calls_ms=queued_ms(single, 25, cycles_per_ms),
                   plain_ms=queued_ms(plain, 1, cycles_per_ms, repeats=11),
                   bound_ms=bound, bound_by=by,
                   bytes=sum(t.numel() * t.element_size()
                             for t in ins + outs))
        rec["ms_per_member"] = rec["ms"] / B
        rec["bound_share"] = bound / rec["ms"]
        log(f"  float32 factored {name} at B={B}: device {rec['ms']:.5f} ms"
            f" per launch ({rec['ms_per_member']:.5f} per member), {B}"
            f" single calls {rec['single_calls_ms']:.5f} ms, plain"
            f" {rec['plain_ms']:.5f} ms; bound {bound:.5f} ms ({by},"
            f" {rec['bytes']} bytes), share {100 * rec['bound_share']:.1f}%")
        out[name] = rec
    return out


def run_sweep(pkg, device, options, label, **kwargs):
    """One ``solve_sweep`` on the card: its result, wall seconds, kernel
    launches and host reads (counted from 0 just before it), step slots,
    members x steps/s and the fixed-point iterations (per member and
    step, and the batch's: per slot the most of any live member); also
    the per-step outputs' screening iterations and valid flags,
    ``(B, slots)`` host arrays."""
    import numpy as np
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk
    from tdgl_tpu_torch.parallel import solve_sweep
    from tdgl_tpu_torch.parallel import sweep as sweep_module

    opts = pkg.SolverOptions(**options)
    outputs = []
    host_outputs = sweep_module._host_outputs

    def record(tree):
        outputs.append(host_outputs(tree))
        return outputs[-1]

    sweep_module._host_outputs = record
    try:
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        with HostReads() as reads:
            t0 = time.perf_counter()
            result = solve_sweep(device, opts, torch_device="cuda", **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        sweep_module._host_outputs = host_outputs
    launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
    steps_out = {name: np.concatenate([getattr(o, name) for o in outputs],
                                      axis=1)
                 for name in ("screening_iterations", "valid")}
    its = np.where(steps_out["valid"] > 0,
                   steps_out["screening_iterations"], 0)
    B = len(result.values)
    steps = int(result.steps.sum())
    chunk = options["save_every"]
    slots = -(-int(result.steps.max()) // chunk) * chunk
    rec = dict(members=B, steps=result.steps.tolist(), seconds=wall,
               member_steps_per_s=steps / wall, launches=launches,
               slots=slots, host_reads=reads.n,
               host_reads_per_slot=reads.n / slots,
               failed=result.failed.tolist(),
               screening_its_per_step=(its.sum(axis=1)
                                       / np.maximum(result.steps, 1)
                                       ).tolist(),
               batch_iterations=int(its.max(axis=0).sum()))
    log(f"  {label}: B={B}, steps {sorted(set(rec['steps']))}, {wall:.2f} s"
        f" = {rec['member_steps_per_s']:.2f} members x steps/s; launches"
        f" {launches} in {slots} step slots ="
        f" {launches['fused_psi_update'] / slots:.3f} psi and"
        f" {launches['fused_poisson_rhs'] / slots:.3f} RHS per slot; host"
        f" reads {reads.n} = {rec['host_reads_per_slot']:.2f} per slot"
        + (f"; fixed-point iterations per step by member"
           f" {[round(x, 3) for x in rec['screening_its_per_step']]}, batch"
           f" iterations {rec['batch_iterations']}"
           if options.get("include_screening") else ""))
    return result, rec, steps_out


def sweep_voltage_trace(result, b: int):
    """Member ``b``'s voltage between the two probes at each of its steps
    (V0)."""
    import numpy as np

    steps = np.flatnonzero(result.dynamics_dt[b] > 0)
    return (result.dynamics_mu[b, 0, steps]
            - result.dynamics_mu[b, 1, steps])


def run_sweep_path(pkg, args, solver, device, ell_device, options, inputs):
    """Phase 13: batched sweeps (see the module docstring). Returns the
    numbers it prints."""
    import numpy as np

    B = 8
    scales = np.linspace(0.25, 2.0, B)
    inner = np.ones(len(device.mesh.sites), dtype=bool)
    for terminal in device.terminal_info():
        inner[terminal.site_indices] = False
    kernels = check_batched_kernels(solver, B, sleep_cycles_per_ms())
    sw_opts = dict(options, solve_time=1e9, save_every=args.sweep_chunk)
    runs = {}
    results = {}
    sweeps = {
        "field sweep": dict(applied_vector_potential=0.5,
                            terminal_currents=inputs["terminal_currents"],
                            field_scales=scales),
        "current sweep": dict(applied_vector_potential=0.5,
                              terminal_currents=SweepBias(20.0, 1.0),
                              current_scales=scales),
    }
    for kind, kw in sweeps.items():
        for members in (B, 1):
            one = {k: (v[-1:] if k.endswith("_scales") else v)
                   for k, v in kw.items()}
            result, rec, _ = run_sweep(pkg, device, sw_opts,
                                    f"{kind} (structured, float32)",
                                    max_steps=args.sweep_steps,
                                    **(kw if members == B else one))
            runs[f"{kind} (B={members})"] = rec
            results[(kind, members)] = result
            assert not any(rec["failed"]), (kind, rec["failed"])
            assert min(rec["steps"]) >= args.sweep_steps, rec["steps"]
            assert rec["launches"]["fused_poisson_rhs"] == rec["slots"]
            assert rec["launches"]["fused_psi_update"] >= rec["slots"]
            assert np.isfinite(result.psi).all() and np.isfinite(
                result.mu).all()
        # |psi| away from the terminals (which hold it at 0): the
        # strongest member's minimum below 0.9, and its mean |psi|^2 below
        # the weakest member's.
        abs_psi = np.abs(results[(kind, B)].psi[:, inner])
        psi_min = float(abs_psi[-1].min())
        psi_sq = np.mean(abs_psi**2, axis=1)
        log(f"  {kind}: away from the terminals, |psi| min of the strongest"
            f" member {psi_min:.4f}, mean |psi|^2 weakest {psi_sq[0]:.4f},"
            f" strongest {psi_sq[-1]:.4f}; members x steps/s B={B}"
            f" {runs[f'{kind} (B={B})']['member_steps_per_s']:.2f}, B=1"
            f" {runs[f'{kind} (B=1)']['member_steps_per_s']:.2f}")
        assert psi_min < 0.9 and psi_sq[-1] < psi_sq[0], (psi_min, psi_sq)
    current = results[("current sweep", B)]
    final_v = [abs(float(sweep_voltage_trace(current, b)[-1]))
               for b in range(B)]
    log(f"  current sweep: final |voltage| by bias scale"
        f" {[round(x, 6) for x in final_v]} V0; mean voltages"
        f" {np.round(current.mean_voltages(), 6).tolist()} V0")
    # The test of tests/test_parallel.py: the strongest bias's final
    # voltage is more than twice the weakest's (the voltage fluctuates
    # from step to step, so neighbouring members may cross).
    assert final_v[-1] > 2.0 * final_v[0] > 0, final_v
    # Witnesses: members 1 and 2 (neighbours, whose final voltages may
    # cross) and the strongest member, each run alone over the same steps.
    # The film is in its phase-slip regime, where a difference at the
    # rounding level grows about tenfold every few steps (as between the
    # JAX package's own batched and single runs), so a member and its
    # witness agree closely only at first: over the first WITNESS_STEPS
    # steps their voltage traces must agree to WITNESS_RTOL, which must
    # be below the difference between the neighbours' own traces. The
    # step at which a member and its witness part by 1% is printed.
    witnesses = {B - 1: results[("current sweep", 1)]}
    for b in (1, 2):
        witnesses[b], _, _ = run_sweep(
            pkg, device, sw_opts, f"current sweep alone at scale {scales[b]}",
            max_steps=args.sweep_steps, applied_vector_potential=0.5,
            terminal_currents=SweepBias(20.0, 1.0),
            current_scales=scales[b:b + 1])
    witness_err = {}
    for b, alone in sorted(witnesses.items()):
        v_batch = sweep_voltage_trace(current, b)
        v_alone = sweep_voltage_trace(alone, 0)
        n = min(len(v_batch), len(v_alone))
        diff = np.abs(v_batch[:n] - v_alone[:n]) / np.abs(v_alone[:n]).max()
        witness_err[b] = float(diff[:WITNESS_STEPS].max())
        apart = np.flatnonzero(diff > 1e-2)
        log(f"  member {b} (scale {scales[b]}) against its run alone:"
            f" voltage max rel difference {witness_err[b]:.3e} over the"
            f" first {WITNESS_STEPS} steps; apart by 1% from step"
            f" {int(apart[0]) if len(apart) else None}; final |voltage|"
            f" {final_v[b]:.6f} V0 in the batch, {abs(v_alone[-1]):.6f}"
            f" alone")
    v1, v2 = (sweep_voltage_trace(witnesses[b], 0)[:WITNESS_STEPS]
              for b in (1, 2))
    neighbours = float(np.abs(v1 - v2).max() / np.abs(v2).max())
    log(f"  members 1 and 2 alone: voltage max rel difference"
        f" {neighbours:.3e} over the first {WITNESS_STEPS} steps")
    assert max(witness_err.values()) < WITNESS_RTOL < neighbours, (
        witness_err, neighbours)

    # float64 on the small film: each member against a single robust run.
    small = small_device(pkg)
    o64 = dict(solve_time=0.1, dt_init=1e-3, save_every=20,
               dtype="float64", field_units="mT", current_units="uA",
               chunk_failover="off")
    small_scales = [0.5, 1.0, 2.0]
    from tdgl_tpu_torch.parallel import solve_sweep

    sw = solve_sweep(small, pkg.SolverOptions(**o64),
                     applied_vector_potential=0.5,
                     terminal_currents=dict(source=3.0, drain=-3.0),
                     field_scales=small_scales, torch_device="cuda")
    worst = 0.0
    for b, s in enumerate(small_scales):
        single = pkg.TDGLSolver(small, pkg.SolverOptions(**o64),
                                applied_vector_potential=0.5 * s,
                                terminal_currents=dict(source=3.0,
                                                       drain=-3.0),
                                torch_device="cuda")
        state = single._initial_state()
        while not bool(state.done):
            state, _, _ = single.chunk_fn(state)
        data = single._state_to_arrays({
            "psi_real": state.psi_r, "psi_imag": state.psi_i,
            "mu": state.mu, "supercurrent": state.supercurrent,
            "normal_current": state.normal_current,
            "induced_vector_potential": state.A_induced})
        assert int(state.step) == int(sw.steps[b]), (b, int(state.step),
                                                     sw.steps[b])
        for name, got in (("psi", sw.psi[b]), ("mu", sw.mu[b])):
            ref = data[name]
            worst = max(worst, float(np.abs(got - ref).max()
                                     / np.abs(ref).max()))
    log(f"  float64 small film, {len(small_scales)}-member sweep vs single"
        f" robust runs: steps {sw.steps.tolist()}, max rel err {worst:.3e}")
    assert worst < 1e-10, worst

    # The ELL backend: an 8-member field sweep on phase 11's film.
    ell_opts = dict(sw_opts, save_every=min(args.sweep_chunk,
                                            args.sweep_ell_steps))
    ell_kw = dict(sweeps["field sweep"], max_steps=args.sweep_ell_steps)
    for members in (B, 1):
        kw = dict(ell_kw, field_scales=scales if members == B
                  else scales[-1:])
        result, rec, _ = run_sweep(pkg, ell_device, ell_opts,
                                "field sweep (ELL, float32)", **kw)
        runs[f"ELL field sweep (B={members})"] = rec
        assert not any(rec["failed"]) and np.isfinite(result.psi).all()
        assert rec["launches"] == {"fused_psi_update": 0,
                                   "fused_poisson_rhs": 0}
    return dict(kernels=kernels, runs=runs, small_f64_max_rel_err=worst,
                current_final_voltages=final_v,
                current_witness_rel_err=witness_err)


def link_tensors(U):
    """The link planes or vectors a kernel reads (raw: ``ur``, ``ui``;
    factored: the four row and column vectors)."""
    from tdgl_tpu_torch.models import gtdgl_stencil as gs

    return [U.ur, U.ui] if isinstance(U, gs.LinkPhases) else list(U)


def check_screened_batch_kernels(solver, B: int, cycles_per_ms: float):
    """Phase 14's kernel checks and timings: the two kernel forms a
    screened batch launches, the RHS kernel's J_s-writing form and the psi
    kernel with a ``|psi|^2`` plane, at B members with per-member links
    (raw and factored), float32 and float64, each member against the plain
    version on its own inputs; B = 1 bit for bit equal to a single call;
    then each form's device ms (float32) against its bound. Returns
    ``{kernel: {form: record}}``."""
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk

    g, u = solver.cfg.gamma, solver.cfg.u
    out = {"fused_psi_update": {}, "fused_poisson_rhs": {}}
    cases = {}
    for dtype in (torch.float32, torch.float64):
        sten = solver.sten._replace(**{
            f: t.to(dtype) for f, t in solver.sten._asdict().items()
            if t.is_floating_point()})
        x, links = member_inputs(solver, B, dtype, sten)
        # The fixed point's |psi|^2 plane: not pr^2 + pi^2 of the iterate.
        x["sq"] = (x["pr"] ** 2 + x["pi"] ** 2) * torch.linspace(
            0.9, 1.1, B, dtype=dtype, device="cuda")[:, None, None]
        f64 = dtype == torch.float64
        for form, U in links.items():
            ops = sk.StepOperands(sten, U, x["dA"], x["neumann"])
            psi_in = (x["pr"], x["pi"], x["mu"], x["eps"], x["dt"], x["sq"])
            before = [fn.launches for fn in sk.KERNELS]
            got = ops.psi_update(g, u, *psi_in)
            rhs, J_s = ops.poisson_rhs(x["pr"], x["pi"],
                                       with_supercurrent=True)
            assert [fn.launches - b for fn, b in
                    zip(sk.KERNELS, before)] == [1, 1]
            assert tuple(J_s.shape) == (B, 3) + tuple(x["pr"].shape[1:])
            psi_err = rhs_err = 0.0
            for b in range(B):
                U_b = type(U)(*(None if f is None else f[b] for f in U))
                ref = sk.plain_psi_update(g, u, sten, U_b, x["pr"][b],
                                          x["pi"][b], x["mu"][b], x["eps"],
                                          x["dt"][b], x["sq"][b])
                rhs_ref, J_ref = sk.plain_poisson_rhs(
                    sten, U_b, x["pr"][b], x["pi"][b], x["dA"],
                    x["neumann"][b], with_supercurrent=True)
                assert bool(got[3][b]) == bool(ref[3]), (form, b)
                scale = max(max(r.abs().max().item() for r in ref[:3]), 1.0)
                e = max((a[b] - r).abs().max().item()
                        for a, r in zip(got[:3], ref[:3]))
                psi_err = max(psi_err, e / scale if f64 else e)
                for a, r in ((rhs[b], rhs_ref), (J_s[b], J_ref)):
                    rhs_err = max(rhs_err, (a - r).abs().max().item()
                                  / max(r.abs().max().item(), 1.0))
            label = f"{'float64' if f64 else 'float32'} {form}"
            log(f"  B={B} {label:16s} per member vs plain: psi (abs_sq"
                f" form) max|err| {psi_err:.3e}{' (rel)' if f64 else ''},"
                f" rhs and J_s max|err|/scale {rhs_err:.3e}")
            assert psi_err < (F64_TOL if f64 else F32_TOL), label
            assert rhs_err < (F64_TOL if f64 else F32_TOL), label
            if f64:
                continue
            cases[form] = dict(ops=ops, U=U, psi_in=psi_in, sten=sten, x=x,
                               err={"fused_psi_update": psi_err,
                                    "fused_poisson_rhs": rhs_err})
            # One member through the batched entry == a single call.
            U0 = type(U)(*(None if f is None else f[0] for f in U))
            one = sk.StepOperands(sten, U0, x["dA"], x["neumann"][0])
            single = one.psi_update(g, u, x["pr"][0], x["pi"][0],
                                    x["mu"][0], x["eps"], x["dt"][0],
                                    x["sq"][0])
            batch1 = one.psi_update(g, u, x["pr"][:1], x["pi"][:1],
                                    x["mu"][:1], x["eps"], x["dt"][:1],
                                    x["sq"][:1])
            same = all(torch.equal(a, b[0]) for a, b in zip(single, batch1))
            rhs1 = one.poisson_rhs(x["pr"][0], x["pi"][0], True)
            rhs_b = one.poisson_rhs(x["pr"][:1], x["pi"][:1], True)
            same &= all(torch.equal(a, b[0]) for a, b in zip(rhs1, rhs_b))
            log(f"  B=1 batch == single call, bit for bit ({form}, abs_sq"
                f" and J_s forms): {same}")
            assert same, form
    for form, c in cases.items():
        ops, U, psi_in, sten, x = (c[k] for k in ("ops", "U", "psi_in",
                                                  "sten", "x"))
        calls = {
            "fused_psi_update": (
                lambda: ops.psi_update(g, u, *psi_in),
                lambda: sk.plain_psi_update(g, u, sten, U, *psi_in),
                list(psi_in) + [sten.w, sten.sym_diag, sten.inv_area,
                                sten.fixed_mask, sten.valid]
                + link_tensors(U),
                list(ops.psi_update(g, u, *psi_in))),
            "fused_poisson_rhs": (
                lambda: ops.poisson_rhs(x["pr"], x["pi"], True),
                lambda: sk.plain_poisson_rhs(sten, U, x["pr"], x["pi"],
                                             x["dA"], x["neumann"], True),
                [x["pr"], x["pi"], sten.inv_len, sten.dual, x["dA"],
                 sten.inv_area, x["neumann"]] + link_tensors(U),
                list(ops.poisson_rhs(x["pr"], x["pi"], True))),
        }
        for name, (kernel, plain, ins, outs) in calls.items():
            bound, by = bound_ms(name, form, ins, outs)
            rec = dict(members=B, form=form, max_abs_err=c["err"][name],
                       ms=queued_ms(kernel, 200, cycles_per_ms),
                       plain_ms=queued_ms(plain, 1, cycles_per_ms,
                                          repeats=11),
                       bound_ms=bound, bound_by=by,
                       bytes=sum(t.numel() * t.element_size()
                                 for t in ins + outs))
            rec["ms_per_member"] = rec["ms"] / B
            rec["bound_share"] = bound / rec["ms"]
            what = ("abs_sq form" if name == "fused_psi_update"
                    else "J_s form")
            log(f"  float32 {form} {name} ({what}) at B={B}: device"
                f" {rec['ms']:.5f} ms per launch ({rec['ms_per_member']:.5f}"
                f" per member), plain {rec['plain_ms']:.5f} ms; bound"
                f" {bound:.5f} ms ({by}, {rec['bytes']} bytes), share"
                f" {100 * rec['bound_share']:.1f}%")
            out[name][form] = rec
    return out


def check_witnesses(batch, alone, members, steps, label):
    """Members of a sweep against the same members run alone: their probe
    phase traces over the first ``steps`` steps, relative to the largest
    phase alone. Returns ``{member: error}`` and the difference between
    the first two members' own traces alone."""
    import numpy as np

    def trace(result, b):
        return result.dynamics_theta[b][:, :steps]

    err = {}
    for b in members:
        ref = trace(alone[b], 0)
        err[b] = float(np.abs(trace(batch, b) - ref).max()
                       / np.abs(ref).max())
        log(f"  {label}: member {b} against its run alone, probe phase"
            f" trace max rel difference {err[b]:.3e} over the first"
            f" {steps} steps")
    b0, b1 = members[:2]
    ref = trace(alone[b1], 0)
    apart = float(np.abs(trace(alone[b0], 0) - ref).max()
                  / np.abs(ref).max())
    log(f"  {label}: members {b0} and {b1} alone: probe phase traces max"
        f" rel difference {apart:.3e}")
    return err, apart


def run_screened_sweep_path(pkg, args, solver, device, ell_device, ell_op,
                            options):
    """Phase 14: screened sweeps (see the module docstring). Returns the
    numbers it prints."""
    import numpy as np
    import torch

    from tdgl_tpu_torch.ops.screening import induced_vector_potential
    from tdgl_tpu_torch.parallel import solve_sweep

    B = 8
    scales = np.linspace(0.25, 2.0, B)
    kernels = check_screened_batch_kernels(solver, B, sleep_cycles_per_ms())
    scr_opts = dict(options, solve_time=1e9,
                    save_every=args.screen_sweep_chunk,
                    include_screening=True, screening_tolerance=1e-3,
                    screening_kernel="fft", screening_solver="anderson")
    runs, results = {}, {}

    def screened_sweep(dev, opts, label, field_scales, max_steps):
        result, rec, steps_out = run_sweep(
            pkg, dev, opts, label, applied_vector_potential=0.5,
            field_scales=field_scales, max_steps=max_steps,
            raise_on_failure=False)
        assert np.isfinite(result.psi).all() and np.isfinite(
            result.mu).all(), label
        return result, rec, steps_out

    # The structured film: 8 members and 1 (scale 1.0) over the same steps.
    for members, sc in ((B, scales), (1, scales[3:4])):
        label = f"screened field sweep (structured, float32, B={members})"
        result, rec, _ = screened_sweep(device, scr_opts, label, sc,
                                        args.screen_sweep_steps)
        runs[label] = rec
        results[members] = result
        # psi and RHS (J_s form) launch once per fixed-point iteration of
        # the batch; psi more only on discriminant retries.
        assert rec["launches"]["fused_poisson_rhs"] == \
            rec["batch_iterations"], rec
        assert rec["launches"]["fused_psi_update"] >= \
            rec["batch_iterations"], rec
        for b in np.flatnonzero(rec["failed"]):
            # A failed member must fail alone too, at the same step.
            alone, _, _ = screened_sweep(
                device, scr_opts, f"member {b} alone", sc[b:b + 1],
                args.screen_sweep_steps)
            log(f"  member {b} (scale {sc[b]}) failed at step"
                f" {result.steps[b]} in the batch; alone: failed"
                f" {alone.failed.tolist()} at step {alone.steps.tolist()}")
            assert alone.failed[0] and alone.steps[0] == result.steps[b]
        assert min(rec["steps"]) >= args.screen_sweep_steps or any(
            rec["failed"]), rec["steps"]
    batch = results[B]
    psi_sq = np.mean(np.abs(batch.psi) ** 2, axis=1)
    log(f"  structured screened sweep: mean |psi|^2 by scale"
        f" {np.round(psi_sq, 4).tolist()}; members x steps/s B={B}"
        f" {runs[f'screened field sweep (structured, float32, B={B})']['member_steps_per_s']:.2f},"
        f" B=1 {runs['screened field sweep (structured, float32, B=1)']['member_steps_per_s']:.2f}")
    assert psi_sq[-1] < psi_sq[0], psi_sq
    # Witnesses: members 1 and 7 each run alone.
    wit_opts = dict(scr_opts, save_every=SCREEN_WITNESS_STEPS)
    alone = {b: screened_sweep(device, wit_opts, f"member {b} alone",
                               scales[b:b + 1], SCREEN_WITNESS_STEPS)[0]
             for b in (1, B - 1)}
    witness_err, witness_apart = check_witnesses(
        batch, alone, (1, B - 1), SCREEN_WITNESS_STEPS,
        "screened field sweep")
    assert max(witness_err.values()) < WITNESS_RTOL < witness_apart, (
        witness_err, witness_apart)

    # float64 on the small film: each member against a single robust run.
    small = small_device(pkg)
    o64 = dict(solve_time=0.002, dt_init=1e-4, adaptive=False,
               save_every=21, dtype="float64", field_units="mT",
               current_units="uA", chunk_failover="off",
               include_screening=True, screening_tolerance=1e-4,
               screening_error_norm="global")
    small_scales = [0.5, 1.0, 2.0]
    inputs = dict(terminal_currents=dict(source=3.0, drain=-3.0))
    sw, rec64, out64 = run_sweep(pkg, small, o64,
                                 "screened sweep (small film, float64)",
                                 applied_vector_potential=0.5,
                                 field_scales=small_scales, **inputs)
    assert not any(rec64["failed"])
    worst = 0.0
    for b, s in enumerate(small_scales):
        single = pkg.TDGLSolver(small, pkg.SolverOptions(**o64),
                                applied_vector_potential=0.5 * s,
                                torch_device="cuda", **inputs)
        state = single._initial_state()
        its = []
        while not bool(state.done):
            state, outputs, _ = single.chunk_fn(state)
            valid = outputs.valid.cpu().numpy() > 0
            its += outputs.screening_iterations.cpu().numpy()[valid].tolist()
        data = single._state_to_arrays({
            "psi_real": state.psi_r, "psi_imag": state.psi_i,
            "mu": state.mu, "supercurrent": state.supercurrent,
            "normal_current": state.normal_current,
            "induced_vector_potential": state.A_induced})
        batch_its = out64["screening_iterations"][b][
            out64["valid"][b] > 0].tolist()
        assert int(state.step) == int(sw.steps[b]), (b, int(state.step))
        assert its == batch_its, (b, its, batch_its)
        for name, got in (("psi", sw.psi[b]), ("mu", sw.mu[b])):
            ref = data[name]
            worst = max(worst, float(np.abs(got - ref).max()
                                     / np.abs(ref).max()))
    log(f"  float64 small film, {len(small_scales)}-member screened sweep"
        f" vs single robust runs: steps {sw.steps.tolist()}, equal"
        f" screening iterations, max rel err {worst:.3e}")
    assert worst < 1e-10, worst

    # The ELL backend: the pairwise kernel, 8 members and 1.
    ell_opts = dict(scr_opts, screening_kernel="auto",
                    save_every=args.screen_sweep_ell_steps)
    for members, sc in ((B, scales), (1, scales[3:4])):
        label = f"screened field sweep (ELL, float32, B={members})"
        result, rec, _ = screened_sweep(ell_device, ell_opts, label, sc,
                                        args.screen_sweep_ell_steps)
        runs[label] = rec
        assert not any(rec["failed"]), rec
        assert rec["launches"] == {"fused_psi_update": 0,
                                   "fused_poisson_rhs": 0}
    # One pairwise evaluation at B members and at 1 (device time).
    n, e = ell_op.sites.shape[0], ell_op.edge_centers.shape[0]
    rng = np.random.default_rng(23)
    pairwise = {}
    for members in (B, 1):
        Jw = torch.tensor(rng.normal(size=(members, n, 2)),
                          dtype=torch.float32, device="cuda")
        Jw = Jw if members > 1 else Jw[0]
        records = device_records(lambda: induced_vector_potential(
            ell_op.edge_centers, ell_op.sites, Jw))
        # Per (edge, site) pair: the distance (2 differences, 2 squares,
        # an add, a clamp, an rsqrt) once, and 2 multiply-adds per member.
        bound = max(4 * (2 * e + 2 * n + 2 * members * (n + e))
                    / HBM_BYTES_PER_S,
                    (7 + 4 * members) * e * n / F32_OPS_PER_S) * 1e3
        pairwise[members] = dict(
            ms=sum(us for us, _, _ in records) / 1e3,
            records=sum(c for _, c, _ in records), bound_ms=bound)
    ratio = pairwise[B]["ms"] / pairwise[1]["ms"]
    log(f"  one pairwise induced-potential evaluation ({e} edges x {n}"
        f" sites): device {pairwise[B]['ms']:.3f} ms at B={B},"
        f" {pairwise[1]['ms']:.3f} ms at B=1 (ratio {ratio:.3f}); bounds"
        f" {pairwise[B]['bound_ms']:.3f} / {pairwise[1]['bound_ms']:.3f} ms"
        f" (operations, float32)")
    return dict(kernels=kernels, runs=runs, small_f64_max_rel_err=worst,
                witness_rel_err=witness_err, witness_apart=witness_apart,
                pairwise_eval=pairwise, pairwise_ratio=ratio)


# Phase 15's reader: a separate process that imports only tdgl_tpu_torch
# (and numpy), polls the solve's side file through h5lite and
# visualization.io every 0.5 s, and exits non-zero unless it saw at least
# two distinct steps, a finite psi of the film's sites and the device.
SIDE_FILE_READER = r"""
import json, os, sys, time
import numpy as np
from tdgl_tpu_torch.utils import h5lite
from tdgl_tpu_torch.visualization import Quantity, io

path, n_sites, limit = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
print("ready", flush=True)
steps, reads, failed, psi_ok, device_ok, mesh = [], 0, 0, False, False, None
seen, t_end = False, time.time() + limit
while time.time() < t_end:
    if not os.path.exists(path):
        if seen:
            break
        time.sleep(0.1)
        continue
    seen = True
    try:
        with h5lite.File(path, "r") as f:
            device_ok = device_ok or "solution/device" in f
            if mesh is None:
                mesh = io.load_mesh(f)
            grp = f["data/-1"]
            if "psi" in grp:
                psi = np.asarray(grp["psi"])
                mag = io.get_plot_data(f, mesh, Quantity.ORDER_PARAMETER,
                                       -1)[0]
                psi_ok = psi_ok or (psi.shape == (n_sites,)
                                    and bool(np.isfinite(psi).all())
                                    and mag.shape == (n_sites,))
            step = int(np.asarray(grp["step"])[0])
        reads += 1
        if step not in steps:
            steps.append(step)
    except (KeyError, OSError, ValueError):
        failed += 1
    time.sleep(0.5)
ok = len(steps) >= 2 and psi_ok and device_ok
print(json.dumps(dict(steps=steps, reads=reads, failed_reads=failed,
                      psi_ok=psi_ok, device_ok=device_ok, ok=ok)))
sys.exit(0 if ok else 1)
"""


def run_postprocessing_path(pkg, args, device, options, inputs, tmp):
    """Phase 15: a ``solve()`` with a reader process polling its
    ``.h5.tmp`` side file, then the visualization and post-processing
    functions on its full-width output. Returns the phase's record."""
    import importlib.util

    import numpy as np
    import torch

    from tdgl_tpu_torch.ops import step_kernels as sk
    from tdgl_tpu_torch.solution.data import get_edge_quantity_data
    from tdgl_tpu_torch.solver.runner import DataHandler
    from tdgl_tpu_torch.utils import h5lite
    from tdgl_tpu_torch.visualization import (Quantity, convert_to_xdmf,
                                              get_plot_data)

    rec = {}
    path = os.path.join(tmp, "post.h5")
    n_sites = len(device.mesh.sites)
    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    reader = subprocess.Popen(
        [sys.executable, "-c", SIDE_FILE_READER, path + ".tmp",
         str(n_sites), "600"], env=env, cwd=tmp, stdout=subprocess.PIPE,
        text=True)
    assert reader.stdout.readline().strip() == "ready"
    rec["reader_start_s"] = time.perf_counter() - t0

    writes, side_writes = [], []
    restores = [timed_calls(DataHandler, ("save_time_step",), writes),
                timed_calls(h5lite.Dataset, ("__setitem__",), side_writes)]
    post_opts = dict(options, solve_time=args.post_time,
                     save_every=args.post_chunk)
    try:
        with ChunkLog() as post_log:
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            solution = pkg.solve(device, pkg.SolverOptions(
                output_file=path, **post_opts), torch_device="cuda",
                **inputs)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in sk.KERNELS}
    finally:
        for restore in restores:
            restore()
    side_gone = not os.path.exists(path + ".tmp")
    out, _ = reader.communicate(timeout=120)
    seen = json.loads(out.strip().splitlines()[-1])
    steps = int(solution.tdgl_data.state["step"])
    lo, hi = solution.data_range
    snapshots = hi - lo + 1
    rec.update(solve_steps=steps, solve_s=solve_s, snapshots=snapshots,
               slots=post_log.slots, launches=launches, reader=seen,
               reader_rc=reader.returncode,
               write_s_per_snapshot=sum(writes) / len(writes),
               side_inplace_s_per_snapshot=sum(side_writes) / len(writes))
    log(f"  solve(): {steps} steps, {snapshots} snapshots, {solve_s:.2f} s"
        f" = {steps / solve_s:.2f} steps/s, {post_log.slots} step slots,"
        f" launches {launches}; snapshot writes (output and side file)"
        f" {rec['write_s_per_snapshot']:.4f} s each, of which in-place"
        f" side-file writes {rec['side_inplace_s_per_snapshot']:.4f} s;"
        f" side file removed: {side_gone}; reader (started in"
        f" {rec['reader_start_s']:.2f} s, rc {reader.returncode}): {seen}")
    assert reader.returncode == 0 and seen["ok"], seen
    assert side_gone
    assert launches["fused_poisson_rhs"] == post_log.slots
    assert launches["fused_psi_update"] >= post_log.slots

    # Plot data against the Solution's own arrays, at the last frame.
    mesh = solution.device.mesh
    data = solution.tdgl_data
    expected = {
        Quantity.ORDER_PARAMETER: np.abs(data.psi),
        Quantity.PHASE: np.angle(data.psi) / np.pi,
        Quantity.SCALAR_POTENTIAL: data.mu - np.nanmin(data.mu),
        Quantity.SUPERCURRENT: get_edge_quantity_data(data.supercurrent,
                                                      mesh)[0],
        Quantity.NORMAL_CURRENT: get_edge_quantity_data(data.normal_current,
                                                        mesh)[0],
    }
    t0 = time.perf_counter()
    with h5lite.File(solution.path, "r") as f:
        for quantity in Quantity:
            value, directions, limits = get_plot_data(f, mesh, quantity, hi)
            assert value.shape == (n_sites,), quantity
            assert np.isfinite(value).all() and len(limits) == 2, quantity
            if quantity in expected:
                assert np.array_equal(value, expected[quantity]), quantity
    rec["plot_data_s"] = time.perf_counter() - t0

    # XDMF: the heavy file read back through h5lite.
    t0 = time.perf_counter()
    xdmf = convert_to_xdmf(solution.path)
    rec["xdmf_s"] = time.perf_counter() - t0
    with h5lite.File(xdmf + ".h5", "r") as f:
        frames = [k for k in f if k.startswith("frame_")]
        assert np.array_equal(np.asarray(f[f"frame_{hi}/order_parameter"]),
                              np.abs(data.psi))
    rec["xdmf_frames"] = len(frames)
    rec["xdmf_bytes"] = os.path.getsize(xdmf + ".h5")
    assert len(frames) == snapshots, (len(frames), snapshots)
    log(f"  plot data for {len(Quantity)} quantities"
        f" {rec['plot_data_s']:.2f} s (equal to the Solution's arrays);"
        f" XDMF {rec['xdmf_s']:.2f} s, {len(frames)} frames,"
        f" {rec['xdmf_bytes']} bytes")

    # Post-processing on the full-width Solution, each call timed once.
    side = float(np.sqrt(50_000 * 0.238))
    ys = np.linspace(-side / 2, side / 2, 2001)
    centre = np.stack([np.zeros_like(ys), ys], axis=1)
    above = np.array([[0.0, 0.0], [side / 4, 0.0], [0.0, side / 4],
                      [-side / 4, -side / 4]])
    rng = np.random.default_rng(15)
    inside = rng.uniform(-side / 3, side / 3, size=(1000, 2))
    calls = {
        "field_at_position": lambda: solution.field_at_position(
            above, zs=1.0, with_units=False),
        "vector_potential_at_position":
            lambda: solution.vector_potential_at_position(
                above, zs=1.0, with_units=False),
        "boundary_phases": lambda: solution.boundary_phases(),
        "current_through_path": lambda: solution.current_through_path(
            centre, with_units=False),
        "vorticity": lambda: solution.vorticity.magnitude,
        "grid_current_density": lambda: solution.grid_current_density()[2],
        "interp_order_parameter":
            lambda: solution.interp_order_parameter(inside),
        "interp_current_density":
            lambda: solution.interp_current_density(inside),
    }
    values, post_s = {}, {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        values[name] = call()
        post_s[name] = time.perf_counter() - t0
    rec["post_s"] = post_s
    current = values["current_through_path"]
    rec["current_uA"] = current
    log("  post-processing (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in post_s.items())
        + f"; current through x = 0 {current:.6g} uA (applied 20 uA)")
    assert abs(current - 20.0) <= 0.1 * 20.0, current
    for name, value in values.items():
        if name != "boundary_phases":
            arr = np.asarray(value)
            assert np.isfinite(arr[~np.isnan(arr)]).all() and arr.size, name
    assert np.isfinite(values["interp_order_parameter"]).any()

    # One snapshot rendered where matplotlib is installed.
    if importlib.util.find_spec("matplotlib") is None:
        rec["plot"] = "matplotlib not installed"
        log("  matplotlib is not installed here: no snapshot rendered")
    else:
        import matplotlib.pyplot as plt

        from tdgl_tpu_torch.visualization import (generate_snapshots,
                                                  non_gui_backend)

        t0 = time.perf_counter()
        with non_gui_backend():
            (fig, _), = generate_snapshots(
                solution.path, times=[float(data.state["time"])])
            fig.savefig(os.path.join(tmp, "snapshot.png"))
            plt.close(fig)
        rec["plot"] = time.perf_counter() - t0
        log(f"  one snapshot rendered in {rec['plot']:.2f} s")
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunk", type=int, default=500,
                        help="steps per chunk and per snapshot (phases 6-7)")
    parser.add_argument("--solve-time", type=float, default=9.8,
                        help="simulated time of phases 6-7 (the default"
                        " takes about 1,000 steps)")
    # Phases 8-10, 12 and 14 (and the profiled windows of phases 8-11)
    # are cut to this depth so that the script, with phase 15, stays well
    # inside its limit on a slow host: at about twice these depths it took
    # ~1,185 s on an H100 machine whose host ran the static bare loop at
    # 17 steps/s (30 on a fast one).
    parser.add_argument("--ramp-time", type=float, default=3.0,
                        help="simulated time of phase 9's traced ramp (the"
                        " inputs ramp over its first half)")
    parser.add_argument("--ramp-chunk", type=int, default=500,
                        help="steps per chunk of phase 9")
    parser.add_argument("--screen-time", type=float, default=1.2,
                        help="simulated time of phase 10's screened solve"
                        " (the default takes about 130 steps)")
    parser.add_argument("--screen-chunk", type=int, default=100,
                        help="steps per chunk of phase 10")
    parser.add_argument("--ell-time", type=float, default=9.8,
                        help="simulated time of phase 11's unstructured"
                        " solves (the default takes about 1,000 steps)")
    parser.add_argument("--ell-chunk", type=int, default=200,
                        help="steps per chunk of phase 11")
    parser.add_argument("--ell-screen-steps", type=int, default=10,
                        help="steps of phase 11's screened run")
    parser.add_argument("--resume-time", type=float, default=2.4,
                        help="simulated time of phase 12's uninterrupted"
                        " runs (the checkpoint is taken at half of it)")
    parser.add_argument("--resume-chunk", type=int, default=100,
                        help="steps per chunk and per snapshot of phase 12")
    parser.add_argument("--sweep-steps", type=int, default=200,
                        help="steps per member of phase 13's structured"
                        " sweeps")
    parser.add_argument("--sweep-chunk", type=int, default=100,
                        help="steps per chunk of phase 13's sweeps")
    parser.add_argument("--sweep-ell-steps", type=int, default=100,
                        help="steps per member of phase 13's ELL sweep")
    parser.add_argument("--screen-sweep-steps", type=int, default=20,
                        help="steps per member of phase 14's structured"
                        " screened sweeps")
    parser.add_argument("--screen-sweep-chunk", type=int, default=25,
                        help="steps per chunk of phase 14's structured"
                        " screened sweeps")
    parser.add_argument("--screen-sweep-ell-steps", type=int, default=10,
                        help="steps per member (and per chunk) of phase"
                        " 14's ELL screened sweeps")
    parser.add_argument("--post-time", type=float, default=3.0,
                        help="simulated time of phase 15's solve() (about"
                        " 300 steps)")
    parser.add_argument("--post-chunk", type=int, default=50,
                        help="steps per chunk and per snapshot of phase 15")
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
        check_small_ell_chunks(ttdgl)

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
            done=torch.zeros_like(state.done)), steps=50, prof_steps=10)

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
        ramp_breakdown = time_breakdown(ramp_solver, ramp_state, steps=50,
                                        prof_steps=10, programs=("fast",),
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
        scr_breakdown = time_breakdown(scr_solver, scr_state, steps=10,
                                       prof_steps=4, psi_records=False)
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

    with Phase("unstructured (ELL) main path at full width"):
        ell, ell_device, ell_op = run_ell_main_path(ttdgl, args, inputs)

    with Phase("checkpoint resume and seed (both backends)"), \
            tempfile.TemporaryDirectory() as tmp:
        resume = {"grid": run_resume_path(ttdgl, args, device, options,
                                          inputs, tmp),
                  "ell": run_resume_path(ttdgl, args, ell_device, options,
                                         inputs, tmp)}

    with Phase("batched sweeps (solve_sweep)"):
        sweep = run_sweep_path(ttdgl, args, solver, device, ell_device,
                               options, inputs)

    with Phase("screened sweeps (solve_sweep, include_screening)"):
        screened_sweep = run_screened_sweep_path(
            ttdgl, args, solver, device, ell_device, ell_op, options)

    with Phase("post-processing and visualization (side file, plots,"
               " XDMF)") as post_phase, tempfile.TemporaryDirectory() as tmp:
        post = run_postprocessing_path(ttdgl, args, device, options, inputs,
                                       tmp)
    post["seconds"] = post_phase.seconds

    smi_after = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"gpu after: {smi_after}")

    # Launches on the driven paths: phase 7 (static inputs), phase 9 (the
    # traced ramp and the host path), phase 10 (screening) and phase 12
    # (the resumed and the seeded runs), each counted from 0 just before
    # its solve() and read just after. The unstructured runs of phases 11
    # and 12 launch neither kernel (checked there).
    ell_launches = dict(zip((fn.__name__ for fn in sk.KERNELS),
                            ell["solve_launches"]))
    by_path = {"static solve()": launches, "traced ramp": ramp_launches,
               "host path": host_launches, "screened": scr_launches,
               "ELL solve()": ell_launches}
    slots_by_path = {"static solve()": solve_slots,
                     "traced ramp": ramp_slots, "host path": host_log.slots,
                     "screened": scr_log.slots,
                     "ELL solve()": ell["solve_steps"]}
    for backend, rec in resume.items():
        for run_name in ("resumed", "seeded"):
            key = f"{run_name} ({backend})"
            by_path[key] = dict(zip((fn.__name__ for fn in sk.KERNELS),
                                    rec["runs"][run_name]["launches"]))
            slots_by_path[key] = rec["runs"][run_name]["slots"]
    # Phase 13: each sweep's launches, counted from 0 just before it and
    # read just after (one launch of each kernel per step slot serves the
    # whole batch; the ELL sweep launches neither).
    for key, run in sweep["runs"].items():
        by_path[key] = run["launches"]
        slots_by_path[key] = run["slots"]
    # Phase 14: the same for each screened sweep (psi and the RHS's J_s
    # form launch once per fixed-point iteration of the batch).
    for key, run in screened_sweep["runs"].items():
        by_path[key] = run["launches"]
        slots_by_path[key] = run["slots"]
    # Phase 15: the solve() beside the side-file reader.
    by_path["post-processing solve()"] = post["launches"]
    slots_by_path["post-processing solve()"] = post["slots"]

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
            # Phase 13: one launch for 8 members (factored, per-member
            # links), against 8 single launches, and its bound.
            batch=sweep["kernels"][name],
            # Phase 14: the form a screened batch launches (psi with the
            # |psi|^2 plane, the RHS writing J_s) at 8 members with
            # per-member links, raw (the screened step's) and factored.
            batch_screened=screened_sweep["kernels"][name],
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
                    "induced_ms": induced_ms, "ell": ell,
                    "resume": resume,
                    "sweep": {k: v for k, v in sweep.items()
                              if k != "kernels"},
                    "screened_sweep": {k: v for k, v in
                                       screened_sweep.items()
                                       if k != "kernels"},
                    "post": post}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
