"""Solver options.

API parity with the reference ``tdgl/solver/options.py:19-166``, plus
TPU-specific knobs (dtype, Poisson-CG tolerances, scan chunking). The
reference's ``sparse_solver`` choices (SuperLU/UMFPACK/PARDISO/CuPy LU) do not
exist here — the mu-Poisson equation is solved with device-resident CG — but
the field is accepted for API compatibility.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Union


class SolverOptionsError(ValueError):
    pass


class SparseSolver(Enum):
    """Linear solver for the scalar-potential Poisson equation.

    ``CG`` (the default, and the only TPU-native option) is a deflated,
    Jacobi-preconditioned conjugate-gradient solve. The reference's LU-based
    names are accepted as aliases of CG for API compatibility.
    """

    CG = "cg"
    SUPERLU = "superlu"
    UMFPACK = "umfpack"
    PARDISO = "pardiso"
    CUPY = "cupy"


@dataclass
class SolverOptions:
    """Options for :class:`tdgl_tpu.TDGLSolver`.

    Args:
        solve_time: Total simulation time (after thermalization).
        skip_time: Thermalization time simulated before recording data.
        dt_init: Initial time step.
        dt_max: Maximum adaptive time step.
        adaptive: Use an adaptive time step.
        adaptive_window: Number of recent steps in the adaptive-dt average.
        max_solve_retries: Max dt reductions per step before giving up.
        adaptive_time_step_multiplier: dt multiplier per retry.
        terminal_psi: Fixed order-parameter value in current terminals
            (None disables the Dirichlet rows).
        output_file: Path for the HDF5 output (None = temporary file).
        gpu: Accepted for reference API compatibility (ignored: JAX manages
            device placement; the TPU is used when available).
        sparse_solver: See :class:`SparseSolver`.
        field_units / current_units: Units for fields and currents.
        pause_on_interrupt: Pause interactively on Ctrl-C.
        save_every: Steps between saved snapshots.
        progress_interval: Steps between log-based progress reports
            (0 disables; a tqdm bar is shown instead).
        monitor: Launch the live-monitor subprocess.
        monitor_update_interval: Monitor poll period in seconds.
        include_screening: Self-consistently include the induced vector
            potential.
        max_iterations_per_step: Screening fixed-point iteration cap.
        screening_tolerance: Relative screening convergence tolerance.
        screening_step_size: Polyak step size alpha.
        screening_step_drag: Polyak drag beta.
        dtype: "float32" (TPU-native) or "float64" (CPU parity runs).
        poisson_tolerance: Relative CG tolerance for the mu solve.
        poisson_max_iterations: CG iteration cap.
        steps_per_chunk: TDGL steps fused into one compiled scan between host
            synchronizations. Defaults to ``save_every`` (snapshots align with
            chunk boundaries).
        profile_dir: If set, wrap the whole run in ``jax.profiler.trace``
            writing a TensorBoard-compatible XLA trace to this directory
            (device timelines, HLO cost breakdowns). TPU-native replacement
            for the reference's cProfile-based tracing.
        save_checkpoints: Overwrite a full-state ``checkpoint`` group in
            the output file at every snapshot, enabling exact mid-run
            resume via ``solve(resume_from=path)`` (see the field comment
            below).
    """

    solve_time: float
    skip_time: float = 0.0
    dt_init: float = 1e-6
    dt_max: float = 1e-1
    adaptive: bool = True
    adaptive_window: int = 10
    max_solve_retries: int = 10
    adaptive_time_step_multiplier: float = 0.25
    output_file: Optional[str] = None
    terminal_psi: Union[float, complex, None] = 0.0
    gpu: bool = False
    sparse_solver: Union[SparseSolver, str] = SparseSolver.CG
    pause_on_interrupt: bool = True
    save_every: int = 100
    progress_interval: int = 0
    monitor: bool = False
    monitor_update_interval: float = 1.0
    field_units: str = "mT"
    current_units: str = "uA"
    include_screening: bool = False
    max_iterations_per_step: int = 1000
    screening_tolerance: float = 1e-3
    screening_step_size: float = 0.1
    screening_step_drag: float = 0.5
    # TPU-specific options
    dtype: str = "float32"
    # Which compiled solver backend to use: "auto" picks the gather-free
    # stencil backend when the mesh is structured (Device.make_mesh(
    # structured=True)) and the ELL gather backend otherwise; "stencil" and
    # "ell" force one (stencil requires a structured mesh). On TPU the
    # stencil backend is ~3 orders of magnitude faster.
    solver_backend: str = "auto"
    # Screening-error normalization ("auto", "per_edge", "global"):
    # the reference compares |dA_e| / |A_e| per edge
    # (``tdgl/solver/solver.py:570-575``), which is meaningful in float64 but
    # floors at ~2e-5 in float32 — edges carrying ~0.01% of the peak induced
    # potential amplify summation noise into the per-edge ratio. "global"
    # compares max_e |dA_e| / max_e |A_e| (noise floor ~1e-7 at f32, measured
    # on a real mesh), making screening_tolerance=1e-6 usable at float32.
    # "auto" = per_edge at float64, global at float32.
    screening_error_norm: str = "auto"
    # Which induced-vector-potential kernel to use:
    #   "auto"   — "fft" on structured meshes, "xla" otherwise (default);
    #   "fft"    — exact O(N log N) lattice convolution
    #              (ops/fft_screening.py; structured meshes only);
    #   "xla"    — blocked O(E x S) rsqrt+matmul (ops/screening.py);
    #   "mxu"    — the FFT convolution with every transform expressed as
    #              a dense DFT matmul on the systolic array (same math,
    #              parity-tested; XLA's TPU FFT lowering is lane-shuffle
    #              -bound, measured ~0.5 TFLOP/s).
    # (A fused Pallas pairwise kernel existed through round 3 and was
    # deleted: the pairwise sum is VPU-rsqrt-bound — E x S ~ 7.5e9 rsqrts
    # is a ~20 ms floor that the XLA blocked form already sits at via the
    # MXU dot-product distance trick — so no kernel formulation can beat
    # "xla", and "fft" superseded both on structured meshes. Measured 45
    # vs 22 ms; see docs/perf_notes.md.)
    screening_kernel: str = "auto"
    # Operand precision of the MXU DFT screening matmuls: "high" (bf16x3,
    # ~5e-7 kernel parity — exact for f32 purposes) or "bf16" (single-pass
    # bf16, 3x less MXU work, a deterministic ~1e-3 relative kernel
    # perturbation — the same order as the f32 screening precision floor).
    # "auto" (default): the robust chunk program uses "high"; the gated
    # FAST chunk program (chunk_failover) uses "bf16" on float32 — the
    # per-step health gates (screening error within tolerance, mu
    # residual) catch any step where the cheap operands cannot converge
    # and rewind it to the robust/high program, so the approximation is
    # self-policing. Measured at the 50k benchmark (within-process A/B,
    # docs/perf_notes.md): +5.4% alone, +26% combined with the fast
    # inner-iteration count and scan unroll 2. Only meaningful with
    # screening_kernel "mxu"/"auto" on TPU.
    screening_dft_precision: str = "auto"
    # CG iterations per mu solve inside the screening fixed point. A fixed
    # count (rather than tolerance-stopped CG) makes each solve a smooth map,
    # which the fixed-point iteration needs to converge below the CG
    # tolerance; warm starts accumulate convergence across iterations, and
    # the final solve's residual feeds the failure flag, so too small a
    # count fails loudly rather than corrupting results. None = auto:
    # on the stencil backend 5 at float32 / 8 at float64 (4 when
    # poisson_solver='mg'): measured at the 50k benchmark, 5 keeps the
    # f32 screening fixed point converging in ~1 iteration/step with the
    # residual gate clear, while float64 runs chase ~1e-8 inner residuals
    # and need the deeper count; 32 on the ELL backend (weaker
    # preconditioner).
    screening_cg_iterations: Optional[int] = None
    # Inner fixed-iteration count for the FAST chunk program only
    # (chunk_failover; the robust rewind program always uses
    # screening_cg_iterations). None = auto: 3 on the float32 structured
    # fast path — the warm start carries convergence across steps in
    # steady state, and the fast program's residual/tolerance gates
    # rewind any step the shallower solve cannot hold (cold starts DO
    # trip it; the first chunks re-run robust while the transient
    # decays). Measured at the 50k benchmark (within-process A/B):
    # +12% alone over the 5-iteration fast program. Same as
    # screening_cg_iterations at float64 (parity runs keep the deep
    # count).
    screening_fast_iterations: Optional[int] = None
    # Evaluate the screening convolution at the lattice SITES with a
    # single moment-matched kernel (self term calibrated so a locally
    # constant current reproduces the exact edge-evaluated sums) and
    # interpolate to the 3 edge classes, instead of convolving each edge
    # class exactly: ~half the arithmetic, 1/3 of the inverse-transform
    # batch and intermediates. The residual is an O(h^2) discretization
    # difference of the same order as the float32 screening precision
    # floor (measured; docs/perf_notes.md). None = auto: enabled inside
    # the gated FAST chunk program at float32 (the robust rewind program
    # keeps the exact per-class convolution), disabled elsewhere.
    # True/False force it for BOTH programs (True also on float64).
    screening_site_eval: Optional[bool] = None
    # Fixed-point accelerator for the screening iteration: "anderson"
    # (depth-1 Anderson/secant acceleration — converges in ~10-15 iterations
    # where the reference's fixed-coefficient Polyak scheme crawls at
    # contraction ~0.99 and hits its iteration cap on strongly-coupled
    # geometries) or "polyak" (the reference's heavy-ball scheme,
    # ``tdgl/solver/solver.py:565-569``).
    screening_solver: str = "anderson"
    # Precision floor for the *effective* screening tolerance (None = auto,
    # 0 disables). At float32 the coupled psi/mu/A map has an irreducible
    # noise ball: psi rounding (~1.2e-7 relative) is amplified by the
    # div -> Poisson-solve -> grad chain into ~3e-4 relative fluctuation of
    # the induced vector potential (measured; the floor persists even when
    # the whole observening chain runs in float64 from the f32 psi). Chasing
    # tolerances below it cannot converge, so the effective tolerance is
    # max(screening_tolerance, floor): auto = 5e-4 (global norm) / 3e-3
    # (per-edge norm) at float32, 0 at float64.
    screening_tolerance_floor: Optional[float] = None
    # Relative residual tolerance of the mu solve. None = auto: 1e-4 at
    # float32, 1e-6 at float64. Measured against full float64 references
    # on transport AND vortex-dynamics workloads (tools/tol_study.py,
    # docs/perf_notes.md): psi and mu errors vs float64 are identical for
    # mu tolerances from 3e-6 all the way to 1e-3 (float32 rounding of the
    # inputs dominates both), so tightening below 1e-4 only buys extra
    # solver iterations (~1 full MG-CG iteration per factor ~20 in the
    # benchmark's hard window). Explicit values are always honored
    # (floored at 50*eps of the working precision).
    poisson_tolerance: Optional[float] = None
    poisson_max_iterations: int = 1500
    # If set (> 0), run exactly this many CG iterations per mu solve
    # (lax.fori_loop with no convergence branch) instead of tolerance-stopped
    # CG. The solve becomes fixed-cost and fully pipelineable; with warm
    # starts a small fixed count typically tracks the tolerance-stopped
    # solution closely. The final residual still feeds the solver's failure
    # flag, so an insufficient count fails loudly, not silently.
    # None = auto: 2 fixed iterations (plus the tolerance-stopped top-up)
    # on the float32 structured deep-multigrid path — the fixed phase
    # covers steady/smooth steps and the top-up supplies what hard
    # (vortex-entry / dense-lattice) steps still need, measured ~3 total
    # iterations/step in the 50k benchmark's hard window with the default
    # "previous" warm start. Tolerance-stopped everywhere else. 0 = force
    # tolerance-stopped CG.
    poisson_fixed_iterations: Optional[int] = None
    # Warm-start guess for the mu-Poisson solve: "previous" (default)
    # warm-starts from mu_n; "extrapolate" uses the linear predictor
    # ``2 mu_n - mu_{n-1}``. Measured on the 50k benchmark: in smooth,
    # well-resolved regimes extrapolation cuts the warm-start residual
    # ~4x, but in marginally-resolved regimes (dense vortex lattice at
    # dt_max) successive mu changes decorrelate and extrapolation
    # AMPLIFIES the residual 1.6x (quadratic: 2.8x) — and at the float32
    # tolerance both guesses converge in ~2 iterations in smooth regimes
    # anyway, so "previous" is the better default.
    poisson_warm_start: str = "previous"
    # mu-solve algorithm on the stencil backend: "cg" (tolerance-stopped
    # MG-preconditioned CG, the default) or "mg" (tolerance-stopped
    # multigrid-Richardson — cheaper per iteration, no CG acceleration;
    # the per-step residual check fails the run if tolerance is missed).
    poisson_solver: str = "cg"
    poisson_preconditioner: str = "amg"   # "amg" (two-level) or "jacobi"
    # Performance router for the unstructured (ELL, gather-based) backend.
    # History: round 2 measured reproducible TPU kernel faults for large
    # gather programs (~50k sites), which this fence originally guarded
    # against. Round 5 re-measured on the then-current runtime
    # (tools/ell_fault_probe.py, tools/unstructured_solve_probe.py): the
    # fault is GONE — the full production ELL solve completes cleanly on
    # TPU at 50k sites — but it runs gather-bound at 9.0 steps/s vs 32.4
    # steps/s for the SAME workload on the host CPU (3.6x), because the
    # TPU has no fast general scatter/gather and every CG iteration is a
    # neighbor gather. So the fence remains as a measured performance
    # router: unstructured meshes larger than this limit execute on the
    # host CPU with a warning. Set to None to force on-accelerator
    # execution (works, slow). Structured meshes
    # (make_mesh(structured=True)) are unaffected — they are the fast
    # TPU path at scale (~1000x at 50k: 8,863 steps/s).
    unstructured_tpu_site_limit: Optional[int] = 30_000
    amg_coarsening: Optional[int] = None  # aggregate size (None = auto)
    steps_per_chunk: Optional[int] = None
    profile_dir: Optional[str] = None  # write a jax.profiler trace here
    # Fused single-pass Pallas kernels for the stencil step body (psi
    # update, Poisson RHS). None = auto = OFF: measured on the 50k
    # benchmark they lose to XLA's roll-chain formulation (XLA already
    # runs each stencil op at the HBM roofline and pipelines across the
    # scan; the pallas_call fusion barrier costs more than it saves —
    # docs/perf_notes.md). Kept available and parity-pinned
    # (tests/test_pallas_step.py) as the honest record. Incompatible with
    # spatial sharding — shard_solver_spatially rebuilds without it.
    pallas_step: Optional[bool] = None
    # Premultiply the FV weights into the hoisted (static-A) link phases
    # so the psi update reads 12 planes instead of 18 (the step is
    # HBM-bandwidth bound). Same math up to rounding order. None = auto:
    # on for float32 structured solves (float64 keeps the reference
    # rounding order for the step-for-step oracle parity pins).
    fold_link_weights: Optional[bool] = None
    # Rank-structured link phases (stencil backend, static applied
    # potential): when the per-edge phase angle separates as
    # ``a_k(r, c) = f_k(r) + g_k(c)`` — exactly true for any uniform
    # applied field in the symmetric gauge on the structured lattice —
    # the link planes are reconstructed inside the hot kernels from four
    # O(rows)+O(cols) trig VECTORS (angle addition, no transcendentals),
    # so the psi update reads only the 3 raw weight planes and the
    # supercurrent no link planes at all. None = auto: on for float32
    # structured static-A solves when a float64 separability check of the
    # applied potential passes (silently falls back to folded planes when
    # it does not); True on a non-separable potential raises.
    # Reconstruction agrees with direct cos/sin to ~1 ulp; float64 keeps
    # the reference rounding order for the oracle parity pins.
    factor_link_phases: Optional[bool] = None
    # lax.scan unroll factor for the compiled chunk loop. None = auto:
    # 2 on the structured unscreened chunk (+12% measured on the 50k TPU
    # benchmark — XLA overlaps one step's serial reductions with the
    # neighbor step's elementwise work) and on the structured screened
    # FAST program (+10% within-process A/B; the robust screened program
    # keeps 1 — its fixed-point while_loop body does not unroll). Pure
    # scheduling: the per-step math is unchanged. Higher values raise
    # compile time and measured net negative at 4 (docs/perf_notes.md).
    scan_unroll: Optional[int] = None
    # "Steady fast chunk" with chunk-level failover (stencil backend):
    # compile the chunk WITHOUT the per-step dt-retry and mu-top-up
    # while_loops — a single psi attempt and a fixed-count mu solve per
    # step; with screening, additionally ONE inline screening iteration
    # instead of the fixed-point while_loop (steady-state measured mean
    # is exactly 1.00 iterations/step) — and gate each step's health
    # instead (psi solve accepted; screening error within tolerance; mu
    # residual <= 10x poisson_tolerance, a band measured to
    # have no observable physics effect, docs/validation.md). When any
    # step in a chunk trips a gate, the solver transparently rewinds to
    # the chunk-start state and re-runs that chunk with the robust
    # while_loop program (compiled lazily on first use), so anomalous
    # steps are still repaired exactly as without this option — the fast
    # program only ever commits chunks whose every step passed. Rationale:
    # the two loop barriers cost ~7% of step time even on benchmark
    # windows where they NEVER fire (docs/perf_notes.md "structural
    # overhead"); steady-state TDGL evolution essentially never retries.
    # Cold starts DO retry (the dt ramp overshoots within the first
    # chunk), so a from-scratch solve typically fails over exactly once
    # on its first chunk and runs fast thereafter; warm starts
    # (seed_solution / resume_from) run fast from chunk one.
    # "auto" (default) = on for structured solves (screened too); "on"
    # forces it (error on unsupported modes); "off" disables.
    chunk_failover: str = "auto"
    # Compute the mu solve's fixed 2-iteration phase as one blocked 2D
    # Krylov (s-step) minimization: mathematically identical to 2 PCG
    # iterations, but the five Gram scalars form ONE independent
    # reduction batch instead of four sequential reduction->scalar->
    # broadcast sync points. Applies when the auto fixed-2 MG-CG solve is
    # active. None = auto (measured on-TPU per docs/perf_notes.md).
    poisson_sstep: Optional[bool] = None
    # Store the folded link tables in bfloat16: halves their read
    # bandwidth (+5% measured end-to-end on the 50k benchmark) at a
    # ~4e-3 relative perturbation of the link phases (~0.4% effective
    # applied-field error). MEASURED PHYSICS IMPACT (docs/validation.md):
    # near vortex-entry degeneracies the perturbation selects a different
    # equilibrium (observed: 6 vs 4 vortices in a test film, magnetic
    # moment off 5.7%, transport voltage off 9%, where plain f32 matches
    # f64 to <0.05%). REJECTED as a default for that reason; available
    # for speed-over-accuracy scans where a 0.4% field error is
    # acceptable.
    link_phase_bf16: bool = False
    # Write a full-state checkpoint (group "checkpoint" in the output
    # file, overwritten at every snapshot) from which a run can be resumed
    # EXACTLY via solve(..., resume_from=path): the checkpoint carries the
    # complete device-resident state pytree (psi, mu and its predictor,
    # currents, induced/applied A, the adaptive-dt window, time/step), so
    # the resumed trajectory is step-for-step identical to an
    # uninterrupted run. This goes beyond the reference, whose only warm
    # restart (seed_solution) re-seeds psi/mu but loses the integrator
    # state (``tdgl/solver/solver.py:113,732-752``). Costs one extra
    # host fetch of the state per snapshot; disable for maximum-throughput
    # runs that never need resuming.
    save_checkpoints: bool = True
    # Enable jax's persistent compilation cache (per-user directory,
    # ~/.cache/tdgl_tpu/jax_cache) when constructing a solver: the
    # production chunk program takes minutes to compile on TPU cold, and
    # seconds warm. NOTE this mutates process-wide jax config
    # (jax_compilation_cache_dir) as a side effect — set False when
    # embedding tdgl_tpu in an application that manages its own jax cache
    # config (a user-configured jax cache dir is always left untouched;
    # env opt-out: TDGL_TPU_NO_COMPILE_CACHE=1).
    compilation_cache: bool = True

    def validate(self) -> None:
        if self.dt_init > self.dt_max:
            raise SolverOptionsError(
                "dt_init must be less than or equal to dt_max."
            )
        if self.terminal_psi is not None and not (
            0 <= abs(self.terminal_psi) <= 1
        ):
            raise SolverOptionsError(
                "terminal_psi must be None or have absolute value in [0, 1]"
                f" (got {self.terminal_psi})."
            )
        if not (0 < self.adaptive_time_step_multiplier < 1):
            raise SolverOptionsError(
                "adaptive_time_step_multiplier must be in (0, 1)"
                f" (got {self.adaptive_time_step_multiplier})."
            )
        if not (0 < self.screening_step_drag <= 1):
            raise SolverOptionsError(
                "screening_step_drag must be in (0, 1]"
                f" (got {self.screening_step_drag})."
            )
        if self.screening_step_size <= 0:
            raise SolverOptionsError(
                f"screening_step_size must be > 0 (got {self.screening_step_size})."
            )
        if self.screening_tolerance <= 0:
            raise SolverOptionsError(
                f"screening_tolerance must be > 0 (got {self.screening_tolerance})."
            )
        if self.dtype not in ("float32", "float64"):
            raise SolverOptionsError(
                f"dtype must be 'float32' or 'float64' (got {self.dtype})."
            )
        if self.solver_backend not in ("auto", "stencil", "ell"):
            raise SolverOptionsError(
                "solver_backend must be 'auto', 'stencil', or 'ell'"
                f" (got {self.solver_backend})."
            )
        if self.screening_solver not in ("anderson", "polyak"):
            raise SolverOptionsError(
                "screening_solver must be 'anderson' or 'polyak'"
                f" (got {self.screening_solver})."
            )
        if self.screening_error_norm not in ("auto", "per_edge", "global"):
            raise SolverOptionsError(
                "screening_error_norm must be 'auto', 'per_edge', or"
                f" 'global' (got {self.screening_error_norm})."
            )
        if (self.screening_fast_iterations is not None
                and int(self.screening_fast_iterations) < 1):
            raise SolverOptionsError(
                "screening_fast_iterations must be >= 1"
                f" (got {self.screening_fast_iterations})."
            )
        if self.scan_unroll is not None and int(self.scan_unroll) < 1:
            raise SolverOptionsError(
                f"scan_unroll must be >= 1 (got {self.scan_unroll})."
            )
        if self.chunk_failover not in ("auto", "on", "off"):
            raise SolverOptionsError(
                "chunk_failover must be 'auto', 'on', or 'off'"
                f" (got {self.chunk_failover})."
            )
        if self.screening_dft_precision not in ("auto", "high", "bf16"):
            raise SolverOptionsError(
                "screening_dft_precision must be 'auto', 'high', or 'bf16'"
                f" (got {self.screening_dft_precision})."
            )
        if self.screening_kernel not in ("auto", "fft", "xla", "mxu"):
            raise SolverOptionsError(
                "screening_kernel must be 'auto', 'fft', 'xla', or 'mxu'"
                f" (got {self.screening_kernel})."
            )
        if self.poisson_warm_start not in ("previous", "extrapolate"):
            raise SolverOptionsError(
                "poisson_warm_start must be 'previous' or 'extrapolate'"
                f" (got {self.poisson_warm_start})."
            )
        if self.poisson_solver not in ("cg", "mg"):
            raise SolverOptionsError(
                f"poisson_solver must be 'cg' or 'mg' (got"
                f" {self.poisson_solver})."
            )
        if self.poisson_solver == "mg" and \
                self.poisson_preconditioner != "amg":
            raise SolverOptionsError(
                "poisson_solver='mg' requires poisson_preconditioner='amg'."
            )
        if self.poisson_preconditioner not in ("amg", "jacobi"):
            raise SolverOptionsError(
                "poisson_preconditioner must be 'amg' or 'jacobi'"
                f" (got {self.poisson_preconditioner})."
            )
        if isinstance(self.sparse_solver, str):
            try:
                self.sparse_solver = SparseSolver[self.sparse_solver.upper()]
            except KeyError:
                raise SolverOptionsError(
                    f"sparse_solver must be one of"
                    f" {list(SparseSolver.__members__)} (got"
                    f" {self.sparse_solver})."
                )
        if self.save_every < 1:
            raise SolverOptionsError("save_every must be >= 1.")
