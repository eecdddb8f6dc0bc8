"""Step configuration and per-step outputs of the TDGL time step.

The two records of :mod:`tdgl_tpu.solver.step` that the grid backend
shares (``StepConfig``, ``StepOutputs``), copied verbatim; the fields keep
the JAX package's names and comments so a reader can find each
counterpart. The traced inputs (``A_fn``, ``eps_fn``, ``mu_boundary_fn``)
map a 0-d time tensor to tensors on the solve's device. Fields of TPU-only
options have no effect in this package: ``use_pallas_step``,
``screening_fft_mxu``, ``screening_dft_bf16``, ``screening_eval_fn``,
``poisson_use_mg``, ``poisson_sstep``, ``fold_link_weights``,
``link_bf16`` and ``scan_unroll`` (the solver raises for the options that
would set them; see :mod:`.solver`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class StepOutputs(NamedTuple):
    """Per-step scalars recorded by the runner (cf. RunningState).

    ``valid`` is int32 (1/0) rather than bool: some constrained backends
    cannot transfer boolean buffers to the host.
    """

    dt: torch.Tensor
    time: torch.Tensor
    mu_probe: torch.Tensor         # (P,)
    theta_probe: torch.Tensor      # (P,)
    screening_iterations: torch.Tensor
    cg_iterations: torch.Tensor
    valid: torch.Tensor            # int32 — 0 for frozen (post-done) slots


@dataclass(frozen=True)
class StepConfig:
    """Static configuration compiled into the step function."""

    gamma: float
    u: float
    adaptive: bool
    dt_init: float
    dt_max: float
    adaptive_window: int
    max_solve_retries: int
    adaptive_time_step_multiplier: float
    include_screening: bool
    screening_tolerance: float
    screening_step_size: float
    screening_step_drag: float
    max_iterations_per_step: int
    poisson_tolerance: float
    poisson_max_iterations: int
    probe_ix: Optional[tuple] = None          # tuple of site indices
    # Jax-traceable time-dependent inputs (fast path). Each maps a scalar
    # time to the full array; None means the corresponding state field is
    # used as-is (static, or host-updated between chunks).
    A_fn: Optional[Callable] = None           # t -> (E, 2)
    eps_fn: Optional[Callable] = None         # t -> (N,)
    mu_boundary_fn: Optional[Callable] = None  # t -> (B,)
    # Two-level AMG preconditioner for the mu solve (None -> Jacobi). The
    # device arrays travel as a traced argument; only the static flag and
    # smoothing weight live here.
    use_amg: bool = False
    # Scalar damping, or a tuple of per-sweep dampings (Chebyshev pairs);
    # see ops.hexmg.make_hexmg_apply.
    amg_omega: object = 0.9
    # Globally-normalized screening error (f32 path; see SolverOptions
    # ``screening_error_norm``) instead of the reference's per-edge ratio.
    screening_global_error_norm: bool = False
    # Exact FFT-convolution induced-A kernel (structured backend only).
    screening_use_fft: bool = False
    # Evaluate the convolution's transforms as dense DFT matmuls on the
    # MXU instead of XLA FFTs (ops.fft_screening.induced_vector_potential
    # _mxu — same math, parity-tested; XLA's TPU FFT lowering is
    # lane-shuffle-bound).
    screening_fft_mxu: bool = False
    # Run the MXU DFT matmuls at bf16x1 operand precision (~1e-3 relative
    # kernel perturbation — a deterministic operator within the f32
    # screening envelope) instead of bf16x3. Opt-in speed/precision trade;
    # see SolverOptions.screening_dft_precision.
    screening_dft_bf16: bool = False
    # Evaluate the screening convolution at the lattice SITES with a
    # single moment-matched kernel and interpolate to the 3 edge classes
    # (ops.fft_screening.induced_vector_potential_*_site): ~half the
    # arithmetic and 1/3 the intermediates of the exact per-edge-class
    # convolution, for an O(h^2) discretization difference of the same
    # order as the f32 screening floor. See
    # SolverOptions.screening_site_eval.
    screening_site_eval: bool = False
    # Static per-class near-field correction stencils for the site path
    # (ops.fft_screening.build_site_interp_taps): a hashable tuple of
    # ((dr, dc), value) taps per edge class, baked into the compiled
    # chunk (roll offsets must be trace-time constants). None when the
    # mesh margins make the tap rolls wrap-unsafe — site evaluation is
    # then unavailable.
    screening_site_taps: Optional[tuple] = None
    # CG iterations per mu solve inside the screening fixed point (fixed
    # count -> smooth map; see ``observables``).
    screening_cg_iters: int = 32
    # Fixed CG iteration count for every mu solve (None = tolerance-stopped).
    poisson_fixed_iters: Optional[int] = None
    # Stencil backend: fixed multigrid-Richardson cycles instead of CG.
    poisson_use_mg: bool = False
    # Compute the fixed 2-iteration phase of the mu solve as one blocked
    # 2D Krylov step (ops.cg.cg_solve_2step_topup): exact-arithmetic-same
    # as 2 PCG iterations with 3 fewer reduction sync points.
    poisson_sstep: bool = False
    # Anderson(1) acceleration for the screening fixed point (False =
    # reference-style Polyak heavy ball).
    screening_anderson: bool = True
    # Warm-start the mu solve from the linear extrapolation
    # ``2 mu_n - mu_{n-1}`` instead of ``mu_n`` (see
    # SolverOptions.poisson_warm_start). Pure solver-guess change: with
    # tolerance-stopped CG the solution is unchanged; with fixed-iteration
    # solves it lands ~4x closer (measured).
    poisson_predictor: bool = False
    # Override for the FFT screening evaluation: a callable
    # ``(fft_data, sten, J_weighted) -> (3, Rp, Cp, 2)`` replacing
    # ops.fft_screening.induced_vector_potential_fft. Used by
    # parallel/fft_sharded.py to run the convolution as per-device pencil
    # FFTs under spatial sharding (hashed by identity for the chunk
    # cache, like A_fn).
    screening_eval_fn: Optional[Callable] = None
    # Stencil backend, static-A fast path: premultiply the FV weights into
    # the hoisted link phases (models.gtdgl_stencil.FoldedLinkPhases) so
    # the covariant Laplacian reads 6 planes/step instead of 15 (the
    # negative-edge planes are derived as rolls of the positive-edge
    # products — exact) — plane reads ARE the cost (HBM-bound). Same math
    # up to f32 rounding order.
    fold_link_weights: bool = False
    # Stencil backend, static separable-A fast path: reconstruct the link
    # planes in-kernel from factored row/col trig vectors
    # (models.gtdgl_stencil.FactoredLinkPhases) — no link-plane HBM reads
    # at all. Enabled by the solver only after a float64 separability
    # check of the applied potential; supersedes fold_link_weights.
    factor_link_phases: bool = False
    # Store the folded link tables in bfloat16 (halves their read
    # bandwidth; ~4e-3 relative perturbation of the link phases — f32
    # accumulation via mixed-precision promotion). Physics-gated.
    link_bf16: bool = False
    # lax.scan unroll factor for the chunk loop. >1 lets XLA interleave
    # independent work of adjacent steps (the step's serial reductions
    # overlap the next step's elementwise planes) at higher compile cost.
    # Pure scheduling — the per-step math is unchanged. Measured on the
    # 50k TPU benchmark: unroll 2 +12% end-to-end, unroll 4 net negative
    # (docs/perf_notes.md).
    scan_unroll: int = 1
    # Stencil backend "steady fast chunk": strip the per-step retry and
    # top-up while_loops from the compiled chunk entirely (single psi
    # attempt, fixed-count mu solve) and FLAG any step whose psi solve
    # rejects or whose mu residual exceeds ``poisson_fail_gate`` instead
    # of repairing it in-program. The solver pairs this program with
    # chunk-level failover: on a flag, the host rewinds to the chunk-start
    # state (chunk inputs are not donated) and re-runs the chunk with the
    # robust while_loop program, so the accepted trajectory never contains
    # a flagged step. Measured motivation: the two loop barriers cost
    # ~7% of step time at the 50k benchmark even on windows where they
    # never fire (docs/perf_notes.md "structural overhead").
    fast_chunk: bool = False
    # Residual gate for fast-chunk steps (same norm as poisson_tolerance).
    # Steps landing in (poisson_tolerance, poisson_fail_gate] are accepted
    # without top-up — the band sits inside the physics-validated
    # mu-tolerance envelope (docs/validation.md measured no observable
    # drift up to 1e-3) — anything above triggers chunk failover. 0.0
    # means "use the robust gate" (only meaningful with fast_chunk).
    poisson_fail_gate: float = 0.0
    # Stencil backend: fused single-pass Pallas kernels for the psi update
    # and the Poisson RHS (ops.pallas_step) instead of the roll-chain XLA
    # formulation. Each input plane is read from HBM exactly once; physics
    # identical (parity-pinned). Requires the grid to fit VMEM as a single
    # block (fine at the (256, 384) benchmark scale) and is incompatible
    # with spatial sharding (a pallas_call cannot be auto-partitioned), so
    # shard_solver_spatially rebuilds the chunk without it.
    use_pallas_step: bool = False
