"""The TDGL time step of the unstructured (ELL) backend, and the step
configuration and per-step outputs both backends share.

Port of :mod:`tdgl_tpu.solver.step`. ``StepConfig`` and ``StepOutputs`` are
copied verbatim; the fields keep the JAX package's names and comments so a
reader can find each counterpart. The traced inputs (``A_fn``, ``eps_fn``,
``mu_boundary_fn``) map a 0-d time tensor to tensors on the solve's device.
Fields of TPU-only options have no effect in this package:
``use_pallas_step``, ``screening_fft_mxu``, ``screening_dft_bf16``,
``screening_eval_fn``, ``poisson_use_mg``, ``poisson_sstep``,
``fold_link_weights``, ``link_bf16`` and ``scan_unroll`` (the solver raises
for the options that would set them; see :mod:`.solver`).

The ELL step (:func:`make_step_fn`, :func:`make_chunk_fn`) follows the JAX
step statement for statement on the tables of
:mod:`tdgl_tpu_torch.models.gtdgl`: the implicit-Euler psi update with
dt-shrinking discriminant retries, the supercurrent, the CG mu solve
(tolerance-stopped by default), the normal current, the optional screening
fixed point (Anderson(1) or Polyak, global or per-edge error), and the
adaptive dt. The JAX package's ``while_loop``s become Python loops that
read their condition from the device: per step, one read of ``done``, one
of the psi update's ``ok`` (adaptive dt) per attempt, one per CG stopping
test, and, with screening, one of the fixed point's continue flag per
iteration and one before the first (:func:`screening_fixed_point`). The ELL backend has no fast chunk program
(as in the JAX package).

The ELL chunk also runs a batch of B independent runs (the members of a
parameter sweep) when the state carries a leading member axis (``psi``
``(B, N, 2)``, the scalars ``(B,)``; shared fields keep their single-run
shapes), with the loops gated per member as the JAX package's vmapped
``while_loop``s are: per step one read of ``all(done)``, one of
``any(!ok)`` per attempt, one per CG iteration and, with screening, one
of ``any(active)`` per fixed-point iteration for the whole batch. A
finished member is frozen while the others go on, and its slots emit
zeros. A traced Neumann term is single-run only. The helpers below
(:func:`adaptive_window`, :func:`retry_members`,
:func:`screening_fixed_point`, ...) serve both backends.

One departure from the JAX ELL program, in work done and not in results:
the JAX ELL fixed point does not test ``done``, so under ``vmap`` a member
that has finished (or failed) spins up to ``max_iterations_per_step``
iterations on every later ghost step of its batch, whose results the
chunk then discards. Here the ELL fixed point is gated on ``done`` as the
structured one is, so a ghost step runs no iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..models import gtdgl
from ..ops.cg import member_view, solve_mu_poisson
from ..ops.screening import induced_vector_potential


class SolverState(NamedTuple):
    """The full device-resident solver state of the ELL backend."""

    psi: torch.Tensor              # (N, 2) re/im pair
    mu: torch.Tensor               # (N,)
    mu_prev: torch.Tensor          # (N,) — previous step's mu (predictor)
    supercurrent: torch.Tensor     # (E,)
    normal_current: torch.Tensor   # (E,)
    A_induced: torch.Tensor        # (E, 2)
    A_applied: torch.Tensor        # (E, 2) — current applied potential
    epsilon: torch.Tensor          # (N,)
    mu_boundary: torch.Tensor      # (B,) current-density BC per boundary
                                   # edge
    dA_dt: torch.Tensor            # (E,) edge-projected dA/dt
    tentative_dt: torch.Tensor     # 0-d
    prev_dt: torch.Tensor          # 0-d — dt used in the previous step
    time: torch.Tensor             # 0-d
    step: torch.Tensor             # 0-d int32 — step index in the stage
    dpsi_window: torch.Tensor      # (W,) ring buffer of max |d|psi|^2|
    end_time: torch.Tensor         # 0-d — stage end time
    done: torch.Tensor             # 0-d bool
    failed: torch.Tensor           # 0-d bool (retry/screening failure)


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


def export_diagnostics(state: SolverState) -> torch.Tensor:
    """``[time, prev_dt, tentative_dt, step, done, failed]`` as float32
    (``(B, 6)`` for a batch)."""
    f = torch.float32
    return torch.stack([
        state.time.to(f),
        state.prev_dt.to(f),
        state.tentative_dt.to(f),
        state.step.to(f),
        state.done.to(f),
        state.failed.to(f),
    ], dim=-1)


def export_state_arrays(state: SolverState):
    """The full state as real-typed tensors (psi split into re/im)."""
    return dict(
        psi_real=state.psi[..., 0],
        psi_imag=state.psi[..., 1],
        mu=state.mu,
        supercurrent=state.supercurrent,
        normal_current=state.normal_current,
        induced_vector_potential=state.A_induced,
        applied_vector_potential=state.A_applied,
        epsilon=state.epsilon,
        diagnostics=export_diagnostics(state),
    )


def member_sum(x: torch.Tensor, nd: int) -> torch.Tensor:
    """``sum(x)`` over the last ``nd`` dims: the whole tensor for a single
    run, per member for a batch."""
    if x.dim() == nd:
        return torch.sum(x)
    return torch.sum(x, dim=tuple(range(-nd, 0)))


def induced_potential_update(cfg: StepConfig, s: int, A_ind, A_new,
                             velocity, x_prev, nd: int):
    """One update of the screening fixed point (iteration ``s``) from the
    iterate ``A_ind`` and its image ``A_new``: depth-1 Anderson (secant)
    acceleration, where ``velocity`` carries the previous residual and
    ``x_prev`` the previous iterate, or the Polyak heavy ball. Shared by
    both backends (any layout with the x/y pair last); ``nd`` is the rank
    of one member's potential, so a batch (one more leading dim) takes
    Anderson's coefficient per member. Returns ``(A_ind, velocity,
    x_prev, dA)`` after the update."""
    dA = A_new - A_ind
    if not cfg.screening_anderson:
        velocity = ((1.0 - cfg.screening_step_drag) * velocity
                    + cfg.screening_step_size * dA)
        return A_ind + velocity, velocity, x_prev, dA
    if s == 0:
        A_ind_u = A_ind + cfg.screening_step_size * dA
    else:
        dr = dA - velocity
        denom = torch.clamp(member_sum(dr * dr, nd),
                            min=torch.finfo(dA.dtype).tiny)
        theta = torch.clamp(member_sum(dA * dr, nd) / denom, -10.0, 10.0)
        theta = member_view(theta, A_new)
        A_ind_u = (1.0 - theta) * A_new + theta * (x_prev + velocity)
    return A_ind_u, dA, A_ind, dA


def vector_scale(A: torch.Tensor, nd: int) -> torch.Tensor:
    """The largest ``|A|`` of a potential whose one-member rank is
    ``nd`` (x/y pair last): 0-d for a single run or a potential all
    members share, ``(B,)`` per member for a batch."""
    return plane_max(torch.sqrt(torch.sum(A * A, dim=-1)), nd - 1)


def screening_error(cfg: StepConfig, dA, A_ind, app_scale, nd: int):
    """The fixed point's error after an update: ``max |dA| / max |A|``
    with the denominator floored at 1e-2 of the applied potential's
    largest ``|A|`` (``app_scale``; the global norm), or the reference's
    largest per-edge ratio ``|dA_e| / |A_e|``. ``nd`` as in
    :func:`induced_potential_update`: a batch's error is per member."""
    dA_norm = torch.sqrt(torch.sum(dA * dA, dim=-1))
    A_norm = torch.sqrt(torch.sum(A_ind * A_ind, dim=-1))
    if cfg.screening_global_error_norm:
        denom = torch.maximum(plane_max(A_norm, nd - 1),
                              torch.clamp(0.01 * app_scale, min=1e-20))
        return plane_max(dA_norm, nd - 1) / denom
    return plane_max(dA_norm / torch.clamp(A_norm, min=1e-20), nd - 1)


def screening_fixed_point(cfg: StepConfig, s_body, carry, err, done):
    """The robust program's screening fixed point (both backends): the
    JAX package's ``while_loop``, vmapped for a batch.
    ``s_body(s, carry) -> (carry, fail, err)`` runs iteration ``s`` for
    every member, and a member takes its results while it is active: not
    ``done``, its error at or above the tolerance (``err`` is the error
    before the first iteration) and within ``max_iterations_per_step``.
    An inactive member keeps its carry, error and iteration count, and its
    ``fail`` takes an iteration's only while it is active; the members
    active in iteration ``s`` have all run ``s`` iterations before it. One
    host read of ``any(active)`` per iteration for the batch (of the 0-d
    flag for a single run), so a finished (ghost) step runs none. Returns
    ``(carry, err, fail, iterations)``."""
    active = torch.logical_not(done)
    fail = torch.zeros_like(done)
    iterations = torch.zeros(done.shape, dtype=torch.int32,
                             device=done.device)
    s = 0
    while bool(active if active.dim() == 0 else torch.any(active)):
        carry_u, fail_i, err_u = s_body(s, carry)
        carry = tuple(torch.where(member_view(active, n), n, o)
                      for o, n in zip(carry, carry_u))
        err = torch.where(active, err_u, err)
        fail = torch.logical_or(fail, torch.logical_and(active, fail_i))
        iterations = iterations + active.to(torch.int32)
        s += 1
        active = torch.logical_and(active, torch.logical_and(
            err >= cfg.screening_tolerance,
            iterations <= cfg.max_iterations_per_step))
    return carry, err, fail, iterations


def traced_per_member(fn, time: torch.Tensor) -> torch.Tensor:
    """A traced input ``fn(t)`` at each member's own time (stacked), or
    at the single run's time."""
    if time.dim() == 0:
        return fn(time)
    return torch.stack([fn(t) for t in time])


def plane_max(x: torch.Tensor, nd: int) -> torch.Tensor:
    """``max(x)`` over the last ``nd`` dims: the whole tensor for a
    single run, per member for a batch."""
    if x.dim() == nd:
        return torch.max(x)
    return torch.amax(x, dim=tuple(range(-nd, 0)))


def adaptive_window(cfg, state, d_psi_sq, dt_used, window_ix):
    """The adaptive-dt ring buffer and the next tentative dt (both
    backends; per member for a batch): ``(window, tentative)``."""
    rdtype = state.dpsi_window.dtype
    W = cfg.adaptive_window
    slot = state.step % W
    if slot.dim():
        slot = slot[:, None]
        d_psi_sq = d_psi_sq[:, None]
    window = torch.where(window_ix == slot, d_psi_sq.to(rdtype),
                         state.dpsi_window)
    if not cfg.adaptive:
        return window, state.tentative_dt
    mean = (torch.mean(window) if window.dim() == 1
            else torch.mean(window, dim=-1))
    new_dt_est = cfg.dt_init / torch.clamp(mean, min=1e-10)
    tentative = torch.clamp(0.5 * (new_dt_est + dt_used), 0.0, cfg.dt_max)
    tentative = torch.where(state.step > W, tentative, state.tentative_dt)
    return window, tentative


def retry_members(psi_update, dt0, cfg):
    """The discriminant retries (both backends, a single run or a batch):
    ``psi_update(dt) -> (*fields, ok)`` is re-run with ``dt`` shrunk only
    for the members whose ``ok`` is False, and their fields replace the
    earlier ones (the JAX program's ``while_loop``, vmapped for a batch);
    one host read of ``ok`` per attempt. Returns ``(*fields, dt, fail)``."""
    out = psi_update(dt0)
    ok, dt, tries = out[-1], dt0, 0
    while tries <= cfg.max_solve_retries and not bool(
            ok if ok.dim() == 0 else torch.all(ok)):
        retry = ~ok
        dt = torch.where(retry, dt * cfg.adaptive_time_step_multiplier, dt)
        new = psi_update(dt)
        out = tuple(torch.where(member_view(retry, n), n, o)
                    for o, n in zip(out[:-1], new[:-1])) + (ok | new[-1],)
        ok = out[-1]
        tries += 1
    return out[:-1] + (dt, ~ok)


def make_step_fn(cfg: StepConfig):
    """Build the ELL step ``(op, screening_weights, amg, state, aux) ->
    (state, outputs)``.

    ``op`` holds the FV tables on the device, ``screening_weights`` the
    per-site screening prefactor ``A_scale * xi * area`` (None without
    screening), ``amg`` an :class:`~tdgl_tpu_torch.ops.amg.AMGTensors` (or
    None), and ``aux`` the chunk's device constants (see
    :func:`make_chunk_fn`).
    """

    def euler_with_retries(op, U, psi, old_sq, mu, epsilon, dt0):
        """Euler update with dt-shrinking retries (:func:`retry_members`)."""
        def update(dt):
            return gtdgl.implicit_euler_psi(op, U, psi, old_sq, mu, epsilon,
                                            cfg.gamma, cfg.u, dt)
        if cfg.adaptive:
            return retry_members(update, dt0, cfg)
        res = update(dt0)
        return res.psi, res.abs_sq_psi, dt0, torch.logical_not(res.ok)

    def observables(op, amg, U, psi, dA_dt, mu_boundary, mu_guess,
                    fixed_iters=None):
        """Supercurrent, mu (CG) and normal current, and the CG iteration
        count and residual. ``fixed_iters`` (inside the screening fixed
        point) runs a fixed count with no top-up: a smooth map."""
        J_s = gtdgl.supercurrent_on_edges(op, U, psi)
        rhs = gtdgl.poisson_rhs(op, J_s, dA_dt, mu_boundary)
        topup = fixed_iters is None
        if fixed_iters is None:
            fixed_iters = cfg.poisson_fixed_iters
        cg = solve_mu_poisson(
            op, rhs, mu_guess,
            tol=cfg.poisson_tolerance, maxiter=cfg.poisson_max_iterations,
            amg=(amg if cfg.use_amg else None), amg_omega=cfg.amg_omega,
            fixed_iters=fixed_iters, topup=topup,
        )
        J_n = -gtdgl.gradient_on_edges(op, cg.x) - dA_dt
        return J_s, cg.x, J_n, cg.iterations, cg.residual_norm

    def residual_allowed(rdtype):
        # Fixed-iteration CG has no internal stopping test; 2x the CG
        # precision floor keeps the gate for gross failure.
        return max(cfg.poisson_tolerance, 100.0 * torch.finfo(rdtype).eps)

    def step(op, screening_weights, amg, state: SolverState, aux):
        n_sites = op.areas.shape[0]
        rdtype = state.mu.dtype
        time = state.time
        if time.dim() and cfg.mu_boundary_fn is not None:
            raise NotImplementedError(
                "member-batched chunks run without a traced Neumann term")
        # --- time-dependent inputs (traced path) ---
        if cfg.A_fn is not None:
            A_applied = traced_per_member(cfg.A_fn, time).to(rdtype)
            dA_dt = torch.sum(
                (A_applied - state.A_applied)
                / member_view(state.prev_dt, A_applied)
                * aux["unit_dirs"], dim=-1)
        else:
            A_applied = state.A_applied
            dA_dt = state.dA_dt
        epsilon = (traced_per_member(cfg.eps_fn, time).to(rdtype)
                   if cfg.eps_fn is not None else state.epsilon)
        mu_boundary = (cfg.mu_boundary_fn(time).to(rdtype)
                       if cfg.mu_boundary_fn is not None
                       else state.mu_boundary)

        old_sq = torch.sum(state.psi * state.psi, dim=-1)
        dt0 = state.tentative_dt

        def tdgl_update(psi_in, mu_in, A_induced, dt, fixed_iters=None,
                        solve_guess=None):
            # Within the screening fixed point the previous iterate's psi
            # and mu feed the Euler update, with |psi^n|^2 kept as the old
            # superfluid density (the reference's semantics).
            U = aux.get("U")
            if U is None:
                A_total = (A_applied + A_induced if cfg.include_screening
                           else A_applied)
                U = gtdgl.edge_link_phases(A_total, op.edge_directions)
            psi_n, sq_n, dt_used, fail = euler_with_retries(
                op, U, psi_in, old_sq, mu_in, epsilon, dt)
            J_s, mu_n, J_n, cg_iters, cg_res = observables(
                op, amg, U, psi_n, dA_dt, mu_boundary,
                mu_in if solve_guess is None else solve_guess,
                fixed_iters=fixed_iters)
            return (psi_n, sq_n, mu_n, J_s, J_n, dt_used, fail, cg_iters,
                    cg_res)

        if cfg.include_screening:
            app_scale = vector_scale(A_applied, 2)

            def s_body(s, carry):
                """One fixed-point iteration from ``carry = (dt, A_ind,
                velocity, x_prev, psi, mu, ...)``; the psi update starts
                from the iterate with the step's ``|psi|^2``."""
                dt, A_ind, velocity, x_prev, psi_n, mu_n = carry[:6]
                (psi_u, sq_u, mu_u, J_s_u, J_n_u, dt_u, fail_i, cg_iters_u,
                 cg_res_u) = tdgl_update(psi_n, mu_n, A_ind, dt,
                                         fixed_iters=cfg.screening_cg_iters)
                J_site = gtdgl.edge_quantity_to_sites(
                    op, J_s_u + J_n_u, n_sites, aux["unit_dirs"])
                Jw = J_site * aux["screen_w"]
                A_new = induced_vector_potential(aux["edge_centers"],
                                                 aux["sites"], Jw)
                A_ind_u, velocity_u, x_prev_u, dA = induced_potential_update(
                    cfg, s, A_ind, A_new, velocity, x_prev, 2)
                err_u = screening_error(cfg, dA, A_ind_u, app_scale, 2)
                return ((dt_u, A_ind_u, velocity_u, x_prev_u, psi_u, mu_u,
                         sq_u, J_s_u, J_n_u, cg_iters_u, cg_res_u), fail_i,
                        err_u)

            zeros_e = torch.zeros(op.edges.shape[0], dtype=rdtype,
                                  device=state.mu.device)
            big = torch.full((), 1e30, dtype=rdtype, device=state.mu.device)
            carry = (dt0, state.A_induced, torch.zeros_like(state.A_induced),
                     state.A_induced, state.psi, state.mu, old_sq, zeros_e,
                     zeros_e, aux["zero_i32"], big)
            carry, err, fail, screening_iters = screening_fixed_point(
                cfg, s_body, carry, big, state.done)
            (dt_used, A_induced, _, _, psi_n, mu_n, sq_n, J_s, J_n, cg_iters,
             cg_res) = carry
            fail = torch.logical_or(fail, err >= cfg.screening_tolerance)
            fail = torch.logical_or(fail, cg_res > residual_allowed(rdtype))
        else:
            guess = (2.0 * state.mu - state.mu_prev
                     if cfg.poisson_predictor else None)
            (psi_n, sq_n, mu_n, J_s, J_n, dt_used, fail, cg_iters,
             cg_res) = tdgl_update(state.psi, state.mu, state.A_induced,
                                   dt0, solve_guess=guess)
            if cfg.poisson_fixed_iters is not None:
                fail = torch.logical_or(fail,
                                        cg_res > residual_allowed(rdtype))
            A_induced = state.A_induced
            screening_iters = aux["zero_i32"]

        # --- adaptive time-step selection ---
        d_psi_sq = plane_max(torch.abs(sq_n - old_sq), 1)
        window, tentative = adaptive_window(cfg, state, d_psi_sq, dt_used,
                                            aux["window_ix"])

        new_state = SolverState(
            psi=psi_n,
            mu=mu_n,
            mu_prev=state.mu,
            supercurrent=J_s,
            normal_current=J_n,
            A_induced=A_induced,
            A_applied=A_applied,
            epsilon=epsilon,
            mu_boundary=mu_boundary,
            dA_dt=dA_dt,
            tentative_dt=tentative.to(rdtype),
            prev_dt=dt_used.to(rdtype),
            time=time + dt_used,
            step=state.step + 1,
            dpsi_window=window,
            end_time=state.end_time,
            done=torch.logical_or(time >= state.end_time, fail),
            failed=torch.logical_or(state.failed, fail),
        )
        probe_ix = aux["probe_ix"]
        outputs = StepOutputs(
            dt=dt_used,
            time=time + dt_used,
            mu_probe=mu_n[..., probe_ix],
            theta_probe=torch.atan2(psi_n[..., probe_ix, 1],
                                    psi_n[..., probe_ix, 0]),
            screening_iterations=screening_iters,
            cg_iterations=cg_iters,
            valid=aux["one_i32"],
        )
        return new_state, outputs

    return step


def make_chunk_fn(cfg: StepConfig, chunk_size: int):
    """``(op, screening_weights, amg, state) -> (state, outputs,
    exported)`` advancing up to ``chunk_size`` steps, as a Python loop.

    Steps after ``done`` (one host read per step) pass the state through
    unchanged and emit ``valid=0`` outputs, so the outputs keep their
    shapes while the host controls stage boundaries. ``exported`` is the
    real-typed view of the final state (:func:`export_state_arrays`). The
    link variables of a static applied potential without screening are
    computed once per chunk (the same values the JAX step recomputes every
    step).
    """
    step_fn = make_step_fn(cfg)
    n_probe = len(cfg.probe_ix) if cfg.probe_ix else 0

    def chunk_fn(op, screening_weights, amg, state: SolverState):
        dev = state.mu.device
        rdtype = state.mu.dtype
        lead = state.step.shape  # () or (B,)
        aux = dict(
            probe_ix=torch.tensor(list(cfg.probe_ix or ()), dtype=torch.long,
                                  device=dev),
            window_ix=torch.arange(cfg.adaptive_window, dtype=torch.int32,
                                   device=dev),
            zero_i32=torch.zeros(lead, dtype=torch.int32, device=dev),
            one_i32=torch.ones(lead, dtype=torch.int32, device=dev),
            unit_dirs=gtdgl.unit_edge_directions(op, rdtype),
        )
        if cfg.A_fn is None and not cfg.include_screening:
            aux["U"] = gtdgl.edge_link_phases(state.A_applied,
                                              op.edge_directions)
        if cfg.include_screening:
            aux["screen_w"] = screening_weights.to(rdtype)[:, None]
            aux["sites"] = op.sites.to(rdtype)
            aux["edge_centers"] = op.edge_centers.to(rdtype)
        z = torch.zeros(lead, dtype=rdtype, device=dev)
        frozen = StepOutputs(
            dt=z, time=z,
            mu_probe=torch.zeros(lead + (n_probe,), dtype=rdtype, device=dev),
            theta_probe=torch.zeros(lead + (n_probe,), dtype=rdtype,
                                    device=dev),
            screening_iterations=aux["zero_i32"],
            cg_iterations=aux["zero_i32"],
            valid=aux["zero_i32"],
        )
        steps = []
        for _ in range(chunk_size):
            if bool(torch.all(state.done) if lead else state.done):
                steps.append(frozen)
                continue
            if not lead:
                state, out = step_fn(op, screening_weights, amg, state, aux)
                steps.append(out)
                continue
            # A batch: step every member, then keep a finished member's
            # state and emit its frozen slot (the JAX package's vmapped
            # lax.cond selects the same way).
            done = state.done
            new, out = step_fn(op, screening_weights, amg, state, aux)
            state = state._replace(**{
                k: (n if n is o else
                    torch.where(member_view(done, n), o, n))
                for k, o, n in zip(SolverState._fields, state, new)})
            steps.append(StepOutputs(*(
                torch.where(member_view(done, n), f, n)
                for f, n in zip(frozen, out))))
        # Steps stack after the member axis of a batch: (B, T, ...).
        outputs = StepOutputs(*(torch.stack(field, dim=len(lead))
                                for field in zip(*steps)))
        return state, outputs, export_state_arrays(state)

    return chunk_fn
