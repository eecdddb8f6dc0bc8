"""The TDGL time step on the hex-grid stencil backend, in PyTorch.

Port of :mod:`tdgl_tpu.solver.grid_step`: the same semantics, ``StepConfig``
and per-step outputs, with the state held as dense ``(Rp, Cp)`` tensors,
for static and traced time-dependent inputs (``cfg.A_fn``, ``cfg.eps_fn``,
``cfg.mu_boundary_fn``) and for structured screening (the induced-potential
fixed point, Anderson(1) or Polyak). The psi update and the Poisson
right-hand side go through the fused kernels of
:mod:`tdgl_tpu_torch.ops.step_kernels` (hand-written CUDA on the card,
their plain versions on the CPU): the stencil planes are checked once per
chunk (:class:`~tdgl_tpu_torch.ops.step_kernels.StencilOperands`), and the
operands that change within a chunk (the links rebuilt from a traced or
screened vector potential, ``dA_dt``, the Neumann term) are rebound per
step or per fixed-point iteration, which checks only them.

**Members.** The same chunk runs a batch of B independent runs (the
members of a parameter sweep, :mod:`tdgl_tpu_torch.parallel`) when the
state's fields carry a leading member axis: ``psi_r`` is ``(B, Rp, Cp)``
and the scalars are ``(B,)``; fields that all members share (the applied
potential of a current sweep, ``epsilon``, ``dA_dt``, the Neumann term of
a field sweep, an unscreened ``A_induced``) may keep their single-run
shapes. Both kernels then launch once per step (per fixed-point iteration
with screening) for the whole batch. The robust program's loops gate per
member, as the JAX package's vmapped ``while_loop``s do: the discriminant
retries shrink ``dt`` only for the members that fail, the top-up CG keeps
a converged member's iterate, and the screening fixed point
(:func:`~tdgl_tpu_torch.solver.step.screening_fixed_point`) keeps a
member's carry once it has converged, each loop reading one flag per
iteration for the batch. The screened batch carries ``A_induced`` per
member, so its links are per member; the induced potential of all members
comes from one batched convolution (or pairwise sum) per iteration. The
adaptive window, ``done`` and ``failed`` are per member, and a finished
member is frozen (ghost steps) while the others go on. Outputs are ``(B,
T, ...)``. A traced Neumann term is single-run only.

Eager PyTorch cannot drop dead work the way XLA does, so a step forms only
what it uses: the unscreened step forms neither the supercurrent nor the
normal current (the chunk recomputes both once, after its last step, as
the JAX chunk does); the screened step forms both in each fixed-point
iteration (the RHS kernel's ``J_s``-writing form), since the induced
potential needs them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import gtdgl_stencil as gs
from ..ops.cg import solve_mu_poisson_grid
from ..ops.step_kernels import StepOperands
from .step import (StepConfig, StepOutputs, adaptive_window,
                   induced_potential_update, member_view, plane_max,
                   retry_members, screening_error, screening_fixed_point,
                   traced_per_member, vector_scale)


class GridState(NamedTuple):
    """Device-resident solver state on the padded grid (shapes of a single
    run; a batch adds a leading member axis, see the module docstring)."""

    psi_r: torch.Tensor            # (Rp, Cp)
    psi_i: torch.Tensor            # (Rp, Cp)
    mu: torch.Tensor               # (Rp, Cp)
    mu_prev: torch.Tensor          # (Rp, Cp) — previous step's mu (predictor)
    supercurrent: torch.Tensor     # (3, Rp, Cp)
    normal_current: torch.Tensor   # (3, Rp, Cp)
    A_induced: torch.Tensor        # (3, Rp, Cp, 2)
    A_applied: torch.Tensor        # (3, Rp, Cp, 2)
    epsilon: torch.Tensor          # (Rp, Cp)
    neumann_term: torch.Tensor     # (Rp, Cp) — dense Neumann RHS contribution
    dA_dt: torch.Tensor            # (3, Rp, Cp) — edge-projected dA/dt
    tentative_dt: torch.Tensor
    prev_dt: torch.Tensor
    time: torch.Tensor
    step: torch.Tensor             # int32
    dpsi_window: torch.Tensor
    end_time: torch.Tensor
    done: torch.Tensor             # bool
    failed: torch.Tensor           # bool


def export_grid_diagnostics(state: GridState) -> torch.Tensor:
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


def export_grid_state_arrays(state: GridState):
    """The grid state as real-typed tensors (host converts to mesh
    vectors)."""
    return dict(
        psi_real=state.psi_r,
        psi_imag=state.psi_i,
        mu=state.mu,
        supercurrent=state.supercurrent,
        normal_current=state.normal_current,
        induced_vector_potential=state.A_induced,
        applied_vector_potential=state.A_applied,
        epsilon=state.epsilon,
        diagnostics=export_grid_diagnostics(state),
    )


def make_grid_step_fn(cfg: StepConfig):
    """Build ``(sten, screening, amg, state, ops, aux) -> (state,
    outputs)``.

    ``screening`` is ``(weights, fft_data)`` (None without screening).
    ``ops`` is the chunk's :class:`StepOperands`: the checked stencil
    planes, with the link form bound when it is fixed for the chunk (a
    static applied potential, no screening), and the chunk's ``dA_dt``
    and Neumann term; a step rebinds what its traced inputs change.
    ``aux`` holds the chunk's device constants (probe indices, the
    adaptive-window positions, unit directions, screening weights).
    ``cfg.probe_ix`` holds flat padded-grid indices. Traced inputs map a
    0-d time tensor to grid shapes: ``A_fn(t) -> (3, Rp, Cp, 2)``,
    ``eps_fn(t) -> (Rp, Cp)``, ``mu_boundary_fn(t) -> (B,)`` (scattered
    here, deterministically).
    """

    def euler_with_retries(ops, pr, pi, mu, epsilon, dt0, abs_sq=None):
        def update(dt):
            return ops.psi_update(cfg.gamma, cfg.u, pr, pi, mu, epsilon, dt,
                                  abs_sq)
        if cfg.adaptive and not cfg.fast_chunk:
            return retry_members(update, dt0, cfg)
        new_r, new_i, new_sq, ok = update(dt0)
        return new_r, new_i, new_sq, dt0, torch.logical_not(ok)

    def solve_mu(sten, amg, rhs, mu_guess, fixed_iters=None):
        # The outer (per-step) solve of the robust program gets a
        # tolerance-stopped top-up after its fixed iterations; the fast
        # program gates the residual instead. Inside the screening fixed
        # point (explicit fixed_iters) the solve stays a smooth map.
        topup = fixed_iters is None and not cfg.fast_chunk
        if fixed_iters is None:
            fixed_iters = cfg.poisson_fixed_iters
        return solve_mu_poisson_grid(
            sten, rhs, mu_guess,
            tol=cfg.poisson_tolerance,
            maxiter=cfg.poisson_max_iterations,
            amg=(amg if cfg.use_amg else None),
            amg_omega=cfg.amg_omega,
            fixed_iters=fixed_iters,
            topup=topup,
        )

    def induced_potential(sten, fft_data, aux, Jw):
        if cfg.screening_use_fft:
            if cfg.screening_eval_fn is not None:
                # The pencil form of a row-sharded solve
                # (parallel/fft_sharded.py), ahead of every other form.
                return cfg.screening_eval_fn(fft_data, sten, Jw)
            from ..ops import fft_screening as fs

            if cfg.screening_site_eval:
                return fs.induced_vector_potential_fft_site(
                    fft_data, sten, Jw, cfg.screening_site_taps)
            return fs.induced_vector_potential_fft(fft_data, sten, Jw)
        from ..ops.screening import induced_vector_potential

        lead = Jw.shape[:-3]
        A_flat = induced_vector_potential(aux["ec_xy"], aux["sites_xy"],
                                          Jw.reshape(lead + (-1, 2)))
        return (A_flat.reshape(lead + (3,) + Jw.shape[-3:])
                * aux["edge_valid"][..., None])

    def gate_residual(fail, cg_res, rdtype):
        # Fast chunks replace the top-up loop with a looser residual gate;
        # a trip triggers the solver's chunk-level failover. 2x the CG
        # precision floor keeps the gate for gross failure.
        gate = (cfg.poisson_fail_gate
                if cfg.fast_chunk and cfg.poisson_fail_gate > 0
                else cfg.poisson_tolerance)
        res_allowed = max(gate, 100.0 * torch.finfo(rdtype).eps)
        return torch.logical_or(fail, cg_res > res_allowed)

    def step(sten, screening, amg, state: GridState, ops: StepOperands,
             aux):
        rdtype = state.mu.dtype
        time = state.time
        if time.dim() and cfg.mu_boundary_fn is not None:
            raise NotImplementedError(
                "member-batched chunks run without a traced Neumann term")
        rebound = {}
        if cfg.A_fn is not None:
            A_applied = traced_per_member(cfg.A_fn, time).to(rdtype)
            dA = ((A_applied - state.A_applied)
                  / member_view(state.prev_dt, A_applied))
            nd = aux["ndirs"]
            dA_dt = (dA[..., 0] * nd[:, 0, None, None]
                     + dA[..., 1] * nd[:, 1, None, None]) * aux["edge_valid"]
            rebound["dA_dt"] = dA_dt
        else:
            A_applied = state.A_applied
            dA_dt = state.dA_dt
        epsilon = (traced_per_member(cfg.eps_fn, time).to(rdtype)
                   if cfg.eps_fn is not None else state.epsilon)
        if cfg.mu_boundary_fn is not None:
            neumann_term = gs.neumann_boundary_term(
                sten, cfg.mu_boundary_fn(time).to(rdtype))
            rebound["neumann_term"] = neumann_term
        else:
            neumann_term = state.neumann_term
        step_ops = ops.rebind(**rebound) if rebound else ops
        hoisted = ops.U is not None

        old_sq = state.psi_r**2 + state.psi_i**2
        dt0 = state.tentative_dt

        def tdgl_update(pr, pi, mu_in, A_induced, dt, fixed_iters=None,
                        solve_guess=None, abs_sq=None, currents=False):
            if hoisted:
                o = step_ops
            else:
                A_total = (A_applied + A_induced if cfg.include_screening
                           else A_applied)
                o = step_ops.rebind(U=gs.edge_link_phases(sten, A_total,
                                                          shifted=False))
            pr_n, pi_n, sq_n, dt_used, fail = euler_with_retries(
                o, pr, pi, mu_in, epsilon, dt, abs_sq)
            if currents:
                rhs, J_s = o.poisson_rhs(pr_n, pi_n, with_supercurrent=True)
            else:
                rhs, J_s = o.poisson_rhs(pr_n, pi_n), None
            cg = solve_mu(sten, amg, rhs,
                          mu_in if solve_guess is None else solve_guess,
                          fixed_iters)
            J_n = (-gs.gradient_on_edges(sten, cg.x) - dA_dt if currents
                   else None)
            return (pr_n, pi_n, sq_n, cg.x, J_s, J_n, dt_used, fail,
                    cg.iterations, cg.residual_norm)

        if cfg.include_screening:
            weights, fft_data = screening
            # Denominator floor of the global criterion: anything below
            # 1e-2 |A_applied| max contributes negligibly to the links.
            app_scale = vector_scale(A_applied, 4)

            def s_body(s, carry):
                """One fixed-point iteration (iteration ``s``) from
                ``carry = (dt, A_ind, velocity, x_prev, pr, pi, mu, ...)``;
                the psi update starts from the iterate with the step's
                ``|psi|^2``, as the reference does."""
                dt, A_ind, velocity, x_prev, pr_n, pi_n, mu_n = carry[:7]
                (pr_u, pi_u, sq_u, mu_u, J_s_u, J_n_u, dt_u, fail_i,
                 cg_iters_u, cg_res_u) = tdgl_update(
                    pr_n, pi_n, mu_n, A_ind, dt,
                    fixed_iters=cfg.screening_cg_iters,
                    abs_sq=None if s == 0 else old_sq, currents=True)
                J_site = gs.edge_quantity_to_sites(sten, J_s_u + J_n_u)
                Jw = J_site * aux["screen_w"]
                A_new = induced_potential(sten, fft_data, aux, Jw)
                A_ind_u, velocity_u, x_prev_u, dA = induced_potential_update(
                    cfg, s, A_ind, A_new, velocity, x_prev, 4)
                err_u = screening_error(cfg, dA, A_ind_u, app_scale, 4)
                return ((dt_u, A_ind_u, velocity_u, x_prev_u, pr_u, pi_u,
                         mu_u, sq_u, cg_iters_u, cg_res_u), fail_i, err_u)

            big = torch.full((), 1e30, dtype=rdtype, device=state.mu.device)
            carry = (dt0, state.A_induced, torch.zeros_like(state.A_induced),
                     state.A_induced, state.psi_r, state.psi_i, state.mu,
                     old_sq, aux["zero_i32"], big)
            if cfg.fast_chunk:
                # One inline iteration; the tolerance gate below trips
                # chunk failover when a step needs more.
                carry, fail, err = s_body(0, carry)
                screening_iters = aux["one_i32"]
            else:
                # The robust program's loop, gated per member; a frozen
                # (done) ghost step runs none, as the JAX loop's condition
                # tests state.done.
                carry, err, fail, screening_iters = screening_fixed_point(
                    cfg, s_body, carry, big, state.done)
            (dt_used, A_induced, _, _, pr_n, pi_n, mu_n, sq_n, cg_iters,
             cg_res) = carry
            fail = torch.logical_or(fail, err >= cfg.screening_tolerance)
            fail = gate_residual(fail, cg_res, rdtype)
        else:
            guess = (2.0 * state.mu - state.mu_prev if cfg.poisson_predictor
                     else None)
            (pr_n, pi_n, sq_n, mu_n, _, _, dt_used, fail, cg_iters,
             cg_res) = tdgl_update(state.psi_r, state.psi_i, state.mu,
                                   state.A_induced, dt0, solve_guess=guess)
            if cfg.poisson_fixed_iters is not None:
                fail = gate_residual(fail, cg_res, rdtype)
            A_induced = state.A_induced
            screening_iters = aux["zero_i32"]

        d_psi_sq = plane_max(torch.abs(sq_n - old_sq), 2)
        window, tentative = adaptive_window(cfg, state, d_psi_sq, dt_used,
                                            aux["window_ix"])

        new_state = state._replace(
            psi_r=pr_n,
            psi_i=pi_n,
            mu=mu_n,
            mu_prev=state.mu,
            A_induced=A_induced,
            A_applied=A_applied,
            epsilon=epsilon,
            neumann_term=neumann_term,
            dA_dt=dA_dt,
            tentative_dt=tentative.to(rdtype),
            prev_dt=dt_used.to(rdtype),
            time=time + dt_used,
            step=state.step + 1,
            dpsi_window=window,
            done=torch.logical_or(time >= state.end_time, fail),
            failed=torch.logical_or(state.failed, fail),
        )
        probe_ix = aux["probe_ix"]
        outputs = StepOutputs(
            dt=dt_used,
            time=time + dt_used,
            mu_probe=mu_n.flatten(-2)[..., probe_ix],
            theta_probe=torch.atan2(pi_n.flatten(-2)[..., probe_ix],
                                    pr_n.flatten(-2)[..., probe_ix]),
            screening_iterations=screening_iters,
            cg_iterations=cg_iters,
            valid=aux["one_i32"],
        )
        return new_state, outputs

    return step


def make_grid_chunk_fn(cfg: StepConfig, chunk_size: int,
                       operands=StepOperands):
    """``(sten, amg, state, screening=None) -> (state, outputs,
    exported)`` advancing up to ``chunk_size`` steps, as a Python loop over
    steps (``screening``: ``(weights, fft_data)`` when
    ``cfg.include_screening``). ``operands(sten, U, dA_dt, neumann_term)``
    makes the step kernels' operands (a
    :class:`~tdgl_tpu_torch.ops.step_kernels.StepOperands` by default).

    Mirrors the JAX chunk program:

    * the stencil planes are checked once per chunk; with a static applied
      potential and no screening the link variables are computed once per
      chunk too (in factored form when ``cfg.factor_link_phases``) and
      bound with ``dA_dt`` and the Neumann term; a traced ``A_fn`` or
      screening rebuilds them per step or per fixed-point iteration;
    * only the fields a step changes are carried (the induced potential
      with screening, the applied potential and ``dA_dt`` with ``A_fn``);
      finished or failed runs are frozen with an elementwise select on
      the device flag ``done`` (no host read inside the fast program's
      chunk; the robust program reads ``ok``, the top-up residual and the
      screening error); so are finished members of a batch, whose
      outputs come out ``(B, chunk_size, ...)``;
    * traced ``epsilon`` and Neumann terms are refreshed at the chunk's
      final time, and the last step's supercurrent and normal current are
      recomputed once after the loop.
    """
    step_fn = make_grid_step_fn(cfg)
    hoist_link = cfg.A_fn is None and not cfg.include_screening
    carried = ["psi_r", "psi_i", "mu", "tentative_dt", "prev_dt", "time",
               "step", "dpsi_window", "done", "failed"]
    if cfg.poisson_predictor and not cfg.include_screening:
        carried.append("mu_prev")
    if cfg.include_screening:
        carried.append("A_induced")
    if cfg.A_fn is not None:
        # dA/dt needs the previous step's applied potential.
        carried += ["A_applied", "dA_dt"]

    def chunk_fn(sten, amg, state: GridState, screening=None):
        dev = state.mu.device
        rdtype = state.mu.dtype
        static_link = None
        if hoist_link:
            if cfg.factor_link_phases:
                static_link = gs.factor_link_phases(sten, state.A_applied)
            else:
                static_link = gs.edge_link_phases(sten, state.A_applied)
        ops = operands(sten, static_link, state.dA_dt, state.neumann_term)
        aux = dict(
            probe_ix=torch.tensor(list(cfg.probe_ix or ()), dtype=torch.long,
                                  device=dev),
            window_ix=torch.arange(cfg.adaptive_window, dtype=torch.int32,
                                   device=dev),
            zero_i32=torch.zeros(state.step.shape, dtype=torch.int32,
                                 device=dev),
            one_i32=torch.ones(state.step.shape, dtype=torch.int32,
                               device=dev),
            edge_valid=sten.edge_valid.to(rdtype),
        )
        if cfg.A_fn is not None:
            dirs = sten.edge_dirs.to(rdtype)
            aux["ndirs"] = dirs / torch.sqrt(
                torch.sum(dirs * dirs, dim=1, keepdim=True))
        if cfg.include_screening:
            aux["screen_w"] = screening[0][..., None].to(rdtype)
            if not cfg.screening_use_fft:
                far = 1e6 * (1.0 - sten.valid.to(rdtype))
                aux["sites_xy"] = torch.stack(
                    [sten.site_x.to(rdtype) + far,
                     sten.site_y.to(rdtype) + far], dim=-1).reshape(-1, 2)
                aux["ec_xy"] = torch.stack(
                    [sten.ec_x.to(rdtype), sten.ec_y.to(rdtype)],
                    dim=-1).reshape(-1, 2)
        zero_dt = torch.zeros((), dtype=rdtype, device=dev)
        st = state
        steps = []
        for _ in range(chunk_size):
            frozen = st.done
            new_st, out = step_fn(sten, screening, amg, st, ops, aux)
            st = st._replace(**{
                k: torch.where(member_view(frozen, getattr(new_st, k)),
                               getattr(st, k), getattr(new_st, k))
                for k in carried
            })
            steps.append(out._replace(
                valid=torch.where(frozen, aux["zero_i32"], out.valid),
                dt=torch.where(frozen, zero_dt, out.dt),
            ))
        # Steps stack after the member axis of a batch: (B, T, ...).
        outputs = StepOutputs(*(torch.stack(field, dim=state.step.dim())
                                for field in zip(*steps)))
        # Chunk-constant fields dropped from the carry are refreshed at the
        # final time when they are traced functions of t.
        if cfg.eps_fn is not None:
            st = st._replace(epsilon=traced_per_member(
                cfg.eps_fn, st.time).to(rdtype))
        if cfg.mu_boundary_fn is not None:
            st = st._replace(neumann_term=gs.neumann_boundary_term(
                sten, cfg.mu_boundary_fn(st.time).to(rdtype)))
        # Recompute the last step's currents once (pure functions of the
        # final psi/mu); keep the seed values when the chunk did not
        # advance.
        if static_link is None:
            A_total = (st.A_applied + st.A_induced if cfg.include_screening
                       else st.A_applied)
            U = gs.edge_link_phases(sten, A_total, shifted=False)
        else:
            U = static_link
        J_s = gs.supercurrent_on_edges(sten, U, st.psi_r, st.psi_i)
        J_n = -gs.gradient_on_edges(sten, st.mu) - st.dA_dt
        advanced = member_view(st.step > state.step, J_s)
        final = st._replace(
            supercurrent=torch.where(advanced, J_s, state.supercurrent),
            normal_current=torch.where(advanced, J_n, state.normal_current),
        )
        return final, outputs, export_grid_state_arrays(final)

    return chunk_fn
