"""The TDGL time step on the hex-grid stencil backend, in PyTorch.

Port of the unscreened, static-input part of
:mod:`tdgl_tpu.solver.grid_step`: the same semantics, ``StepConfig`` and
per-step outputs, with the state held as dense ``(Rp, Cp)`` tensors. The
psi update and the Poisson right-hand side go through the fused kernels of
:mod:`tdgl_tpu_torch.ops.step_kernels` (hand-written CUDA on the card,
their plain versions on the CPU), with their chunk-constant operands bound
and checked once per chunk (:class:`~tdgl_tpu_torch.ops.step_kernels.
StepOperands`).

Eager PyTorch cannot drop dead work the way XLA does, so the step computes
only what the chunk carries: the per-step supercurrent and normal current
of the JAX step are not formed (the chunk recomputes both once, after its
last step, exactly as the JAX chunk does).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import gtdgl_stencil as gs
from ..ops.cg import solve_mu_poisson_grid
from ..ops.step_kernels import StepOperands
from .step import StepConfig, StepOutputs


class GridState(NamedTuple):
    """Device-resident solver state on the padded grid."""

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
    """``[time, prev_dt, tentative_dt, step, done, failed]`` as float32."""
    f = torch.float32
    return torch.stack([
        state.time.to(f),
        state.prev_dt.to(f),
        state.tentative_dt.to(f),
        state.step.to(f),
        state.done.to(f),
        state.failed.to(f),
    ])


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
    """Build ``(sten, amg, state, ops, aux) -> (state, outputs)``.

    ``ops`` is the chunk's :class:`StepOperands`: the stencil, the
    chunk-constant link form (the applied potential is static), ``dA_dt``
    and the Neumann term, checked once for the kernels; ``aux`` holds the
    chunk's device constants (probe indices, the adaptive-window
    positions). ``cfg.probe_ix`` holds flat
    padded-grid indices.
    """
    if cfg.include_screening or cfg.A_fn is not None \
            or cfg.eps_fn is not None or cfg.mu_boundary_fn is not None:
        raise NotImplementedError(
            "the torch grid step covers static inputs without screening"
            " (ROADMAP Queue 1: traced inputs, screening)"
        )

    def euler_with_retries(ops, pr, pi, mu, epsilon, dt0):
        new_r, new_i, new_sq, ok = ops.psi_update(
            cfg.gamma, cfg.u, pr, pi, mu, epsilon, dt0)
        if not cfg.adaptive or cfg.fast_chunk:
            return new_r, new_i, new_sq, dt0, torch.logical_not(ok)
        # Discriminant retries with a shrinking dt: one host read of `ok`
        # per attempt (the JAX program's lax.while_loop).
        dt, tries = dt0, 0
        while tries <= cfg.max_solve_retries and not bool(ok):
            dt = dt * cfg.adaptive_time_step_multiplier
            new_r, new_i, new_sq, ok = ops.psi_update(
                cfg.gamma, cfg.u, pr, pi, mu, epsilon, dt)
            tries += 1
        return new_r, new_i, new_sq, dt, torch.logical_not(ok)

    def solve_mu(sten, amg, ops, pr, pi, mu_guess):
        rhs = ops.poisson_rhs(pr, pi)
        # The robust program's solve gets a tolerance-stopped top-up after
        # its fixed iterations; the fast program gates the residual instead.
        return solve_mu_poisson_grid(
            sten, rhs, mu_guess,
            tol=cfg.poisson_tolerance,
            maxiter=cfg.poisson_max_iterations,
            amg=(amg if cfg.use_amg else None),
            amg_omega=cfg.amg_omega,
            fixed_iters=cfg.poisson_fixed_iters,
            topup=not cfg.fast_chunk,
        )

    def step(sten, amg, state: GridState, ops: StepOperands, aux):
        rdtype = state.mu.dtype
        time = state.time
        old_sq = state.psi_r**2 + state.psi_i**2
        guess = (2.0 * state.mu - state.mu_prev if cfg.poisson_predictor
                 else state.mu)
        pr_n, pi_n, sq_n, dt_used, fail = euler_with_retries(
            ops, state.psi_r, state.psi_i, state.mu, state.epsilon,
            state.tentative_dt,
        )
        cg = solve_mu(sten, amg, ops, pr_n, pi_n, guess)
        mu_n = cg.x
        if cfg.poisson_fixed_iters is not None:
            # Fast chunks replace the top-up loop with a looser residual
            # gate; a trip triggers the solver's chunk-level failover.
            gate = (cfg.poisson_fail_gate
                    if cfg.fast_chunk and cfg.poisson_fail_gate > 0
                    else cfg.poisson_tolerance)
            res_allowed = max(gate, 100.0 * torch.finfo(rdtype).eps)
            fail = torch.logical_or(fail, cg.residual_norm > res_allowed)

        d_psi_sq = torch.max(torch.abs(sq_n - old_sq))
        W = cfg.adaptive_window
        window = torch.where(aux["window_ix"] == state.step % W,
                             d_psi_sq.to(rdtype), state.dpsi_window)
        if cfg.adaptive:
            new_dt_est = cfg.dt_init / torch.clamp(torch.mean(window),
                                                   min=1e-10)
            tentative = torch.clamp(0.5 * (new_dt_est + dt_used), 0.0,
                                    cfg.dt_max)
            tentative = torch.where(state.step > W, tentative,
                                    state.tentative_dt)
        else:
            tentative = state.tentative_dt

        new_state = state._replace(
            psi_r=pr_n,
            psi_i=pi_n,
            mu=mu_n,
            mu_prev=state.mu,
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
            mu_probe=mu_n.reshape(-1)[probe_ix],
            theta_probe=torch.atan2(pi_n.reshape(-1)[probe_ix],
                                    pr_n.reshape(-1)[probe_ix]),
            screening_iterations=aux["zero_i32"],
            cg_iterations=cg.iterations,
            valid=aux["one_i32"],
        )
        return new_state, outputs

    return step


def make_grid_chunk_fn(cfg: StepConfig, chunk_size: int):
    """``(sten, amg, state) -> (state, outputs, exported)`` advancing up to
    ``chunk_size`` steps, as a Python loop over steps.

    Mirrors the JAX chunk program:

    * the link variables are computed once per chunk (static applied
      potential), in factored form when ``cfg.factor_link_phases``, and
      bound with the other chunk-constant kernel operands (``dA_dt``, the
      Neumann term: neither is carried) into one :class:`StepOperands`;
    * only the fields a step changes are carried; finished or failed runs
      are frozen with an elementwise select on the device flag ``done``
      (no host read inside the chunk, apart from the robust program's
      retry and top-up tests);
    * the last step's supercurrent and normal current are recomputed once
      after the loop.
    """
    step_fn = make_grid_step_fn(cfg)
    carried = ["psi_r", "psi_i", "mu", "tentative_dt", "prev_dt", "time",
               "step", "dpsi_window", "done", "failed"]
    if cfg.poisson_predictor:
        carried.append("mu_prev")

    def chunk_fn(sten, amg, state: GridState):
        dev = state.mu.device
        if cfg.factor_link_phases:
            static_link = gs.factor_link_phases(sten, state.A_applied)
        else:
            static_link = gs.edge_link_phases(sten, state.A_applied)
        ops = StepOperands(sten, static_link, state.dA_dt,
                           state.neumann_term)
        aux = dict(
            probe_ix=torch.tensor(list(cfg.probe_ix or ()), dtype=torch.long,
                                  device=dev),
            window_ix=torch.arange(cfg.adaptive_window, dtype=torch.int32,
                                   device=dev),
            zero_i32=torch.zeros((), dtype=torch.int32, device=dev),
            one_i32=torch.ones((), dtype=torch.int32, device=dev),
        )
        zero_dt = torch.zeros((), dtype=state.mu.dtype, device=dev)
        st = state
        steps = []
        for _ in range(chunk_size):
            frozen = st.done
            new_st, out = step_fn(sten, amg, st, ops, aux)
            st = st._replace(**{
                k: torch.where(frozen, getattr(st, k), getattr(new_st, k))
                for k in carried
            })
            steps.append(out._replace(
                valid=torch.where(frozen, aux["zero_i32"], out.valid),
                dt=torch.where(frozen, zero_dt, out.dt),
            ))
        outputs = StepOutputs(*(torch.stack(field) for field in zip(*steps)))
        # Recompute the last step's currents once (pure functions of the
        # final psi/mu); keep the seed values when the chunk did not
        # advance.
        J_s = gs.supercurrent_on_edges(sten, static_link, st.psi_r, st.psi_i)
        J_n = -gs.gradient_on_edges(sten, st.mu) - st.dA_dt
        advanced = st.step > state.step
        final = st._replace(
            supercurrent=torch.where(advanced, J_s, state.supercurrent),
            normal_current=torch.where(advanced, J_n, state.normal_current),
        )
        return final, outputs, export_grid_state_arrays(final)

    return chunk_fn
