"""TDGLSolver: problem assembly and execution, in PyTorch.

Port of the structured, unscreened, static-input branch of
:mod:`tdgl_tpu.solver.solver`: the same constructor, nondimensionalisation
(A in units of A0, currents via ``J_scale = 4 (I/L)/K0``), terminal
boundary conditions, option resolution, fast/robust chunk programs with
chunk failover, and initial state. Tensors live on the explicit
``torch_device`` the caller passes; nothing guesses a device.

The entry points are ``TDGLSolver(...)``, ``solver._initial_state()`` and
``solver.chunk_fn(state)``. What this package does not run yet raises
``NotImplementedError`` naming its ROADMAP item (Queue 1): ``solve()``
with its HDF5 output, time-dependent inputs, screening, seed solutions
and resume, and unstructured meshes.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import convert
from ..device.device import Device, TerminalInfo
from ..fv.stencil_operators import build_stencil_operators
from ..ops.hexmg import build_hexmg
from ..parameter import Parameter
from ..sources.constant import ConstantField
from ..utils.units import ureg
from .grid_step import GridState, make_grid_chunk_fn
from .options import SolverOptions, SolverOptionsError
from .step import StepConfig

logger = logging.getLogger("solver")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tdgl_tpu_torch yet (ROADMAP Queue 1:"
        f" {item}); use tdgl_tpu for it."
    )


def validate_terminal_currents(
    terminal_currents: Union[Callable, Dict[str, float]],
    terminal_info: Sequence[TerminalInfo],
    solver_options: SolverOptions,
    num_evals: int = 100,
) -> None:
    """Check that the terminal currents sum to zero (current conservation)."""

    def check(currents: Dict[str, float]) -> None:
        names = {t.name for t in terminal_info}
        unknown = set(currents) - names
        if unknown:
            raise ValueError(
                f"Unknown terminal(s) in terminal currents: {sorted(unknown)}."
            )
        total = sum(currents.values())
        if total:
            raise ValueError(
                f"The sum of all terminal currents must be 0 (got {total:.2e})."
            )

    if callable(terminal_currents):
        for t in np.random.default_rng(0).random(num_evals) * \
                solver_options.solve_time:
            check(terminal_currents(t))
    else:
        check(terminal_currents)


class TDGLSolver:
    """Solves a TDGL model for a given device on a structured mesh.

    Args:
        device: The meshed :class:`tdgl_tpu_torch.Device`
            (``make_mesh(structured=True)``).
        options: :class:`tdgl_tpu_torch.SolverOptions`.
        applied_vector_potential: A float (uniform field strength in
            ``field_units``), or a time-independent Parameter/callable of
            ``(x, y, z)`` returning the vector potential in
            ``field_units * length_units``.
        terminal_currents: Dict ``{terminal_name: current}`` (in
            ``current_units``).
        disorder_epsilon: Float (<= 1) or time-independent callable giving
            the local critical temperature parameter epsilon(r).
        seed_solution: Not supported yet (must be None).
        torch_device: Where every tensor of the solve lives (keyword-only,
            required): ``"cuda"`` runs the hand-written kernels, ``"cpu"``
            their plain PyTorch versions.
    """

    def __init__(
        self,
        device: Device,
        options: SolverOptions,
        applied_vector_potential: Union[Callable, float] = 0.0,
        terminal_currents: Optional[Dict[str, float]] = None,
        disorder_epsilon: Union[Callable, float] = 1.0,
        seed_solution=None,
        *,
        torch_device: Union[str, torch.device],
    ):
        self.torch_device = torch.device(torch_device)
        if self.torch_device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"torch_device={torch_device!r}, but CUDA is not available."
            )
        self.device = device
        self.options = options
        options.validate()
        self.terminal_currents = terminal_currents
        self.seed_solution = seed_solution
        if seed_solution is not None:
            raise _not_ported("seed_solution", "checkpoint and resume")
        if device.mesh is None:
            raise ValueError(
                "The device has no mesh; call device.make_mesh() first."
            )
        mesh = device.mesh
        self.mesh = mesh
        if mesh.grid is None or options.solver_backend == "ell":
            raise _not_ported("The unstructured (ELL) backend",
                              "unstructured backend")
        if options.include_screening:
            raise _not_ported("Screening", "structured screening")
        if options.poisson_solver == "mg":
            raise SolverOptionsError(
                "poisson_solver='mg' (MG-Richardson) is not part of"
                " tdgl_tpu_torch (ROADMAP: do not port); use 'cg'."
            )
        if options.poisson_sstep:
            raise SolverOptionsError(
                "poisson_sstep (s-step CG) is not part of tdgl_tpu_torch"
                " (ROADMAP: do not port)."
            )
        if options.fold_link_weights or options.link_phase_bf16:
            raise SolverOptionsError(
                "fold_link_weights / link_phase_bf16 are not part of"
                " tdgl_tpu_torch (ROADMAP: do not port); a non-separable"
                " applied potential runs with raw link phases."
            )
        if options.pallas_step is not None:
            raise SolverOptionsError(
                "pallas_step selects the JAX package's Pallas kernels;"
                " tdgl_tpu_torch runs its CUDA kernels on every CUDA"
                " tensor and their plain versions on the CPU."
            )
        self.rdtype = np.float32 if options.dtype == "float32" else np.float64
        self.cdtype = (np.complex64 if options.dtype == "float32"
                       else np.complex128)
        self.torch_dtype = (torch.float32 if options.dtype == "float32"
                            else torch.float64)

        xi = device.layer.coherence_length
        self.u = device.layer.u
        self.gamma = device.layer.gamma
        length_units = ureg(device.length_units)
        K0 = device.K0
        A0 = device.A0

        self.probe_points = device.probe_point_indices
        # Dimensionful coordinates for evaluating user-supplied fields.
        self.sites = xi * np.asarray(mesh.sites)
        self.edge_centers = xi * np.asarray(mesh.edge_mesh.centers)
        self.num_edges = len(mesh.edge_mesh.edges)
        self.z0 = device.layer.z0 * np.ones(len(self.edge_centers))

        # --- applied vector potential --------------------------------------
        if (isinstance(applied_vector_potential, Parameter)
                and applied_vector_potential.time_dependent):
            raise _not_ported("A time-dependent applied vector potential",
                              "traced time-dependent inputs")
        if not callable(applied_vector_potential):
            applied_vector_potential = ConstantField(
                applied_vector_potential,
                field_units=options.field_units,
                length_units=device.length_units,
            )
        self.applied_vector_potential = applied_vector_potential
        # A given in field_units * length_units; convert to units of A0:
        self.A_scale = float(
            (ureg(options.field_units) * length_units / A0)
            .to_base_units().magnitude
        )
        current_A_applied = self._eval_A()

        # --- disorder epsilon ------------------------------------------------
        if callable(disorder_epsilon):
            spec = inspect.getfullargspec(disorder_epsilon)
            dynamic_epsilon = "t" in (spec.kwonlyargs or [])
            self.vectorized_epsilon = bool(
                (spec.kwonlydefaults or {}).get("vectorized", False)
            )
        else:
            value = float(disorder_epsilon)

            def disorder_epsilon(r, *, _value=value):
                return _value * np.ones(len(r))

            dynamic_epsilon = False
            self.vectorized_epsilon = True
        if dynamic_epsilon:
            raise _not_ported("A time-dependent disorder_epsilon",
                              "traced time-dependent inputs")
        self.disorder_epsilon = disorder_epsilon
        epsilon = self._eval_epsilon()
        if np.any(epsilon > 1):
            raise ValueError("The disorder parameter epsilon must be <= 1.")

        # --- terminals -------------------------------------------------------
        self.terminal_info = device.terminal_info()
        self.terminal_names = [t.name for t in self.terminal_info]
        for info in self.terminal_info:
            if info.length == 0:
                raise ValueError(
                    f"Terminal {info.name!r} does not contain any boundary"
                    " mesh sites."
                )
        if terminal_currents and device.probe_points is None:
            logger.warning(
                "The terminal currents are non-null, but the device has no"
                " probe points."
            )
        if terminal_currents is None:
            terminal_currents = {name: 0.0 for name in self.terminal_names}
        if callable(terminal_currents):
            raise _not_ported("Time-dependent terminal currents",
                              "traced time-dependent inputs")
        terminal_currents = {
            name: terminal_currents.get(name, 0.0)
            for name in self.terminal_names
        }

        def current_func(t, _currents=terminal_currents):
            return _currents

        # Dimensionless current scale: edge supercurrent values are in units
        # of J0/4 = K0/(4 d), hence the factor 4.
        J_scale = (ureg(options.current_units) / length_units / K0)
        J_scale = 4.0 * float(J_scale.to_base_units().magnitude)
        self.J_scale = J_scale
        self.current_func = (
            lambda t: {k: J_scale * v for k, v in current_func(t).items()}
        )
        validate_terminal_currents(self.current_func, self.terminal_info,
                                   options)

        if self.terminal_info:
            normal_boundary_index = np.concatenate(
                [t.site_indices for t in self.terminal_info]
            ).astype(np.int32)
        else:
            normal_boundary_index = np.array([], dtype=np.int32)

        # --- operators -------------------------------------------------------
        terminal_psi = options.terminal_psi
        fixed = (normal_boundary_index if terminal_psi is not None
                 else np.array([], dtype=np.int32))
        logger.info("Constructing stencil operators.")
        host_sten, self.maps = build_stencil_operators(
            mesh, fixed_sites=fixed, dtype=self.rdtype
        )
        self.host_sten = host_sten
        self.sten = convert.stencil_to_torch(host_sten, self.torch_device)
        logger.info(
            "Stencil backend: padded grid %s (%.0f%% fill).",
            self.maps.shape,
            100.0 * self.maps.n_sites
            / (self.maps.shape[0] * self.maps.shape[1]),
        )

        # --- mu-Poisson preconditioner ---------------------------------------
        self._use_amg = options.poisson_preconditioner == "amg"
        if self._use_amg:
            self.host_amg = build_hexmg(host_sten, self.maps, mesh)
            self.amg = convert.hexmg_to_torch(self.host_amg,
                                              self.torch_device,
                                              self.torch_dtype)
            logger.info(
                "Built %d-level smoothed-aggregation multigrid: %s.",
                len(self.amg.shapes), self.amg.shapes,
            )
        else:
            self.host_amg = self.amg = None

        # --- initial state -----------------------------------------------------
        n_sites = len(mesh.sites)
        psi_init = np.ones(n_sites, dtype=self.cdtype)
        if terminal_psi is not None:
            psi_init[normal_boundary_index] = terminal_psi
        mu_init = np.zeros(n_sites, dtype=self.rdtype)
        self.psi_init = psi_init
        self.mu_init = mu_init
        self.epsilon = np.asarray(epsilon, dtype=self.rdtype)
        self.current_A_applied = current_A_applied

        dt_max = options.dt_max if options.adaptive else options.dt_init
        poisson_tol = (
            float(options.poisson_tolerance)
            if options.poisson_tolerance is not None
            else (1e-4 if options.dtype == "float32" else 1e-6)
        )
        self.cfg = StepConfig(
            gamma=float(self.gamma),
            u=float(self.u),
            adaptive=bool(options.adaptive),
            dt_init=float(options.dt_init),
            dt_max=float(dt_max),
            adaptive_window=int(options.adaptive_window),
            max_solve_retries=int(options.max_solve_retries),
            adaptive_time_step_multiplier=float(
                options.adaptive_time_step_multiplier
            ),
            include_screening=False,
            screening_tolerance=float(options.screening_tolerance),
            screening_step_size=float(options.screening_step_size),
            screening_step_drag=float(options.screening_step_drag),
            max_iterations_per_step=int(options.max_iterations_per_step),
            poisson_tolerance=poisson_tol,
            poisson_max_iterations=int(options.poisson_max_iterations),
            poisson_fixed_iters=self._poisson_fixed_iters(options),
            poisson_predictor=(options.poisson_warm_start == "extrapolate"),
            # A single 0.8-damped Jacobi sweep per smoothing pass of the
            # deep SA hierarchy (the JAX package's structured setting).
            amg_omega=0.8,
            # Probes are flat padded-grid indices on the stencil backend.
            probe_ix=(
                tuple(int(self.maps.site_flat[p]) for p in self.probe_points)
                if self.probe_points is not None else None
            ),
            use_amg=self._use_amg,
        )
        self._resolve_factor_link_phases(options)
        cap = int(options.steps_per_chunk or 4096)
        if options.save_every <= cap:
            self.chunk_size = options.save_every
        else:
            # Largest divisor of save_every that fits the cap, so snapshots
            # land exactly on chunk boundaries.
            divisor = 1
            for d in range(1, cap + 1):
                if options.save_every % d == 0:
                    divisor = d
            self.chunk_size = divisor
        self._raw_chunk_fn = make_grid_chunk_fn(self.cfg, self.chunk_size)
        self._failover_count = 0
        if options.chunk_failover != "off":
            # The fast program: no retry/top-up loops, health gates instead
            # (StepConfig.fast_chunk). A chunk with a tripped gate is
            # re-run from its start state with the robust program.
            fast_over = {}
            fail_gate = 10.0 * float(self.cfg.poisson_tolerance)
            if (options.poisson_fixed_iterations is None
                    and options.poisson_tolerance is None
                    and self.cfg.poisson_fixed_iters == 2):
                # Gated fixed-1 mu solve (unscreened auto f32 structured
                # path): ONE MG-CG iteration per step, committed iff the
                # residual holds a 1e-2 gate; trips rewind the chunk to the
                # robust program (fixed-2 + tolerance-stopped top-up).
                fast_over["poisson_fixed_iters"] = 1
                fail_gate = 1e-2
            self._fast_cfg = dataclasses.replace(
                self.cfg, fast_chunk=True, poisson_fail_gate=fail_gate,
                **fast_over,
            )
            self._fast_chunk_fn = make_grid_chunk_fn(self._fast_cfg,
                                                     self.chunk_size)
            self.chunk_fn = self._failover_chunk_fn
        else:
            self.chunk_fn = lambda state: self._raw_chunk_fn(
                self.sten, self.amg, state
            )

    def _failover_chunk_fn(self, state: GridState):
        """Run the fast program; if its sticky ``failed`` flag is set (one
        host read per chunk), rewind to ``state`` and re-run the chunk
        with the robust program."""
        out = self._fast_chunk_fn(self.sten, self.amg, state)
        if not bool(out[0].failed):
            return out
        self._failover_count += 1
        logger.info(
            "fast chunk flagged an anomalous step; rewinding and re-running"
            " the chunk with the robust (retry/top-up) program"
        )
        return self._raw_chunk_fn(self.sten, self.amg, state)

    def _poisson_fixed_iters(self, options: SolverOptions) -> Optional[int]:
        """Resolve ``poisson_fixed_iterations`` (None = auto, 0 = forced
        tolerance-stopped): auto is a fixed 2-iteration MG-CG solve (plus
        the robust program's top-up) on the float32 deep-multigrid path."""
        pf = options.poisson_fixed_iterations
        if pf is not None:
            return int(pf) if pf > 0 else None
        if (self._use_amg and options.dtype == "float32"
                and options.poisson_solver == "cg"):
            return 2
        return None

    def _full_grid_A64(self) -> np.ndarray:
        """The applied potential at EVERY padded-grid edge center (float64,
        A0 units): the smooth extension of ``current_A_applied`` used by
        the factored-link-phase path and its separability check. The
        lattice is affine in (row, col) (``x = x0 + (c + r/2) h``,
        ``y = y0 + r h sqrt(3)/2``), so true edge centers exist at every
        padded position."""
        grid = self.mesh.grid
        h = float(grid.spacing)
        x0, y0 = float(grid.origin[0]), float(grid.origin[1])
        dy = h * np.sqrt(3.0) / 2.0
        Rp, Cp = self.maps.shape
        rr = np.arange(Rp, dtype=np.float64)[:, None]
        cc = np.arange(Cp, dtype=np.float64)[None, :]
        sx = x0 + (cc + 0.5 * rr) * h
        sy = np.broadcast_to(y0 + rr * dy, sx.shape)
        # Class offsets in xy (== sten.edge_dirs / h): E, N, NW.
        offs_xy = np.array([[h, 0.0], [0.5 * h, dy], [-0.5 * h, dy]])
        xi = float(self.device.layer.coherence_length)
        ecx = (sx[None] + 0.5 * offs_xy[:, 0][:, None, None]) * xi
        ecy = (sy[None] + 0.5 * offs_xy[:, 1][:, None, None]) * xi
        pts_x = ecx.reshape(-1)
        pts_y = ecy.reshape(-1)
        z0 = self.device.layer.z0 * np.ones(len(pts_x))
        A = self.applied_vector_potential(pts_x, pts_y, z0)
        A = self.A_scale * np.asarray(A, dtype=np.float64)[:, :2]
        return A.reshape(3, Rp, Cp, 2)

    def _resolve_factor_link_phases(self, options: SolverOptions) -> None:
        """Resolve ``SolverOptions.factor_link_phases`` (None = auto).

        Auto enables the factored link phases on float32 solves when the
        applied potential passes a float64 separability check (max
        ``|a - f - g|`` <= 1e-9 relative over the full padded grid);
        explicit True raises on a non-separable potential. Sets
        ``cfg.factor_link_phases`` and caches the smooth full-grid applied
        potential for the state fill.
        """
        self._full_A_grid = None
        opt = options.factor_link_phases
        if opt is False or (opt is None and options.dtype != "float32"):
            return
        A64 = self._full_grid_A64()
        dirs = np.asarray(self.host_sten.edge_dirs, np.float64)
        a = (A64[..., 0] * dirs[:, 0, None, None]
             + A64[..., 1] * dirs[:, 1, None, None])
        f = a[:, :, :1]
        g = a[:, :1, :] - a[:, :1, :1]
        scale = max(float(np.abs(a).max()), 1e-30)
        sep_err = float(np.abs(a - (f + g)).max()) / scale
        if sep_err > 1e-9:
            if opt:
                raise SolverOptionsError(
                    "factor_link_phases=True, but the applied vector"
                    f" potential is not separable on the lattice (relative"
                    f" deviation {sep_err:.1e})."
                )
            logger.info(
                "factor_link_phases auto-off: applied potential not"
                " separable (relative deviation %.1e).", sep_err,
            )
            return
        self._full_A_grid = A64
        self.cfg = dataclasses.replace(self.cfg, factor_link_phases=True)
        logger.info(
            "Factored link phases enabled (separability deviation %.1e).",
            sep_err,
        )

    # -- host-side evaluation helpers ---------------------------------------
    def _eval_A(self) -> np.ndarray:
        A = self.applied_vector_potential(
            self.edge_centers[:, 0], self.edge_centers[:, 1], self.z0,
        )
        A = self.A_scale * np.asarray(A)[:, :2]
        if A.shape != self.edge_centers.shape:
            raise ValueError(
                f"Unexpected shape for vector_potential: {A.shape}."
            )
        return A.astype(self.rdtype)

    def _eval_epsilon(self) -> np.ndarray:
        if self.vectorized_epsilon:
            eps = self.disorder_epsilon(self.sites)
        else:
            eps = np.array(
                [float(self.disorder_epsilon(r)) for r in self.sites]
            )
        return np.asarray(eps, dtype=self.rdtype)

    def _mu_boundary(self) -> np.ndarray:
        """Terminal current densities -> Neumann BC values per boundary
        edge (the currents are static)."""
        currents = self.current_func(0.0)
        mu_boundary = np.zeros(
            len(self.mesh.edge_mesh.boundary_edge_indices), dtype=self.rdtype
        )
        for term in self.terminal_info:
            density = (-1.0 / term.length) * sum(
                currents.get(name, 0.0)
                for name in self.terminal_names
                if name != term.name
            )
            mu_boundary[term.boundary_edge_indices] = density
        return mu_boundary

    def _host_neumann_term(self, mu_boundary: np.ndarray) -> np.ndarray:
        """Dense (grid) Neumann RHS term for a boundary-edge value vector,
        scattered once on the host (no atomics in the step)."""
        sten = self.host_sten
        flat = np.zeros(self.maps.shape[0] * self.maps.shape[1],
                        dtype=self.rdtype)
        np.add.at(flat, sten.nbl_idx,
                  sten.nbl_vals * mu_boundary[sten.nbl_col])
        return flat.reshape(self.maps.shape)

    # -- state assembly ---------------------------------------------------------
    def _initial_state(self) -> GridState:
        """The grid state at t = 0 on ``torch_device`` (and its step-0
        export dict, ``self._initial_export``)."""
        options = self.options
        rd = self.rdtype
        maps = self.maps
        s2g = maps.site_to_grid
        e2g = maps.edge_to_grid
        psi = self.psi_init
        psi_r = s2g(np.ascontiguousarray(np.real(psi), dtype=rd))
        psi_i = s2g(np.ascontiguousarray(np.imag(psi), dtype=rd))
        mu = s2g(np.asarray(self.mu_init, rd))
        zeros_e = e2g(np.zeros(self.num_edges, dtype=rd))
        A_induced = e2g(np.zeros((self.num_edges, 2), dtype=rd))
        if self._full_A_grid is not None:
            # Factored-link-phase path: fill the WHOLE padded grid with the
            # smooth applied potential, so the per-chunk row/col factor
            # extraction reads true values everywhere.
            A_applied = self._full_A_grid.astype(rd)
        else:
            A_applied = e2g(self.current_A_applied.astype(rd))
        epsilon = s2g(np.asarray(self.epsilon, rd))
        self._initial_export = dict(
            psi_real=psi_r,
            psi_imag=psi_i,
            mu=mu,
            supercurrent=zeros_e,
            normal_current=zeros_e,
            induced_vector_potential=A_induced,
            applied_vector_potential=A_applied,
            epsilon=epsilon,
            diagnostics=np.array(
                [0.0, options.dt_init, options.dt_init, 0.0, 0.0, 0.0],
                np.float32,
            ),
        )
        dev = self.torch_device
        td = self.torch_dtype

        def t(a):
            return convert.to_tensor(a, dev)

        def scalar(v, dtype=td):
            return torch.tensor(v, dtype=dtype, device=dev)

        return GridState(
            psi_r=t(psi_r),
            psi_i=t(psi_i),
            mu=t(mu),
            mu_prev=t(mu),
            supercurrent=t(zeros_e),
            normal_current=t(zeros_e),
            A_induced=t(A_induced),
            A_applied=t(A_applied),
            epsilon=t(epsilon),
            neumann_term=t(self._host_neumann_term(self._mu_boundary())),
            dA_dt=t(zeros_e),
            tentative_dt=scalar(options.dt_init),
            prev_dt=scalar(options.dt_init),
            time=scalar(0.0),
            step=scalar(0, torch.int32),
            dpsi_window=torch.zeros(options.adaptive_window, dtype=td,
                                    device=dev),
            end_time=scalar(options.solve_time),
            done=scalar(False, torch.bool),
            failed=scalar(False, torch.bool),
        )

    def _state_to_arrays(self, exported) -> Dict[str, np.ndarray]:
        """Convert an exported-state dict (``export_grid_state_arrays``,
        tensors or numpy) into per-site / per-edge mesh vectors."""
        ex = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in exported.items()}
        g2s = self.maps.grid_to_site
        g2e = self.maps.grid_to_edge
        return dict(
            psi=g2s(ex["psi_real"]) + 1j * g2s(ex["psi_imag"]),
            mu=g2s(ex["mu"]),
            supercurrent=g2e(ex["supercurrent"]),
            normal_current=g2e(ex["normal_current"]),
            induced_vector_potential=g2e(ex["induced_vector_potential"]),
        )

    def solve(self, resume_from: Optional[str] = None):
        """Not ported yet: drive ``chunk_fn`` directly."""
        raise _not_ported("TDGLSolver.solve() (Runner, HDF5 output,"
                          " Solution)", "solve(), Runner and Solution")
