"""TDGLSolver: problem assembly and execution, in PyTorch.

Port of the structured branch of :mod:`tdgl_tpu.solver.solver`: the same
constructor, nondimensionalisation (A in units of A0, currents via
``J_scale = 4 (I/L)/K0``), terminal boundary conditions, option
resolution, time-dependent inputs, screening, fast/robust chunk programs
with chunk failover, initial state, and ``solve()`` with the Runner, the
HDF5 output file and the :class:`~tdgl_tpu_torch.Solution`. Tensors live
on ``torch_device``: the card (``"cuda"``) unless the caller asks for the
CPU.

Time-dependent inputs run on one of two paths, as in the JAX package:

* **traced**: ``Parameter(..., jittable=True)`` and :func:`jittable`
  callables take torch tensors (``t`` is a 0-d tensor on the solve's
  device) and are evaluated inside the chunk, every step;
* **host**: plain callables are evaluated on the host before every step
  (chunk size 1, :meth:`TDGLSolver._host_update`).

What this package does not run yet raises ``NotImplementedError`` naming
its ROADMAP item (Queue 1): seed solutions and resume, unstructured
meshes, and the live monitor.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import logging
from datetime import datetime
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
from .runner import DataHandler, Runner
from .step import StepConfig

logger = logging.getLogger("solver")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tdgl_tpu_torch yet (ROADMAP Queue 1:"
        f" {item}); use tdgl_tpu for it."
    )


class UniformEpsilon:
    """``disorder_epsilon`` given as a number: ``epsilon(r) = value`` at
    every site. A module-level class, so the solution file can store it
    with the standard library's pickle (the JAX package wraps the number
    in a local function, which needs cloudpickle)."""

    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, r):
        return self.value * np.ones(len(r))

    def __eq__(self, other) -> bool:
        return isinstance(other, UniformEpsilon) and other.value == self.value

    def __repr__(self) -> str:
        return f"UniformEpsilon({self.value!r})"


def jittable(fn: Callable) -> Callable:
    """Mark a ``terminal_currents`` callable as traceable
    (``fn.jittable = True``): it takes ``t`` as a 0-d torch tensor and
    returns ``{terminal: current}`` with tensor (or number) values, reading
    nothing back to the host. The solver evaluates it inside the chunk, so
    current ramps and IV sweeps keep the full chunk size instead of one
    step per host update."""
    fn.jittable = True
    return fn


def _host_currents(fn: Callable, t) -> Dict[str, float]:
    """``fn(t)`` evaluated on the host as ``{name: float}``; a traceable
    ``fn`` gets ``t`` as a float64 CPU tensor."""
    if getattr(fn, "jittable", False):
        t = torch.tensor(float(t), dtype=torch.float64)
    return {k: float(v) for k, v in fn(t).items()}


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
            check(_host_currents(terminal_currents, t))
    else:
        check(terminal_currents)


class TDGLSolver:
    """Solves a TDGL model for a given device on a structured mesh.

    Args:
        device: The meshed :class:`tdgl_tpu_torch.Device`
            (``make_mesh(structured=True)``).
        options: :class:`tdgl_tpu_torch.SolverOptions`.
        applied_vector_potential: A float (uniform field strength in
            ``field_units``), or a Parameter/callable of ``(x, y, z)`` (and
            keyword ``t`` if time-dependent) returning the vector potential
            in ``field_units * length_units``.
        terminal_currents: Dict ``{terminal_name: current}`` or callable
            ``t -> dict`` (in ``current_units``; :func:`jittable` for the
            traced path).
        disorder_epsilon: Float (<= 1) or callable giving the local
            critical temperature parameter epsilon(r[, t]).
        seed_solution: Not supported yet (must be None).
        torch_device: Where every tensor of the solve lives (keyword-only):
            ``"cuda"`` (the default) runs the hand-written kernels and
            raises where CUDA is not available; ``"cpu"`` runs their plain
            PyTorch versions.
    """

    def __init__(
        self,
        device: Device,
        options: SolverOptions,
        applied_vector_potential: Union[Callable, float] = 0.0,
        terminal_currents: Union[Callable, Dict[str, float], None] = None,
        disorder_epsilon: Union[Callable, float] = 1.0,
        seed_solution=None,
        *,
        torch_device: Union[str, torch.device] = "cuda",
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
        self._reject_unported_options(options)
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
        self.dynamic_vector_potential = (
            isinstance(applied_vector_potential, Parameter)
            and applied_vector_potential.time_dependent
        )
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
        current_A_applied = self._eval_A(0.0)

        # --- disorder epsilon ------------------------------------------------
        if callable(disorder_epsilon):
            spec = inspect.getfullargspec(disorder_epsilon)
            self.dynamic_epsilon = "t" in (spec.kwonlyargs or [])
            self.vectorized_epsilon = bool(
                (spec.kwonlydefaults or {}).get("vectorized", False)
            )
        else:
            disorder_epsilon = UniformEpsilon(disorder_epsilon)
            self.dynamic_epsilon = False
            self.vectorized_epsilon = True
        self.disorder_epsilon = disorder_epsilon
        epsilon = self._eval_epsilon(0.0)
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
            current_func = terminal_currents
            self.dynamic_currents = True
            self._jittable_currents = bool(
                getattr(terminal_currents, "jittable", False)
            )
        else:
            self._jittable_currents = False
            terminal_currents = {
                name: terminal_currents.get(name, 0.0)
                for name in self.terminal_names
            }
            self.dynamic_currents = False

            def current_func(t, _currents=terminal_currents):
                return _currents

        # Dimensionless current scale: edge supercurrent values are in units
        # of J0/4 = K0/(4 d), hence the factor 4.
        J_scale = (ureg(options.current_units) / length_units / K0)
        J_scale = 4.0 * float(J_scale.to_base_units().magnitude)
        self.J_scale = J_scale
        # Host evaluation (a traceable function gets a CPU tensor t).
        self.current_func = (
            lambda t: {k: J_scale * v
                       for k, v in _host_currents(current_func, t).items()}
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

        # --- screening -------------------------------------------------------
        self._setup_screening(options, xi, K0, A0, length_units)

        # --- initial state ---------------------------------------------------
        n_sites = len(mesh.sites)
        psi_init = np.ones(n_sites, dtype=self.cdtype)
        if terminal_psi is not None:
            psi_init[normal_boundary_index] = terminal_psi
        mu_init = np.zeros(n_sites, dtype=self.rdtype)
        self.psi_init = psi_init
        self.mu_init = mu_init
        self.epsilon = np.asarray(epsilon, dtype=self.rdtype)
        self.current_A_applied = current_A_applied

        # --- time-dependence strategy ----------------------------------------
        self._jittable_A = (
            self.dynamic_vector_potential
            and getattr(self.applied_vector_potential, "jittable", False)
        )
        self._jittable_eps = (
            self.dynamic_epsilon
            and getattr(self.disorder_epsilon, "jittable", False)
        )
        self.host_dynamic = (
            (self.dynamic_vector_potential and not self._jittable_A)
            or (self.dynamic_epsilon and not self._jittable_eps)
            or (self.dynamic_currents and not self._jittable_currents)
        )
        A_fn, eps_fn, mu_boundary_fn = self._traced_inputs(current_func, xi)

        dt_max = options.dt_max if options.adaptive else options.dt_init
        poisson_tol = (
            float(options.poisson_tolerance)
            if options.poisson_tolerance is not None
            else (1e-4 if options.dtype == "float32" else 1e-6)
        )
        screening_global_norm = (
            options.screening_error_norm == "global"
            or (options.screening_error_norm == "auto"
                and options.dtype == "float32")
        )
        screening_tol = float(options.screening_tolerance)
        if options.include_screening:
            # Precision floor on the effective screening tolerance (see
            # SolverOptions.screening_tolerance_floor).
            floor = options.screening_tolerance_floor
            if floor is None:
                if options.dtype == "float32":
                    floor = 5e-4 if screening_global_norm else 3e-3
                else:
                    floor = 0.0
            if screening_tol < floor:
                logger.warning(
                    "screening_tolerance=%.1e is below the %s precision "
                    "floor %.1e for dtype=%s; using the floor (set "
                    "screening_tolerance_floor=0 to disable).",
                    screening_tol,
                    "global-norm" if screening_global_norm else "per-edge",
                    floor, options.dtype,
                )
                screening_tol = float(floor)
            # mu-solve noise enters the fixed point through the normal
            # current, so CG must converge well below the screening
            # tolerance.
            poisson_tol = min(poisson_tol, 1e-2 * screening_tol)
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
            include_screening=bool(options.include_screening),
            screening_global_error_norm=screening_global_norm,
            screening_use_fft=(self._screening_kernel == "fft"),
            # Auto resolves to False here (the robust program evaluates
            # the exact per-edge-class convolution); the fast chunk
            # program flips to the site-evaluated kernel below.
            screening_site_eval=(options.screening_site_eval is True),
            screening_site_taps=self._site_taps,
            screening_anderson=(options.screening_solver == "anderson"),
            screening_cg_iters=(
                int(options.screening_cg_iterations)
                if options.screening_cg_iterations is not None
                # f32: 5 suffices for the f32-floored inner tolerance; f64
                # runs chase ~1e-8 inner residuals and keep a deeper count.
                else (5 if options.dtype == "float32" else 8)
            ),
            screening_tolerance=screening_tol,
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
            A_fn=A_fn,
            eps_fn=eps_fn,
            mu_boundary_fn=mu_boundary_fn,
            use_amg=self._use_amg,
        )
        self._resolve_factor_link_phases(options)
        if self.host_dynamic:
            self.chunk_size = 1
        else:
            cap = int(options.steps_per_chunk or 4096)
            if options.save_every <= cap:
                self.chunk_size = options.save_every
            else:
                # Largest divisor of save_every that fits the cap, so
                # snapshots land exactly on chunk boundaries.
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
            self._fast_cfg = dataclasses.replace(
                self.cfg, fast_chunk=True, **self._fast_overrides(options))
            self._fast_chunk_fn = make_grid_chunk_fn(self._fast_cfg,
                                                     self.chunk_size)
            self.chunk_fn = self._failover_chunk_fn
        else:
            self.chunk_fn = lambda state: self._raw_chunk_fn(
                self.sten, self.amg, state, self._screening
            )

    @staticmethod
    def _reject_unported_options(options: SolverOptions) -> None:
        """Raise ``SolverOptionsError`` for the options this package does
        not have (TPU-only, or measured and not ported)."""
        rejected = {
            "poisson_solver='mg' (MG-Richardson)":
                options.poisson_solver == "mg",
            "poisson_sstep (s-step CG)": bool(options.poisson_sstep),
            "fold_link_weights / link_phase_bf16 (a non-separable applied"
            " potential runs with raw link phases)":
                bool(options.fold_link_weights or options.link_phase_bf16),
            "screening_kernel='mxu' (the TPU's DFT-matmul form; 'fft' runs"
            " the same convolution on cuFFT)":
                options.screening_kernel == "mxu",
            "screening_dft_precision='bf16' (an operand precision of the"
            " TPU's DFT matmuls)":
                options.screening_dft_precision == "bf16",
        }
        for what, hit in rejected.items():
            if hit:
                raise SolverOptionsError(
                    f"{what} is not part of tdgl_tpu_torch (ROADMAP: do not"
                    " port)."
                )
        if options.pallas_step is not None:
            raise SolverOptionsError(
                "pallas_step selects the JAX package's Pallas kernels;"
                " tdgl_tpu_torch runs its CUDA kernels on every CUDA"
                " tensor and their plain versions on the CPU."
            )

    def _setup_screening(self, options, xi, K0, A0, length_units) -> None:
        """The screening weights and kernel: ``"auto"`` resolves to
        ``"fft"`` (the exact lattice convolution; this package has no
        TPU DFT-matmul form), ``"xla"`` is the pairwise sum. Sets
        ``self._screening`` (``(weights, fft_data)`` tensors, or None),
        ``self._screening_kernel`` and ``self._site_taps``."""
        kernel = options.screening_kernel
        if kernel == "auto":
            kernel = "fft"
        self._screening_kernel = kernel
        self._site_taps = None
        self._screening = None
        if not options.include_screening:
            return
        if options.screening_site_eval is True and kernel != "fft":
            raise SolverOptionsError(
                "screening_site_eval=True needs the 'fft' screening kernel"
                f" (got screening_kernel={options.screening_kernel!r})."
            )
        # weight_s = [mu_0/(4 pi) K0/A0] * xi * a_s (dimensionless a, r).
        A_scale_scr = (
            (ureg("mu_0") / (4 * np.pi) * K0 / A0).to(1 / length_units)
        ).magnitude
        weights = (A_scale_scr * xi) * np.asarray(self.mesh.areas)
        weights = self.maps.site_to_grid(weights.astype(self.rdtype))
        fft_data = None
        if kernel == "fft":
            from ..ops.fft_screening import (build_fft_screening,
                                             build_site_interp_taps)

            fft_data = convert.fft_screening_to_torch(
                build_fft_screening(self.host_sten, self.maps,
                                    self.mesh.grid, dtype=self.rdtype),
                self.torch_device)
            self._site_taps = build_site_interp_taps(
                self.host_sten, self.maps, self.mesh.grid)
            if (options.screening_site_eval is True
                    and self._site_taps is None):
                raise SolverOptionsError(
                    "screening_site_eval=True but the mesh's valid region"
                    " sits too close to the padded-grid boundary for the"
                    " interpolation/correction rolls to be wrap-safe on"
                    " this mesh."
                )
        self._screening = (convert.to_tensor(weights, self.torch_device),
                           fft_data)

    def _fast_overrides(self, options: SolverOptions) -> Dict[str, object]:
        """The fast program's ``StepConfig`` changes: its residual gate,
        and (screened) the shallower inner solve and the site-evaluated
        convolution at float32, or (unscreened auto float32) the gated
        fixed-1 mu solve."""
        over = {"poisson_fail_gate": 10.0 * float(self.cfg.poisson_tolerance)}
        if self.cfg.include_screening:
            sfi = options.screening_fast_iterations
            if sfi is None and options.dtype == "float32":
                sfi = min(3, self.cfg.screening_cg_iters)
            if sfi is not None:
                over["screening_cg_iters"] = int(sfi)
            if (options.screening_site_eval is None
                    and self.cfg.screening_use_fft
                    and self.cfg.screening_site_taps is not None
                    and options.dtype == "float32"):
                over["screening_site_eval"] = True
        elif (options.poisson_fixed_iterations is None
                and options.poisson_tolerance is None
                and self.cfg.poisson_fixed_iters == 2):
            # Gated fixed-1 mu solve (unscreened auto f32 structured
            # path): ONE MG-CG iteration per step, committed iff the
            # residual holds a 1e-2 gate; trips rewind the chunk to the
            # robust program (fixed-2 + tolerance-stopped top-up).
            over["poisson_fixed_iters"] = 1
            over["poisson_fail_gate"] = 1e-2
        return over

    def _traced_inputs(self, current_func, xi):
        """``(A_fn, eps_fn, mu_boundary_fn)`` of the traced path, each a
        function of a 0-d time tensor on the solve's device (None where
        the input is static or host-evaluated)."""
        dev = self.torch_device
        A_fn = eps_fn = mu_boundary_fn = None
        if self._jittable_currents:
            # Terminal currents -> Neumann BC values is LINEAR with a static
            # matrix: density on terminal i's boundary edges is
            # (-1/length_i) * sum_{j != i} I_j. Bake the (B, n_terminals)
            # matrix and trace only the user's currents function.
            n_b = len(self.mesh.edge_mesh.boundary_edge_indices)
            T = np.zeros((n_b, len(self.terminal_names)), dtype=self.rdtype)
            for term in self.terminal_info:
                for j, name in enumerate(self.terminal_names):
                    if name != term.name:
                        T[term.boundary_edge_indices, j] = -1.0 / term.length
            columns = [convert.to_tensor(T[:, j], dev)
                       for j in range(T.shape[1])]
            names, scale = tuple(self.terminal_names), self.J_scale

            def mu_boundary_fn(t):
                currents = current_func(t)
                # T @ I, summed over the terminals in order (no atomics).
                out = None
                for col, name in zip(columns, names):
                    I = torch.as_tensor(currents[name], dtype=col.dtype,
                                        device=dev) * scale
                    out = col * I if out is None else out + col * I
                return out

        if self._jittable_A:
            # Padded grid edge centers (invalid entries sit at the mesh
            # centroid, so user functions stay finite there).
            xe = (xi * np.asarray(self.host_sten.ec_x)).ravel()
            ye = (xi * np.asarray(self.host_sten.ec_y)).ravel()
            ze = self.device.layer.z0 * np.ones_like(xe)
            coords = [convert.to_tensor(c, dev) for c in (xe, ye, ze)]
            out_shape = (3,) + self.maps.shape + (2,)

            def A_fn(t, _p=self.applied_vector_potential):
                A = _p.evaluate_traced(*coords, t=t)
                A = self.A_scale * torch.as_tensor(A, device=dev)[:, :2]
                return A.reshape(out_shape)

        if self._jittable_eps:
            xs = [convert.to_tensor(
                (xi * np.asarray(c)).ravel(), dev)
                for c in (self.host_sten.site_x, self.host_sten.site_y)]
            eps_shape = self.maps.shape

            def eps_fn(t, _p=self.disorder_epsilon):
                return torch.as_tensor(
                    _p.evaluate_traced(*xs, t=t), device=dev
                ).reshape(eps_shape)

        return A_fn, eps_fn, mu_boundary_fn

    def _failover_chunk_fn(self, state: GridState):
        """Run the fast program; if its sticky ``failed`` flag is set (one
        host read per chunk), rewind to ``state`` and re-run the chunk
        with the robust program."""
        out = self._fast_chunk_fn(self.sten, self.amg, state,
                                  self._screening)
        if not bool(out[0].failed):
            return out
        self._failover_count += 1
        logger.info(
            "fast chunk flagged an anomalous step; rewinding and re-running"
            " the chunk with the robust (retry/top-up) program"
        )
        return self._raw_chunk_fn(self.sten, self.amg, state,
                                  self._screening)

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

        Auto enables the factored link phases on float32 static-A
        unscreened solves when the applied potential passes a float64
        separability check (max ``|a - f - g|`` <= 1e-9 relative over the
        full padded grid); explicit True raises on an ineligible solve or
        a non-separable potential. Sets ``cfg.factor_link_phases`` and
        caches the smooth full-grid applied potential for the state fill.
        """
        self._full_A_grid = None
        opt = options.factor_link_phases
        eligible = (not self.dynamic_vector_potential
                    and not options.include_screening)
        if opt is False or (opt is None and (
                not eligible or options.dtype != "float32")):
            return
        if opt and not eligible:
            raise SolverOptionsError(
                "factor_link_phases requires a static (time-independent)"
                " applied vector potential and screening off."
            )
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
    def _eval_A(self, time: float) -> np.ndarray:
        kwargs = (dict(t=time) if self.dynamic_vector_potential else dict())
        A = self.applied_vector_potential(
            self.edge_centers[:, 0], self.edge_centers[:, 1], self.z0,
            **kwargs,
        )
        A = self.A_scale * np.asarray(A)[:, :2]
        if A.shape != self.edge_centers.shape:
            raise ValueError(
                f"Unexpected shape for vector_potential: {A.shape}."
            )
        return A.astype(self.rdtype)

    def _eval_epsilon(self, time: float) -> np.ndarray:
        kwargs = dict(t=time) if self.dynamic_epsilon else dict()
        if self.vectorized_epsilon:
            eps = self.disorder_epsilon(self.sites, **kwargs)
        else:
            eps = np.array(
                [float(self.disorder_epsilon(r, **kwargs))
                 for r in self.sites]
            )
        return np.asarray(eps, dtype=self.rdtype)

    def _mu_boundary(self, time: float) -> np.ndarray:
        """Terminal current densities at ``time`` -> Neumann BC values per
        boundary edge."""
        currents = self.current_func(time)
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

    def _host_update(self, state: GridState) -> GridState:
        """Evaluate the non-traceable time-dependent inputs on the host at
        the state's time (chunk size 1; the Runner calls this before every
        chunk)."""
        time = float(state.time)
        updates = {}
        if self.dynamic_vector_potential and not self._jittable_A:
            A_new = self._eval_A(time)
            prev_dt = float(state.prev_dt)
            dirs = np.asarray(self.mesh.edge_mesh.directions,
                              dtype=self.rdtype)
            ndirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
            prev = self.maps.grid_to_edge(state.A_applied.cpu().numpy())
            dA_dt = np.einsum("ij,ij->i", (A_new - prev) / prev_dt, ndirs)
            updates["A_applied"] = self.maps.edge_to_grid(A_new)
            updates["dA_dt"] = self.maps.edge_to_grid(
                dA_dt.astype(self.rdtype))
        if self.dynamic_epsilon and not self._jittable_eps:
            updates["epsilon"] = self.maps.site_to_grid(
                self._eval_epsilon(time))
        if self.dynamic_currents and not self._jittable_currents:
            updates["neumann_term"] = self._host_neumann_term(
                self._mu_boundary(time))
        if updates:
            state = state._replace(**{
                k: convert.to_tensor(v, self.torch_device)
                for k, v in updates.items()})
        return state

    # -- state assembly -------------------------------------------------------
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
            neumann_term=t(self._host_neumann_term(self._mu_boundary(0.0))),
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
        data = dict(
            psi=g2s(ex["psi_real"]) + 1j * g2s(ex["psi_imag"]),
            mu=g2s(ex["mu"]),
            supercurrent=g2e(ex["supercurrent"]),
            normal_current=g2e(ex["normal_current"]),
            induced_vector_potential=g2e(ex["induced_vector_potential"]),
        )
        if self.dynamic_vector_potential:
            data["applied_vector_potential"] = g2e(
                ex["applied_vector_potential"])
        if self.dynamic_epsilon:
            data["epsilon"] = g2s(ex["epsilon"])
        return data

    # -- main entry point -----------------------------------------------------
    def _mesh_fingerprint(self) -> str:
        """SHA1 of the dimensionless mesh geometry (sites + elements).

        Stored in every checkpoint (the JAX package verifies it on
        resume): padded grid shapes alone can coincide for different
        meshes."""
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(self.mesh.sites, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.mesh.elements, np.int64).tobytes())
        return h.hexdigest()

    def solve(self, resume_from: Optional[str] = None):
        """Run the simulation; returns a :class:`tdgl_tpu_torch.Solution`
        (or None if cancelled during thermalization).

        Writes the standard output file (``options.output_file``, or a
        temporary file deleted on return when None): the mesh, the fixed
        arrays, a snapshot every ``save_every`` steps, the ``checkpoint``
        group, and the ``solution`` group. Every callable argument is
        checked to be storable before any step runs.

        Args:
            resume_from: Not ported yet (must be None).
        """
        from ..solution.solution import Solution, check_picklable

        if resume_from is not None:
            raise _not_ported("resume_from", "checkpoint and resume")
        options = self.options
        if options.monitor:
            raise _not_ported("The live monitor (SolverOptions.monitor)",
                              "visualization")
        start_time = datetime.now()
        options.validate()
        check_picklable(applied_vector_potential=self.applied_vector_potential,
                        terminal_currents=self.terminal_currents,
                        disorder_epsilon=self.disorder_epsilon)

        running = {"dt": 1}
        if self.probe_points is not None:
            running["mu"] = len(self.probe_points)
            running["theta"] = len(self.probe_points)
        if options.include_screening:
            running["screening_iterations"] = 1

        state = self._initial_state()
        fixed = {}
        if not self.dynamic_vector_potential:
            fixed["applied_vector_potential"] = self.current_A_applied
        if not self.dynamic_epsilon:
            fixed["epsilon"] = self.epsilon

        with DataHandler(output_file=options.output_file,
                         logger=logger) as data_handler:
            data_handler.save_mesh(self.mesh)
            data_handler.save_fixed_values(fixed)
            logger.info(
                "Simulation started at %s on %s (chunk size %d).",
                start_time, self.torch_device, self.chunk_size,
            )
            runner = Runner(
                chunk_fn=self.chunk_fn,
                initial_state=state,
                options=options,
                data_handler=data_handler,
                state_to_arrays=self._state_to_arrays,
                running_names_and_sizes=running,
                chunk_size=self.chunk_size,
                initial_export=self._initial_export,
                host_update_fn=(self._host_update if self.host_dynamic
                                else None),
                checkpoint_meta={
                    "backend": "grid",
                    "mesh_fingerprint": self._mesh_fingerprint(),
                },
                logger=logger,
            )
            data_was_generated = runner.run()
            end_time = datetime.now()
            logger.info("Simulation ended at %s (took %s).", end_time,
                        end_time - start_time)
            if not data_was_generated:
                return None
            # The Solution reads the file and appends its group.
            data_handler.output_file.close()
            solution = Solution(
                device=self.device,
                path=data_handler.output_path,
                options=options,
                applied_vector_potential=self.applied_vector_potential,
                terminal_currents=self.terminal_currents,
                disorder_epsilon=self.disorder_epsilon,
                total_seconds=(end_time - start_time).total_seconds(),
            )
            solution.to_hdf5()
            return solution
