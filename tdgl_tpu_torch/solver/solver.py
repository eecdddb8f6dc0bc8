"""TDGLSolver: problem assembly and execution, in PyTorch.

Port of :mod:`tdgl_tpu.solver.solver`: the same constructor,
nondimensionalisation (A in units of A0, currents via
``J_scale = 4 (I/L)/K0``), terminal boundary conditions, option
resolution, time-dependent inputs, screening, initial state, and
``solve()`` with the Runner, the HDF5 output file and the
:class:`~tdgl_tpu_torch.Solution`. Tensors live on ``torch_device``: the
card (``"cuda"``) unless the caller asks for the CPU.

Two backends, chosen as in the JAX package:

* **structured** (a mesh from ``make_mesh(structured=True)``): the padded
  hex-grid stencils of :mod:`.grid_step`, the hand-written CUDA step
  kernels, the deep multigrid, and fast/robust chunk programs with chunk
  failover;
* **unstructured (ELL)** (the default Delaunay mesh, or
  ``solver_backend="ell"``): the gather tables of
  :mod:`tdgl_tpu_torch.fv.operators`, the step of :mod:`.step`, the
  two-level AMG and the pairwise screening sum; one (robust) program, no
  failover. Unlike the JAX package, no solve is moved to another device
  when it is large (``unstructured_tpu_site_limit`` has no effect).

Time-dependent inputs run on one of two paths, as in the JAX package:

* **traced**: ``Parameter(..., jittable=True)`` and :func:`jittable`
  callables take torch tensors (``t`` is a 0-d tensor on the solve's
  device) and are evaluated inside the chunk, every step;
* **host**: plain callables are evaluated on the host before every step
  (chunk size 1, :meth:`TDGLSolver._host_update`).

A run continues exactly from the ``checkpoint`` group of an earlier output
file (``solve(resume_from=...)``, also one that ``tdgl_tpu`` wrote), or
starts from the fields of an earlier :class:`~tdgl_tpu_torch.Solution`
(``seed_solution``). Beside the output file ``solve()`` writes the
``<file>.h5.tmp`` side file that ``SolverOptions.monitor`` (``python -m
tdgl_tpu_torch.visualize --input <file> monitor``) polls; the monitor
needs matplotlib, and ``solve()`` raises ``ImportError`` before the first
step where it is missing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import logging
from datetime import datetime
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .. import convert
from ..device.device import Device, TerminalInfo
from ..fv.operators import build_operators
from ..fv.stencil_operators import build_stencil_operators
from ..ops.amg import build_amg
from ..ops.hexmg import build_hexmg
from ..parameter import Parameter
from ..sources.constant import ConstantField
from ..utils import h5lite
from ..utils.units import ureg
from .grid_step import GridState, make_grid_chunk_fn
from .options import SolverOptions, SolverOptionsError
from .runner import DataHandler, Runner
from .step import SolverState, StepConfig, make_chunk_fn

logger = logging.getLogger("solver")


class SolverResult(NamedTuple):
    """The per-step quantities produced by the solver (informational: the
    chunked runtime carries them in its state instead of returning them
    per step). Mirrors the reference ``tdgl/solver/solver.py:63-86`` for
    API compatibility."""

    dt: float
    psi: "np.ndarray"
    mu: "np.ndarray"
    supercurrent: "np.ndarray"
    normal_current: "np.ndarray"
    A_induced: "np.ndarray"
    A_applied: "np.ndarray" = None
    epsilon: "np.ndarray" = None


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
    """Solves a TDGL model for a given device.

    Args:
        device: The meshed :class:`tdgl_tpu_torch.Device`: a structured
            mesh (``make_mesh(structured=True)``) runs the stencil backend
            unless ``options.solver_backend == "ell"``; an unstructured
            one (the default) runs the ELL backend.
        options: :class:`tdgl_tpu_torch.SolverOptions`.
            ``unstructured_tpu_site_limit`` is accepted and has no effect:
            every solve keeps its tensors on ``torch_device``.
        applied_vector_potential: A float (uniform field strength in
            ``field_units``), or a Parameter/callable of ``(x, y, z)`` (and
            keyword ``t`` if time-dependent) returning the vector potential
            in ``field_units * length_units``.
        terminal_currents: Dict ``{terminal_name: current}`` or callable
            ``t -> dict`` (in ``current_units``; :func:`jittable` for the
            traced path).
        disorder_epsilon: Float (<= 1) or callable giving the local
            critical temperature parameter epsilon(r[, t]).
        seed_solution: A previous :class:`tdgl_tpu_torch.Solution` (also
            one loaded from a ``tdgl_tpu`` file) whose final psi, mu,
            currents and induced vector potential are the initial state;
            its device must equal ``device``.
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
        if device.mesh is None:
            raise ValueError(
                "The device has no mesh; call device.make_mesh() first."
            )
        mesh = device.mesh
        self.mesh = mesh
        # --- backend selection ---------------------------------------------
        if options.solver_backend == "stencil" and mesh.grid is None:
            raise ValueError(
                "solver_backend='stencil' requires a structured mesh;"
                " generate one with device.make_mesh(structured=True)."
            )
        self.structured = (
            mesh.grid is not None and options.solver_backend != "ell"
        )
        if options.poisson_solver == "mg" and not self.structured:
            raise SolverOptionsError(
                "poisson_solver='mg' requires the structured (stencil)"
                " backend; generate a structured mesh with"
                " device.make_mesh(structured=True) or use"
                " poisson_solver='cg'."
            )
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
        self.host_op = self.op = None
        self.host_sten = self.sten = self.maps = None
        if self.structured:
            logger.info("Constructing stencil operators.")
            host_sten, self.maps = build_stencil_operators(
                mesh, fixed_sites=fixed, dtype=self.rdtype
            )
            self.host_sten = host_sten
            self.sten = convert.stencil_to_torch(host_sten,
                                                 self.torch_device)
            logger.info(
                "Stencil backend: padded grid %s (%.0f%% fill).",
                self.maps.shape,
                100.0 * self.maps.n_sites
                / (self.maps.shape[0] * self.maps.shape[1]),
            )
        else:
            logger.info("Constructing finite volume operators.")
            self.host_op = build_operators(mesh, fixed_sites=fixed,
                                           dtype=self.rdtype)
            self.op = convert.operators_to_torch(self.host_op,
                                                 self.torch_device)

        # --- mu-Poisson preconditioner ---------------------------------------
        self._use_amg = options.poisson_preconditioner == "amg"
        if not self._use_amg:
            self.host_amg = self.amg = None
        elif self.structured:
            self.host_amg = build_hexmg(host_sten, self.maps, mesh)
            self.amg = convert.hexmg_to_torch(self.host_amg,
                                              self.torch_device,
                                              self.torch_dtype)
            logger.info(
                "Built %d-level smoothed-aggregation multigrid: %s.",
                len(self.amg.shapes), self.amg.shapes,
            )
        else:
            coarsening = options.amg_coarsening or max(
                16, len(mesh.sites) // 1200)
            self.host_amg = build_amg(self.host_op, coarsening=coarsening,
                                      dtype=self.rdtype)
            self.amg = convert.amg_to_torch(self.host_amg,
                                            self.torch_device,
                                            self.torch_dtype)
            logger.info(
                "Built two-level AMG preconditioner: %d aggregates"
                " (coarsening %d).", self.host_amg.Ac_inv.shape[0],
                coarsening,
            )

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
        # Probes are flat padded-grid indices on the stencil backend, site
        # indices on the ELL backend.
        probe_ix = None
        if self.probe_points is not None:
            probe_ix = tuple(
                int(self.maps.site_flat[p]) if self.structured else int(p)
                for p in self.probe_points)
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
                # Structured f32: 5 suffices for the f32-floored inner
                # tolerance; f64 runs chase ~1e-8 inner residuals and keep
                # a deeper count. The ELL backend keeps 32.
                else (5 if options.dtype == "float32" else 8)
                if self.structured else 32
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
            # deep SA hierarchy (structured); the ELL two-level AMG's
            # validated 0.6.
            amg_omega=(0.8 if self.structured else 0.6),
            probe_ix=probe_ix,
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
        self._failover_count = 0
        if not self.structured:
            if options.chunk_failover == "on":
                raise SolverOptionsError(
                    "chunk_failover='on' requires the structured (stencil)"
                    " backend; use 'auto' to enable it opportunistically."
                )
            self._raw_chunk_fn = make_chunk_fn(self.cfg, self.chunk_size)
            self.chunk_fn = lambda state: self._raw_chunk_fn(
                self.op, self._screening, self.amg, state
            )
            return
        self._raw_chunk_fn = make_grid_chunk_fn(self.cfg, self.chunk_size)
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
        ``"fft"`` on the structured backend (the exact lattice
        convolution; this package has no TPU DFT-matmul form) and to
        ``"xla"`` (the pairwise sum) on the ELL backend, where ``"fft"``
        raises. Sets ``self._screening`` (structured: ``(weights,
        fft_data)`` tensors; ELL: the per-site weights; None without
        screening), ``self._screening_kernel`` and ``self._site_taps``."""
        kernel = options.screening_kernel
        if kernel == "auto":
            kernel = "fft" if self.structured else "xla"
        if kernel == "fft" and not self.structured:
            raise ValueError(
                "screening_kernel='fft' requires a structured mesh"
                " (Device.make_mesh(structured=True))."
            )
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
        if not self.structured:
            self._screening = convert.to_tensor(
                weights.astype(self.rdtype), self.torch_device)
            return
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
            if self.structured:
                # Padded grid edge centers (invalid entries sit at the mesh
                # centroid, so user functions stay finite there).
                xe = (xi * np.asarray(self.host_sten.ec_x)).ravel()
                ye = (xi * np.asarray(self.host_sten.ec_y)).ravel()
                out_shape = (3,) + self.maps.shape + (2,)
            else:
                xe, ye = self.edge_centers[:, 0], self.edge_centers[:, 1]
                out_shape = (len(xe), 2)
            ze = self.device.layer.z0 * np.ones_like(xe)
            coords = [convert.to_tensor(c, dev) for c in (xe, ye, ze)]

            def A_fn(t, _p=self.applied_vector_potential):
                A = _p.evaluate_traced(*coords, t=t)
                A = self.A_scale * torch.as_tensor(A, device=dev)[:, :2]
                return A.reshape(out_shape)

        if self._jittable_eps:
            if self.structured:
                xs = [convert.to_tensor((xi * np.asarray(c)).ravel(), dev)
                      for c in (self.host_sten.site_x,
                                self.host_sten.site_y)]
                eps_shape = self.maps.shape
            else:
                xs = [convert.to_tensor(self.sites[:, k], dev)
                      for k in (0, 1)]
                eps_shape = (len(self.sites),)

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
        the robust program's top-up) on the float32 structured
        deep-multigrid path, else tolerance-stopped."""
        pf = options.poisson_fixed_iterations
        if pf is not None:
            return int(pf) if pf > 0 else None
        if (self.structured and self._use_amg
                and options.dtype == "float32"
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

        Auto enables the factored link phases on float32 structured
        static-A unscreened solves when the applied potential passes a
        float64 separability check (max ``|a - f - g|`` <= 1e-9 relative
        over the full padded grid); explicit True raises on an ineligible
        solve or a non-separable potential. Sets ``cfg.factor_link_phases``
        and caches the smooth full-grid applied potential for the state
        fill.
        """
        self._full_A_grid = None
        opt = options.factor_link_phases
        eligible = (self.structured
                    and not self.dynamic_vector_potential
                    and not options.include_screening)
        if opt is False or (opt is None and (
                not eligible or options.dtype != "float32")):
            return
        if opt and not eligible:
            raise SolverOptionsError(
                "factor_link_phases requires a structured mesh, a static"
                " (time-independent) applied vector potential and"
                " screening off."
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
        return self._mu_boundary_from_currents(self.current_func(time))

    def _mu_boundary_from_currents(self, currents: Dict[str, float]
                                   ) -> np.ndarray:
        """Neumann BC values per boundary edge for an explicit dict of
        (already nondimensional) terminal currents."""
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

    def _host_update(self, state):
        """Evaluate the non-traceable time-dependent inputs on the host at
        the state's time (chunk size 1; the Runner calls this before every
        chunk). The structured state holds them on the padded grid and
        the Neumann term pre-scattered; the ELL state holds mesh vectors
        and the boundary values themselves (its step gathers the term)."""
        time = float(state.time)
        updates = {}
        if self.dynamic_vector_potential and not self._jittable_A:
            A_new = self._eval_A(time)
            prev_dt = float(state.prev_dt)
            dirs = np.asarray(self.mesh.edge_mesh.directions,
                              dtype=self.rdtype)
            ndirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
            prev = state.A_applied.cpu().numpy()
            if self.structured:
                prev = self.maps.grid_to_edge(prev)
            dA_dt = np.einsum("ij,ij->i", (A_new - prev) / prev_dt, ndirs)
            updates["A_applied"] = A_new
            updates["dA_dt"] = dA_dt.astype(self.rdtype)
        if self.dynamic_epsilon and not self._jittable_eps:
            updates["epsilon"] = self._eval_epsilon(time)
        if self.dynamic_currents and not self._jittable_currents:
            mu_boundary = self._mu_boundary(time)
            if self.structured:
                updates["neumann_term"] = self._host_neumann_term(
                    mu_boundary)
            else:
                updates["mu_boundary"] = mu_boundary
        if self.structured:
            to_grid = dict(A_applied=self.maps.edge_to_grid,
                           dA_dt=self.maps.edge_to_grid,
                           epsilon=self.maps.site_to_grid)
            updates = {k: to_grid[k](v) if k in to_grid else v
                       for k, v in updates.items()}
        if updates:
            state = state._replace(**{
                k: convert.to_tensor(v, self.torch_device)
                for k, v in updates.items()})
        return state

    # -- state assembly -------------------------------------------------------
    def _initial_state(self):
        """The state at t = 0 on ``torch_device`` (a ``GridState``, or a
        ``SolverState`` on the ELL backend), and its step-0 export dict
        (``self._initial_export``): the uniform start, or the final fields
        of ``seed_solution``."""
        rd = self.rdtype
        n_edges = self.num_edges
        if self.seed_solution is not None:
            if self.seed_solution.device != self.device:
                raise ValueError(
                    "The seed_solution.device must match the device being"
                    " simulated."
                )
            seed = self.seed_solution.tdgl_data
            psi = np.asarray(seed.psi, dtype=self.cdtype)
            fields = dict(
                mu=np.asarray(seed.mu, dtype=rd),
                supercurrent=np.asarray(seed.supercurrent, dtype=rd),
                normal_current=np.asarray(seed.normal_current, dtype=rd),
                A_induced=np.asarray(seed.induced_vector_potential,
                                     dtype=rd),
            )
        else:
            psi = self.psi_init
            fields = dict(
                mu=np.asarray(self.mu_init, rd),
                supercurrent=np.zeros(n_edges, dtype=rd),
                normal_current=np.zeros(n_edges, dtype=rd),
                A_induced=np.zeros((n_edges, 2), dtype=rd),
            )
        psi_r = np.ascontiguousarray(np.real(psi), dtype=rd)
        psi_i = np.ascontiguousarray(np.imag(psi), dtype=rd)
        epsilon = np.asarray(self.epsilon, rd)
        if self.structured:
            maps = self.maps
            s2g, e2g = maps.site_to_grid, maps.edge_to_grid
            psi_r, psi_i, epsilon = s2g(psi_r), s2g(psi_i), s2g(epsilon)
            fields = {k: (s2g(v) if k == "mu" else e2g(v))
                      for k, v in fields.items()}
            if self._full_A_grid is not None:
                # Factored-link-phase path: fill the WHOLE padded grid with
                # the smooth applied potential, so the per-chunk row/col
                # factor extraction reads true values everywhere.
                A_applied = self._full_A_grid.astype(rd)
            else:
                A_applied = e2g(self.current_A_applied.astype(rd))
        else:
            A_applied = self.current_A_applied.astype(rd)
        options = self.options
        self._initial_export = dict(
            psi_real=psi_r,
            psi_imag=psi_i,
            mu=fields["mu"],
            supercurrent=fields["supercurrent"],
            normal_current=fields["normal_current"],
            induced_vector_potential=fields["A_induced"],
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

        common = dict(
            mu=t(fields["mu"]),
            mu_prev=t(fields["mu"]),
            supercurrent=t(fields["supercurrent"]),
            normal_current=t(fields["normal_current"]),
            A_induced=t(fields["A_induced"]),
            A_applied=t(A_applied),
            epsilon=t(epsilon),
            dA_dt=torch.zeros_like(t(fields["supercurrent"])),
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
        if self.structured:
            return GridState(
                psi_r=t(psi_r), psi_i=t(psi_i),
                neumann_term=t(self._host_neumann_term(
                    self._mu_boundary(0.0))),
                **common)
        # The ELL state holds psi as an (N, 2) re/im pair.
        return SolverState(
            psi=t(np.stack([psi_r, psi_i], axis=-1)),
            mu_boundary=t(self._mu_boundary(0.0)),
            **common)

    def _state_to_arrays(self, exported) -> Dict[str, np.ndarray]:
        """Convert an exported-state dict (``export_grid_state_arrays`` or
        ``export_state_arrays``, tensors or numpy) into per-site /
        per-edge mesh vectors."""
        ex = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in exported.items()}
        if self.structured:
            g2s = self.maps.grid_to_site
            g2e = self.maps.grid_to_edge
        else:
            g2s = g2e = np.asarray
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

    def _resume_state(self, resume_from: str, template):
        """Load the ``checkpoint`` group of a previous run's output file
        (this package's or ``tdgl_tpu``'s) and return ``(state,
        initial_export)`` reproducing that run's exact state on
        ``torch_device`` (see ``SolverOptions.save_checkpoints``). The
        solver must be constructed with the same mesh, dtype, and backend
        as the checkpointed run; every mismatch raises a ``ValueError``.
        Fields keep the checkpoint's dtype; where they were written
        (CPU or card) does not matter."""
        with h5lite.File(resume_from, "r") as f:
            if "checkpoint" not in f:
                raise ValueError(
                    f"{resume_from!r} contains no checkpoint: the run was"
                    " saved with save_checkpoints=False, was cancelled"
                    " during thermalization, or predates checkpoint"
                    " support."
                )
            grp = f["checkpoint"]
            backend = grp.attrs.get("backend", "")
            expected = "grid" if self.structured else "ell"
            if backend != expected:
                raise ValueError(
                    f"Checkpoint backend {backend!r} does not match this"
                    f" solver's {expected!r} (make_mesh(structured="
                    f"{'True' if backend == 'grid' else 'False'}) to"
                    " match)."
                )
            fingerprint = grp.attrs.get("mesh_fingerprint", "")
            if fingerprint != self._mesh_fingerprint():
                raise ValueError(
                    "Checkpoint mesh does not match this solver's mesh:"
                    " resuming requires the SAME device and mesh as the"
                    " checkpointed run (site/element fingerprint differs)."
                )
            fields = {}   # host numpy values, keyed by state field name
            for name in template._fields:
                if name in ("done", "failed", "end_time"):
                    continue  # reset below / set per stage by the runner
                tmpl = getattr(template, name)
                dtype = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
                if name in grp:
                    arr = np.asarray(grp[name])
                    if tuple(arr.shape) != tuple(tmpl.shape):
                        raise ValueError(
                            f"Checkpoint field {name!r} has shape"
                            f" {arr.shape}, expected {tuple(tmpl.shape)}:"
                            " resuming requires the same device, mesh, and"
                            " options as the checkpointed run."
                        )
                    if arr.dtype != dtype:
                        raise ValueError(
                            f"Checkpoint field {name!r} has dtype"
                            f" {arr.dtype}, expected {dtype}: resume with"
                            " the same SolverOptions.dtype as the"
                            " checkpointed run."
                        )
                    fields[name] = arr
                elif name in grp.attrs:
                    # 0-d fields are attributes (Python numbers): cast
                    # straight to the state's dtype, exactly.
                    fields[name] = np.asarray(grp.attrs[name], dtype=dtype)
                else:
                    raise ValueError(
                        f"Checkpoint is missing state field {name!r}."
                    )
            time_val = float(fields["time"])
            if time_val >= self.options.solve_time:
                raise ValueError(
                    f"The checkpoint is already at t = {time_val:.6g} >="
                    f" solve_time = {self.options.solve_time}: raise"
                    " solve_time to continue the run."
                )
        if self.cfg.factor_link_phases and self._full_A_grid is not None:
            # The factored-link path extracts its row/col phase factors
            # from state.A_applied, which must be the SMOOTH full-grid
            # fill. Repair a checkpoint that matches at the real edges
            # (the masked, edge-scattered fill) in place; reject anything
            # else.
            smooth = self._full_A_grid
            tol = dict(rtol=1e-5,
                       atol=1e-6 * max(float(np.abs(smooth).max()), 1e-30))
            ck = np.asarray(fields["A_applied"], np.float64)
            if not np.allclose(ck, smooth, **tol):
                at_edges = self.maps.grid_to_edge(ck)
                if not np.allclose(
                        at_edges, self.current_A_applied.astype(np.float64),
                        **tol):
                    raise ValueError(
                        "Checkpoint A_applied does not match this solver's"
                        " applied potential; resume with the same"
                        " applied_vector_potential, or set"
                        " factor_link_phases=False."
                    )
                fields["A_applied"] = smooth.astype(fields["A_applied"].dtype)
        dev = self.torch_device
        state = template._replace(
            **{k: convert.to_tensor(v, dev) for k, v in fields.items()},
            done=torch.zeros_like(template.done),
            failed=torch.zeros_like(template.failed),
        )
        # Host view of the resumed state for the step-0 snapshot.
        if self.structured:
            psi_real, psi_imag = fields["psi_r"], fields["psi_i"]
        else:
            psi_real, psi_imag = fields["psi"][..., 0], fields["psi"][..., 1]
        export = dict(
            psi_real=psi_real,
            psi_imag=psi_imag,
            mu=fields["mu"],
            supercurrent=fields["supercurrent"],
            normal_current=fields["normal_current"],
            induced_vector_potential=fields["A_induced"],
            applied_vector_potential=fields["A_applied"],
            epsilon=fields["epsilon"].astype(self.rdtype),
            diagnostics=np.array(
                [float(fields["time"]), float(fields["prev_dt"]),
                 float(fields["tentative_dt"]), float(fields["step"]),
                 0.0, 0.0],
                np.float32,
            ),
        )
        return state, export

    def solve(self, resume_from: Optional[str] = None):
        """Run the simulation; returns a :class:`tdgl_tpu_torch.Solution`
        (or None if cancelled during thermalization).

        Writes the standard output file (``options.output_file``, or a
        temporary file deleted on return when None): the mesh, the fixed
        arrays, a snapshot every ``save_every`` steps, the ``checkpoint``
        group, and the ``solution`` group. Every callable argument is
        checked to be storable before any step runs.

        Args:
            resume_from: Path to a previous run's output file (this
                package's or ``tdgl_tpu``'s). The solver state is restored
                EXACTLY from that file's ``checkpoint`` group (written at
                every snapshot when ``SolverOptions.save_checkpoints`` is
                on), so the continued trajectory is step-for-step identical
                to an uninterrupted run; output goes to this run's own
                ``output_file`` and the time axis continues from the
                checkpoint. Preemption-safe long runs: checkpoint +
                resume_from. (The reference's only warm restart,
                ``seed_solution``, re-seeds fields but loses the integrator
                state.)
        """
        from ..solution.solution import Solution, check_picklable

        options = self.options
        if options.monitor:
            # The monitor runs in a child process; fail here, not unseen
            # there, where matplotlib is missing.
            try:
                import matplotlib  # noqa: F401
            except ImportError as exc:
                raise ImportError(
                    "SolverOptions.monitor=True needs matplotlib, which is"
                    " not installed."
                ) from exc
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
        if resume_from is not None:
            if self.seed_solution is not None:
                raise ValueError(
                    "Pass either seed_solution or resume_from, not both."
                )
            state, self._initial_export = self._resume_state(
                resume_from, state
            )
        fixed = {}
        if not self.dynamic_vector_potential:
            fixed["applied_vector_potential"] = self.current_A_applied
        if not self.dynamic_epsilon:
            fixed["epsilon"] = self.epsilon

        with DataHandler(output_file=options.output_file,
                         logger=logger) as data_handler:
            data_handler.save_mesh(self.mesh)
            data_handler.save_fixed_values(fixed)
            data_handler.save_device(self.device)
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
                monitor=options.monitor,
                monitor_update_interval=options.monitor_update_interval,
                checkpoint_meta={
                    "backend": "grid" if self.structured else "ell",
                    "mesh_fingerprint": self._mesh_fingerprint(),
                },
                logger=logger,
                resume=(resume_from is not None),
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
