"""Batched parameter sweeps, on one device or split over a device list.

Port of :mod:`tdgl_tpu.parallel.sweep`: :func:`solve_sweep` runs B solves
that differ only in a scale of the applied vector potential (a field sweep)
or of every terminal current (a current sweep, e.g. an IV curve) as ONE
batch. The JAX package ``vmap``s its robust chunk program and shards the
batch over a device mesh; here the batch is a leading member axis of the
solver state, and the robust chunk of either backend
(:mod:`tdgl_tpu_torch.solver.grid_step`, :mod:`tdgl_tpu_torch.solver.step`)
advances all members with one op sequence: one launch of each CUDA step
kernel per step (per screening fixed-point iteration, with screening) for
the whole batch on the structured backend. Every loop of that program
gates its updates per member, as the JAX package's vmapped
``while_loop``s do, so each member follows the trajectory it would follow
alone. A screened sweep carries each member's induced potential; each
fixed-point iteration evaluates it for all members at once (one batched
FFT convolution, or one pairwise sum whose distance tiles serve every
member), and each member file holds its member's induced potential.

``mesh`` (a :class:`~tdgl_tpu_torch.parallel.spatial.DeviceMesh` or a
list of devices; a device may repeat) splits the members into contiguous
blocks, one per entry, as the JAX package shards its batch axis: each
block runs as one batch on its device, chunk by chunk until every member
is done, and the results come back in member order. ``mesh=None`` takes
the JAX rule where ``torch_device`` is plain ``"cuda"``: the largest
count of visible cards that divides B; a device with an index, or the
CPU, runs the whole batch. A batch that does not divide over an
explicit mesh raises.

What differs from the JAX package:

* On the ELL backend the screening fixed point of a finished member's
  ghost steps runs no iteration (the JAX ELL loop does not test ``done``
  and, under ``vmap``, spins on them): less work, the same results
  (:mod:`tdgl_tpu_torch.solver.step`).
* ``field_scales`` with a time-dependent traced applied potential raises
  ``ValueError``: the JAX step replaces the member-scaled potential with
  the unscaled ``A_fn(t)`` from its first step on, so every member runs
  the same field (ROADMAP, Queue 3).
* The member files are written through h5lite, and the scaled inputs that
  each member's :class:`~tdgl_tpu_torch.Solution` stores are module-level
  objects (:class:`ScaledApplied`, :class:`ScaledCurrents`), so they pickle
  without cloudpickle.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device.device import Device
from ..solver.options import SolverOptions
from ..solver.solver import TDGLSolver, _host_currents
from ..utils import h5lite

logger = logging.getLogger(__name__)


@dataclass
class SweepResult:
    """Results of a batched sweep.

    Attributes:
        values: The swept parameter values, shape ``(B,)``.
        psi: Final order parameters, shape ``(B, N)``.
        mu: Final scalar potentials, shape ``(B, N)``.
        supercurrent / normal_current: Final edge currents, ``(B, E)``.
        dynamics_dt: Per-step dt, shape ``(B, T)`` (zero-padded).
        dynamics_mu: Probe-point potentials, ``(B, P, T)``.
        dynamics_theta: Probe-point phases, ``(B, P, T)``.
        steps: Number of steps each member took, shape ``(B,)``.
    """

    values: np.ndarray
    psi: np.ndarray
    mu: np.ndarray
    supercurrent: np.ndarray
    normal_current: np.ndarray
    dynamics_dt: np.ndarray
    dynamics_mu: np.ndarray
    dynamics_theta: np.ndarray
    steps: np.ndarray
    failed: np.ndarray = None  # (B,) bool — per-member failure flags
    times: np.ndarray = None   # (B,) final simulation times
    solutions: Optional[List] = None  # per-member Solutions (output_dir=)

    def mean_voltages(self, i: int = 0, j: int = 1,
                      tmin: float = 0.0) -> np.ndarray:
        """dt-weighted mean voltage between probe points i and j for each
        sweep member (the IV-curve ordinate)."""
        out = np.zeros(len(self.values))
        for b in range(len(self.values)):
            dt = self.dynamics_dt[b]
            mask = dt > 0
            times = np.cumsum(dt)
            mask &= times >= tmin
            v = self.dynamics_mu[b, i] - self.dynamics_mu[b, j]
            out[b] = np.average(v[mask], weights=dt[mask]) if mask.any() else 0.0
        return out


class ScaledApplied:
    """``scale * applied(...)``: the applied vector potential of a
    field-sweep member whose input is a plain callable (a number or a
    Parameter is scaled by its own ``*``)."""

    def __init__(self, applied, scale: float):
        self.applied = applied
        self.scale = float(scale)

    def __call__(self, *args, **kwargs):
        return self.scale * np.asarray(self.applied(*args, **kwargs))


class ScaledCurrents:
    """The terminal currents of a current-sweep member: the swept dict, or
    callable ``t -> dict``, with every current times ``scale``."""

    def __init__(self, currents, scale: float):
        self.currents = currents
        self.scale = float(scale)

    def __call__(self, t) -> Dict[str, float]:
        return {k: v * self.scale
                for k, v in _host_currents(self.currents, t).items()}


def _scale_applied(applied, s: float):
    """The effective applied-vector-potential input of a field-sweep
    member: ``s * applied``. Numbers and Parameters multiply directly
    (operator algebra); plain callables get a :class:`ScaledApplied`."""
    try:
        return applied * s
    except TypeError:
        return ScaledApplied(applied, s)


def _member_path(output_dir: str, b: int) -> str:
    """``member_{b:03d}.h5`` in ``output_dir``, serial-renamed on a
    collision (as the DataHandler does) rather than raising after the
    whole sweep was solved."""
    serial = None
    while True:
        tag = f"-{serial}" if serial is not None else ""
        path = os.path.join(output_dir, f"member_{b:03d}{tag}.h5")
        if not os.path.exists(path):
            break
        serial = 1 if serial is None else serial + 1
    if serial is not None:
        logger.warning("Member output file already exists; renamed to %s.",
                       path)
    return path


def _write_member_solutions(
    output_dir: str, solver, device, options, exported, scales, steps,
    dyn_dt, dyn_mu, dyn_theta, applied_vector_potential, terminal_currents,
    disorder_epsilon, field_sweep: bool,
):
    """Write each sweep member's final state as a standalone output file in
    the standard schema and return the corresponding Solutions."""
    from ..solution.solution import Solution

    os.makedirs(output_dir, exist_ok=True)
    solutions = []
    for b in range(len(scales)):
        member = {k: np.asarray(v[b]) for k, v in exported.items()}
        data = solver._state_to_arrays(member)
        # The standalone file must be self-contained: include the (possibly
        # fixed) applied potential and disorder, converted off the grid.
        if "applied_vector_potential" not in data:
            ap = member["applied_vector_potential"]
            data["applied_vector_potential"] = (
                solver.maps.grid_to_edge(ap) if solver.structured else ap
            )
        if "epsilon" not in data:
            eps = member["epsilon"]
            data["epsilon"] = (
                solver.maps.grid_to_site(eps) if solver.structured else eps
            )
        n_b = int(steps[b])
        diag = member["diagnostics"]
        path = _member_path(output_dir, b)
        with h5lite.File(path, "x") as f:
            solver.mesh.to_hdf5(f.create_group("mesh"))
            grp = f.create_group("data").create_group("0")
            grp.attrs["step"] = n_b
            grp.attrs["time"] = float(diag[0])
            grp.attrs["dt"] = float(dyn_dt[b, n_b - 1]) if n_b else 0.0
            for key, value in data.items():
                grp[key] = np.asarray(value)
            rs = grp.create_group("running_state")
            rs["dt"] = dyn_dt[b, :n_b]
            if dyn_mu.shape[1]:  # probe points present
                rs["mu"] = np.squeeze(dyn_mu[b, :, :n_b])
                rs["theta"] = np.squeeze(dyn_theta[b, :, :n_b])
        s = float(scales[b])
        if field_sweep:
            A_b = _scale_applied(applied_vector_potential, s)
            tc_b = terminal_currents
        else:
            A_b = applied_vector_potential
            tc_b = (ScaledCurrents(terminal_currents, s)
                    if terminal_currents else None)
        solution = Solution(
            device=device,
            path=path,
            options=options,
            applied_vector_potential=A_b,
            terminal_currents=tc_b,
            disorder_epsilon=disorder_epsilon,
            total_seconds=0.0,
        )
        solution.to_hdf5()
        solutions.append(solution)
    return solutions


def _member_axis(state, B: int, per_member, scaled: Dict[str, torch.Tensor]):
    """The batched start state: the fields in ``per_member`` (and the
    scalars) get a leading member axis of B copies, the fields in
    ``scaled`` take the given per-member tensors, and every other field
    stays one tensor that all members share."""
    fields = {}
    for name in state._fields:
        v = getattr(state, name)
        if name in scaled:
            fields[name] = scaled[name]
        elif name in per_member or v.dim() == 0:
            fields[name] = v.expand((B,) + v.shape).contiguous()
    return state._replace(**fields)


def _member_devices(mesh, B: int, torch_device) -> List[torch.device]:
    """The mesh entries the B members split over (one block each). With
    ``mesh=None``, a device with an index (``"cuda:1"``, ``"cpu"``) runs
    the whole batch; plain ``"cuda"`` takes the JAX rule, the largest
    count of visible cards that divides B."""
    if mesh is None:
        dev = torch.device(torch_device)
        if dev.type != "cuda" or dev.index is not None:
            return [dev]
        n = max(torch.cuda.device_count(), 1)
        while B % n:
            n -= 1
        if n == 1:
            return [dev]
        return [torch.device("cuda", i) for i in range(n)]
    devices = getattr(mesh, "devices", mesh)
    if isinstance(devices, (str, torch.device)) or not isinstance(
            devices, (list, tuple)):
        raise TypeError(
            f"mesh must be a DeviceMesh or a list of devices, got"
            f" {type(mesh).__name__}")
    devices = [torch.device(d) for d in devices]
    if not devices or B % len(devices):
        raise ValueError(
            f"{B} sweep members do not divide over the mesh's"
            f" {len(devices)} devices")
    return devices


def _members(state, lo: int, hi: int, fields, device):
    """Members ``[lo, hi)`` of a batched state on ``device``: the
    ``fields`` with the member axis are cut, the others (shared by all
    members) stay whole."""
    return type(state)(*((v[lo:hi] if name in fields else v).to(device)
                         for name, v in zip(state._fields, state)))


def _cat_members(parts, single=None):
    """Per-block chunk outputs (every field per member) or exports (a
    field per member where it has one dim more than in ``single``, the
    single run's export) joined in member order on the first block's
    device; a shared field is taken from the first block."""
    first = parts[0]
    if hasattr(first, "_fields"):
        dev = first.dt.device
        return type(first)(*(torch.cat([v.to(dev) for v in vals])
                             for vals in zip(*parts)))
    dev = first["diagnostics"].device
    return {k: (torch.cat([p[k].to(dev) for p in parts])
                if first[k].dim() == np.ndim(single[k]) + 1 else first[k])
            for k in first}


def _to_host(tree):
    """A dict of tensors as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _host_outputs(outputs):
    """One chunk's ``StepOutputs`` (``(B, chunk, ...)`` tensors) as host
    numpy arrays, read once per chunk."""
    return type(outputs)(*(v.detach().cpu().numpy() for v in outputs))


def solve_sweep(
    device: Device,
    options: SolverOptions,
    *,
    applied_vector_potential=0.0,
    terminal_currents=None,
    disorder_epsilon=1.0,
    field_scales: Optional[Sequence[float]] = None,
    current_scales: Optional[Sequence[float]] = None,
    mesh=None,
    max_steps: Optional[int] = None,
    raise_on_failure: bool = True,
    output_dir: Optional[str] = None,
    torch_device: Union[str, torch.device] = "cuda",
) -> SweepResult:
    """Run a batch of TDGL solves as one batch on one device.

    Exactly one of ``field_scales`` or ``current_scales`` must be given; each
    batch member ``b`` solves the same problem with the applied vector
    potential (or every terminal current) multiplied by ``scales[b]``.

    Args:
        device: The meshed :class:`Device` (shared by all members).
        options: Solver options (``save_every`` sets the chunk size).
        applied_vector_potential: As in :func:`tdgl_tpu_torch.solve`.
        terminal_currents: A dict (static bias) or a callable ``t -> dict``
            (the common IV-curve form). A callable is re-evaluated on the
            host at every chunk boundary, at each member's own simulation
            time — piecewise-constant in time at ``steps_per_chunk``
            resolution (set ``options.steps_per_chunk=1`` for per-step
            updates).
        disorder_epsilon: As in :func:`tdgl_tpu_torch.solve`.
        field_scales: Multipliers for the applied vector potential.
        current_scales: Multipliers for all terminal currents.
        mesh: A :class:`~tdgl_tpu_torch.parallel.spatial.DeviceMesh`
            (:func:`~tdgl_tpu_torch.parallel.spatial_device_mesh`) or a
            list of devices: the members split into one contiguous block
            per entry, each run as one batch on its device. None: for
            ``torch_device="cuda"``, the largest count of visible cards
            that divides B; else one batch on ``torch_device``.
        max_steps: Step cap (default: generous bound from dt_init).
        raise_on_failure: Raise ``RuntimeError`` if any member fails
            (discriminant-retry exhaustion / screening non-convergence).
            When False, failures are reported in ``SweepResult.failed``
            instead.
        output_dir: If given, write each member's final state to
            ``{output_dir}/member_{b:03d}.h5`` in the standard output
            schema and return full :class:`tdgl_tpu_torch.Solution` objects
            in ``SweepResult.solutions``.
        torch_device: Where the batch runs (keyword-only): ``"cuda"`` (the
            default; raises where CUDA is not available) or ``"cpu"``;
            with ``mesh``, where the solver is set up.

    Returns:
        A :class:`SweepResult`.
    """
    if (field_scales is None) == (current_scales is None):
        raise ValueError(
            "Exactly one of field_scales / current_scales must be given."
        )
    scales = np.asarray(
        field_scales if field_scales is not None else current_scales,
        dtype=float,
    )
    B = len(scales)
    mesh_devices = _member_devices(mesh, B, torch_device)
    dynamic_currents = callable(terminal_currents)
    solver = TDGLSolver(
        device, options,
        applied_vector_potential=applied_vector_potential,
        # A callable bias is handled by the batched per-chunk host update
        # below; the solver itself is constructed with the t=0 snapshot so
        # the chunk reads nothing back for it.
        terminal_currents=(_host_currents(terminal_currents, 0.0)
                           if dynamic_currents else terminal_currents),
        disorder_epsilon=disorder_epsilon,
        torch_device=torch_device,
    )
    if solver.host_dynamic:
        raise ValueError(
            "solve_sweep requires traced (jittable) or static A/epsilon"
            " parameters (callable terminal currents are supported)."
        )
    if field_scales is not None and solver.cfg.A_fn is not None:
        raise ValueError(
            "field_scales with a time-dependent applied vector potential"
            " is not supported: the traced potential A(t) would replace"
            " every member's scaled potential from the first step on (the"
            " JAX package's behaviour, ROADMAP Queue 3). Sweep the"
            " amplitude inside the Parameter instead."
        )
    current_scale_vec = (scales if current_scales is not None
                         else np.ones(B))
    structured = solver.structured
    dev = solver.torch_device
    rd = solver.torch_dtype

    def batched_mu_boundary(times: np.ndarray) -> np.ndarray:
        """(B,) member times -> (B, n_boundary) Neumann BC values.

        Evaluates the user's callable at each member's own time, applies the
        member's bias scale, and nondimensionalizes with the solver's
        J_scale (as ``TDGLSolver.current_func`` does for the static path).
        """
        return np.stack([
            solver._mu_boundary_from_currents(
                {k: solver.J_scale * v * current_scale_vec[b]
                 for k, v in _host_currents(terminal_currents,
                                            float(times[b])).items()}
            )
            for b in range(B)
        ])

    def bc_update(times: np.ndarray) -> Dict[str, torch.Tensor]:
        """The per-member boundary field of a callable bias at ``times``:
        the dense Neumann term (structured) or the boundary values
        (ELL)."""
        mb = batched_mu_boundary(times)
        if structured:
            return {"neumann_term": torch.as_tensor(np.stack(
                [solver._host_neumann_term(m) for m in mb]), dtype=rd,
                device=dev)}
        return {"mu_boundary": torch.as_tensor(mb, dtype=rd, device=dev)}

    # The batch: per-member fields get the member axis, the swept input is
    # scaled per member, and the rest stays shared by all members.
    base_state = solver._initial_state()
    psi_fields = (("psi_r", "psi_i") if structured else ("psi",))
    per_member = psi_fields + ("mu", "mu_prev", "supercurrent",
                               "normal_current", "A_induced",
                               "dpsi_window")
    scales_t = torch.as_tensor(scales, dtype=rd, device=dev)

    def bscale(leaf):
        return leaf[None] * scales_t.reshape((B,) + (1,) * leaf.dim())

    if field_scales is not None:
        scaled = {"A_applied": bscale(base_state.A_applied)}
    elif dynamic_currents:
        scaled = bc_update(np.zeros(B))
    elif structured:
        scaled = {"neumann_term": bscale(base_state.neumann_term)}
    else:
        scaled = {"mu_boundary": bscale(base_state.mu_boundary)}
    state = _member_axis(base_state, B, per_member, scaled)
    member_fields = set(per_member) | set(scaled) | {
        name for name in state._fields
        if getattr(base_state, name).dim() == 0}

    chunk_size = solver.chunk_size

    def indexed(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    solvers = {indexed(dev): solver}

    def solver_on(d):
        """The solver whose operands live on device ``d``."""
        d = indexed(d)
        if d not in solvers:
            solvers[d] = TDGLSolver(
                device, options,
                applied_vector_potential=applied_vector_potential,
                terminal_currents=(_host_currents(terminal_currents, 0.0)
                                   if dynamic_currents
                                   else terminal_currents),
                disorder_epsilon=disorder_epsilon, torch_device=d)
        return solvers[d]

    def block_chunk(s, st):
        if structured:
            return s._raw_chunk_fn(s.sten, s.amg, st, s._screening)
        return s._raw_chunk_fn(s.op, s._screening, s.amg, st)

    # The member blocks: (solver, first member, stop) per mesh entry.
    size = B // len(mesh_devices)
    blocks = [(solver_on(d), i * size, (i + 1) * size)
              for i, d in enumerate(mesh_devices)]

    if len(blocks) > 1:
        state = [_members(state, lo, hi, member_fields, s.torch_device)
                 for s, lo, hi in blocks]

    def batched_chunk(st):
        """One chunk of every block: the blocks' states, and the outputs
        and exports in member order (on the first block's device)."""
        if len(blocks) == 1:
            return block_chunk(solver, st)
        res = [block_chunk(s, b) for (s, _, _), b in zip(blocks, st)]
        return ([r[0] for r in res], _cat_members([r[1] for r in res]),
                _cat_members([r[2] for r in res], solver._initial_export))

    def next_state(st, fields):
        if len(blocks) == 1:
            return st._replace(**fields)
        return [b._replace(**{k: v[lo:hi].to(s.torch_device)
                              for k, v in fields.items()})
                for b, (s, lo, hi) in zip(st, blocks)]

    if max_steps is None:
        max_steps = int(
            min(5e6, 10 * options.solve_time / options.dt_init)
        )
    outputs_list = []
    total = 0
    exported = None
    while total < max_steps:
        state, outputs, exported_dev = batched_chunk(state)
        outputs_list.append(_host_outputs(outputs))
        total += chunk_size
        exported = _to_host(exported_dev)
        # The (6,) diagnostics vector of a single run is (B, 6) here.
        diag = exported["diagnostics"]
        if bool(np.all(diag[:, 4] > 0)):
            break
        if dynamic_currents:
            # Re-evaluate the bias at each member's own simulation time and
            # push the new Neumann BCs for the next chunk.
            state = next_state(state, bc_update(diag[:, 0]))
    diag = exported["diagnostics"]
    failed = diag[:, 5] > 0
    if raise_on_failure and bool(np.any(failed)):
        bad = ", ".join(
            f"{scales[b]:g}" for b in np.flatnonzero(failed)[:8]
        )
        raise RuntimeError(
            f"{int(failed.sum())}/{B} sweep members failed to converge"
            f" (scale values: {bad}). Pass raise_on_failure=False to get"
            " partial results with per-member flags."
        )
    # outputs have shape (B, chunk, ...) per chunk; concatenate along steps.
    def steps_of(name):
        return np.concatenate([getattr(o, name) for o in outputs_list],
                              axis=1)

    dt = np.where(steps_of("valid"), steps_of("dt"), 0.0)
    mu_p = steps_of("mu_probe")  # (B, T, P)
    th_p = steps_of("theta_probe")
    # Every member's final state (a shared field broadcast to the batch:
    # it has the rank of the single run's export).
    single = solver._initial_export
    exported = {k: (np.broadcast_to(v, (B,) + v.shape)
                    if v.ndim == np.ndim(single[k]) else v)
                for k, v in exported.items()}
    if structured:
        maps = solver.maps

        def g2s(g):
            return g.reshape(B, -1)[:, maps.site_flat]

        def g2e(g):
            return g.reshape((B, -1) + g.shape[4:])[:, maps.edge_flat]

        psi = g2s(exported["psi_real"]) + 1j * g2s(exported["psi_imag"])
        mu_final = g2s(exported["mu"])
        sc = g2e(exported["supercurrent"])
        nc = g2e(exported["normal_current"])
    else:
        psi = exported["psi_real"] + 1j * exported["psi_imag"]
        mu_final = exported["mu"]
        sc = exported["supercurrent"]
        nc = exported["normal_current"]
    steps_taken = exported["diagnostics"][:, 3].astype(int)
    dyn_mu = np.transpose(mu_p, (0, 2, 1))
    dyn_theta = np.transpose(th_p, (0, 2, 1))
    solutions = None
    if output_dir is not None:
        solutions = _write_member_solutions(
            output_dir, solver, device, options, exported, scales,
            steps_taken, dt, dyn_mu, dyn_theta, applied_vector_potential,
            terminal_currents, disorder_epsilon,
            field_sweep=(field_scales is not None),
        )
    return SweepResult(
        values=scales,
        psi=psi,
        mu=mu_final,
        supercurrent=sc,
        normal_current=nc,
        dynamics_dt=dt,
        dynamics_mu=dyn_mu,
        dynamics_theta=dyn_theta,
        steps=steps_taken,
        failed=failed,
        times=diag[:, 0],
        solutions=solutions,
    )
