"""Single-problem multi-device execution: split one structured solve's grid
rows over an ordered list of devices.

Port of :mod:`tdgl_tpu.parallel.spatial`, with the same three names. The
JAX package is single-controller SPMD: it places every grid-shaped array
with a ``NamedSharding`` that splits the row axis over a 1-D mesh and runs
the unchanged chunk program, which XLA's partitioner turns into halo
exchanges and all-reduces. This package is one process that holds the
devices in order: :func:`shard_solver_spatially` replaces the solver's
grid-shaped tensors by :class:`~tdgl_tpu_torch.ops.rowblocks.RowBlocks`
(block ``i`` of the rows on ``devices[i]``; one device may hold several
blocks), and the unchanged chunk program of
:mod:`tdgl_tpu_torch.solver.grid_step` runs on them: elementwise work
block by block, each roll along the rows as a halo exchange between
neighbouring blocks (the first and last are neighbours, as ``torch.roll``
wraps), each reduction as per-block partials summed on the first device
in block order (deterministic), and ``ok`` as the AND over blocks. All
that the solver modules do not know of sharding is in
:mod:`tdgl_tpu_torch.ops.rowblocks`; this module places the operands and
builds the chunk with the per-block kernel operands. No
``torch.distributed``.

Where this package departs from the JAX one, with the same results:

* The two CUDA step kernels stay: each launches once per block, on the
  block extended by eight halo rows (the kernels' 8-row tile; the
  block's ``valid`` plane is zeroed in the halo, so ``ok`` counts only
  its own sites), in block order on its device's stream, so the kernels'
  self-resetting flag words serve every launch. The JAX package rebuilds
  its sharded chunk without Pallas, which its partitioner cannot split.
* The multigrid levels split while each block keeps whole 2x2 cells and
  the level keeps ``8 * n_dev`` rows (the JAX rule); each level stencil
  reads halo-extended blocks. Coarser levels and the dense coarsest
  inverse live on the first device: the restriction onto them gathers,
  and the prolongation back splits.
* FFT screening runs as the JAX package's pencil decomposition
  (:mod:`tdgl_tpu_torch.parallel.fft_sharded`) when the grid rows divide
  over the devices: column FFTs per block, a transpose by ``.to()`` into
  column pencils, row FFTs against each device's column shard of the
  kernel spectra, and the way back; ``cfg.screening_eval_fn`` carries it
  into the chunk, ahead of the site-evaluated form. Otherwise (logged, as
  in the JAX package) the weighted current gathers onto the first
  device, the exact convolution runs there with the whole spectra and
  the potential splits back into blocks.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import rowblocks

__all__ = ["spatial_device_mesh", "shard_solver_spatially", "spatial_spec"]

logger = logging.getLogger(__name__)

_AXIS = "rows"


class DeviceMesh(NamedTuple):
    """A 1-D mesh: the ordered devices of the ``"rows"`` axis (the
    counterpart of a one-axis ``jax.sharding.Mesh``)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def spatial_device_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """A 1-D device mesh over ``devices`` (default: every visible CUDA
    device; a device may repeat, and each entry holds one block)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spatial_device_mesh() defaults to the visible CUDA devices"
                " and CUDA is not available; pass devices=[...] (e.g."
                " ['cpu'] * 4) to run on the CPU.")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a device mesh needs at least one device")
    return DeviceMesh(devices)


def spatial_spec(shape, Rp: int, Cp: int, n_dev: int) -> Optional[int]:
    """The axis of ``shape`` to split into row blocks (the first of
    adjacent ``(Rp, Cp)`` dims), or None where the array replicates: the
    counterpart of the JAX function's ``P(..., "rows", ...)`` and
    ``P()``. It splits only when every device gets at least one 8-row
    tile (``Rp >= 8 * n_dev``)."""
    shape = tuple(shape)
    for i in range(len(shape) - 1):
        if shape[i] == Rp and shape[i + 1] == Cp:
            if Rp >= 8 * n_dev:
                return i
    return None


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_solver_spatially(solver, mesh: Optional[DeviceMesh] = None, *,
                           allow_replicated: bool = False):
    """Re-place a structured :class:`TDGLSolver`'s operands so its chunk
    runs over row blocks on ``mesh`` (grid rows split over its devices;
    everything else on the first device).

    Call once after constructing the solver and before the first chunk;
    then place each state with the returned function:

    ```python
    solver = TDGLSolver(device, options, ..., torch_device="cuda")
    place = shard_solver_spatially(solver, spatial_device_mesh())
    state = place(solver._initial_state())
    state, outputs, exported = solver.chunk_fn(state)
    ```

    The state stays row-sharded from chunk to chunk; ``exported`` holds
    whole tensors on the first device.

    Raises:
        ValueError: for a solver on the unstructured backend, and when
            the grid is too small to give every device at least one 8-row
            tile, so nothing would split and every device would hold the
            whole problem. Pass ``allow_replicated=True`` to accept that
            placement (everything on the first device) anyway.

    Returns:
        ``place(tree)``: places a state (any tuple, list or dict of
        tensors) with the same row-splitting rule.
    """
    if not getattr(solver, "structured", False):
        raise ValueError(
            "Spatial sharding requires the structured (stencil) backend:"
            " mesh with device.make_mesh(structured=True)."
        )
    if mesh is None:
        mesh = spatial_device_mesh()
    elif not isinstance(mesh, DeviceMesh):
        mesh = spatial_device_mesh(mesh)
    n_dev = mesh.size
    first = mesh.devices[0]
    Rp, Cp = solver.maps.shape
    if n_dev > 1 and spatial_spec((Rp, Cp), Rp, Cp, n_dev) is None:
        msg = (
            f"Grid ({Rp}, {Cp}) is too small to shard over {n_dev} devices:"
            f" row-sharding needs Rp >= 8 * n_dev = {8 * n_dev} so every"
            " device gets at least one 8-row tile. Every array would be"
            " REPLICATED (n_dev x the memory, no speedup). Use a finer mesh,"
            " fewer devices, or pass allow_replicated=True to proceed"
            " anyway."
        )
        if not allow_replicated:
            raise ValueError(msg)
        logger.warning(msg)
    layout = (rowblocks.row_layout(Rp, mesh.devices)
              if spatial_spec((Rp, Cp), Rp, Cp, n_dev) is not None
              else None)

    def placer(R, C, lay):
        def put(leaf):
            spec = (None if lay is None
                    else spatial_spec(leaf.shape, R, C, n_dev))
            if spec is None:
                return leaf.to(first)
            return rowblocks.split(leaf, lay, spec - leaf.dim())
        return put

    def place(tree):
        return _tree_map(placer(Rp, Cp, layout), tree)

    solver.sten = place(solver.sten)
    if solver.amg is not None:
        from ..ops.hexmg import HexMGData

        # A level splits where the 2x2 restriction keeps the blocks
        # (RowLayout.coarsened, the JAX rule); the dense coarsest inverse
        # and the levels below the last split one live on the first
        # device.
        levels, lay = [], layout
        for lvl, arrays in enumerate(solver.amg.level_arrays):
            if lvl and lay is not None:
                lay = lay.coarsened()
            R_l, C_l = solver.amg.shapes[lvl]
            levels.append(_tree_map(
                placer(R_l, C_l, None if "Ainv" in arrays else lay),
                arrays))
        solver.amg = HexMGData(levels, solver.amg.offsets,
                               solver.amg.shapes, solver.amg.p_omega)
    if solver._screening is not None:
        weights, fft_data = solver._screening
        eval_fn = None
        if fft_data is not None and layout is not None:
            from .fft_sharded import (make_sharded_fft_screening,
                                      pad_fft_data_for_sharding)

            eval_fn = make_sharded_fft_screening(mesh, Rp, Cp)
            if eval_fn is None:
                logger.warning(
                    "Grid rows (%d) do not pencil-decompose over %d devices;"
                    " FFT screening spectra will replicate.", Rp, n_dev)
        if eval_fn is not None:
            # The pencil form, set before the row chunks are built.
            fft_data = pad_fft_data_for_sharding(fft_data, n_dev, mesh)
            solver.cfg = dataclasses.replace(solver.cfg,
                                             screening_eval_fn=eval_fn)
            if getattr(solver, "_fast_cfg", None) is not None:
                solver._fast_cfg = dataclasses.replace(
                    solver._fast_cfg, screening_eval_fn=eval_fn)
        else:
            fft_data = _tree_map(lambda t: t.to(first), fft_data)
        solver._screening = (place(weights), fft_data)
    if layout is not None:
        solver._raw_chunk_fn = _row_chunk_fn(solver, solver.cfg, place)
        if getattr(solver, "_fast_cfg", None) is not None:
            solver._fast_chunk_fn = _row_chunk_fn(solver, solver._fast_cfg,
                                                  place)
    return place


def _row_chunk_fn(solver, cfg, place):
    """The solver's chunk program over row blocks: the step kernels
    launched per block (:class:`~tdgl_tpu_torch.ops.rowblocks.
    RowStepOperands`), traced grid inputs placed as they are evaluated,
    and the exported arrays gathered whole onto the first device."""
    from ..solver.grid_step import make_grid_chunk_fn

    def placed(fn):
        return None if fn is None else (lambda t: place(fn(t)))

    chunk = make_grid_chunk_fn(
        dataclasses.replace(cfg, A_fn=placed(cfg.A_fn),
                            eps_fn=placed(cfg.eps_fn)),
        solver.chunk_size, operands=rowblocks.RowStepOperands)

    def run(*args):
        final, outputs, exported = chunk(*args)
        return final, outputs, {k: rowblocks.gather(v)
                                for k, v in exported.items()}

    return run
