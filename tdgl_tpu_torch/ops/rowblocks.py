"""Grid tensors split into row blocks over an ordered list of devices.

The port's counterpart of the JAX package's row sharding
(:mod:`tdgl_tpu_torch.parallel.spatial`). JAX places each grid-shaped
array with a ``NamedSharding`` that splits its grid-row axis and lets XLA's
SPMD partitioner run the unchanged chunk program, turning each roll into a
halo exchange, each reduction into an all-reduce, and each operation it
cannot split into a gather. Here one process holds the shards: a
:class:`RowBlocks` is a list of row blocks, block ``i`` on ``devices[i]``
(the same device may hold several), and the chunk program of
:mod:`tdgl_tpu_torch.solver.grid_step`, the multigrid V-cycle of
:mod:`tdgl_tpu_torch.ops.hexmg` and the screening of
:mod:`tdgl_tpu_torch.ops.fft_screening` run on it unchanged through
``__torch_function__``:

* elementwise operations run block by block; an unsharded operand that
  spans the whole row axis is split into the same blocks (XLA's
  resharding), one of size 1 there (or with fewer dims) broadcasts;
* ``torch.roll`` along the row axis assembles each block from its
  neighbours' rows (the halo exchange), wrapping around the whole grid as
  ``torch.roll`` does, so the first and last blocks are each other's
  neighbours; a zero pad of the row axis (``F.pad``) extends each block
  by its neighbours' rows (zeros beyond the grid), and a slice of the
  padded rows as long as the grid reads each block's window of them;
* a reduction over the row axis (``sum``, ``max``/``amax``, ``all``,
  ``any``) reduces each block and then combines the partials on the first
  device in block order: deterministic, run after run;
* a reshape that splits the rows into ``(rows // 2, 2)`` (the multigrid's
  2x2 restriction) stays in blocks where every block halves and the
  coarse level keeps an 8-row tile per block (:meth:`RowLayout.
  coarsened`, the rule of the levels' placement), and
  ``repeat_interleave`` along the rows (its transpose) doubles the
  blocks; ``flatten`` from the row axis keeps the blocks (a flat index on
  them, as the probes read, selects from the block that holds each
  entry, with no host read);
* indexing and ``stack`` keep the row axis where they can, and an integer
  index on the row axis returns that row, unsharded.

A reshape that merges the rows with another axis (the pairwise screening
sum, the coarsest level's dense inverse) and an FFT over them (the
screening convolution, the JAX package's replicated-spectra form) gather
the blocks onto the first device, as XLA's partitioner does; their
results split back at the next elementwise operation with a row-sharded
operand. Anything else raises ``NotImplementedError``.
:class:`RowStepOperands` launches the step kernels once per block.
"""

from __future__ import annotations

import copy
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


class RowLayout(NamedTuple):
    """Row ``bounds[i] = (start, stop)`` of block ``i`` on
    ``devices[i]``; the blocks tile ``[0, rows)`` in order."""

    bounds: Tuple[Tuple[int, int], ...]
    devices: Tuple[torch.device, ...]

    @property
    def rows(self) -> int:
        return self.bounds[-1][1]

    def __len__(self) -> int:
        return len(self.bounds)

    def coarsened(self) -> Optional["RowLayout"]:
        """The layout of the next (2x2-coarsened) multigrid level, or None
        where that level is not split: a block does not halve, or the
        level keeps fewer than 8 rows per block (the JAX rule, ``Rp >= 8
        * n_dev``)."""
        if (any(a % 2 or b % 2 for a, b in self.bounds)
                or self.rows // 2 < 8 * len(self)):
            return None
        return RowLayout(tuple((a // 2, b // 2) for a, b in self.bounds),
                         self.devices)

    def scaled(self, k: int) -> "RowLayout":
        """The same blocks with ``k`` entries to a row (a flattened or
        repeated row axis)."""
        return RowLayout(tuple((a * k, b * k) for a, b in self.bounds),
                         self.devices)


def row_layout(rows: int, devices: Sequence, tile: int = 8) -> RowLayout:
    """Split ``rows`` (a multiple of ``tile``) into ``len(devices)``
    contiguous blocks of whole ``tile``-row tiles, as even as they go (the
    first blocks take one tile more)."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if rows % tile or rows < tile * n:
        raise ValueError(f"{rows} rows do not split into {n} blocks of"
                         f" whole {tile}-row tiles")
    tiles, extra = divmod(rows // tile, n)
    bounds, start = [], 0
    for i in range(n):
        stop = start + tile * (tiles + (i < extra))
        bounds.append((start, stop))
        start = stop
    return RowLayout(tuple(bounds), devices)


def _norm_dim(d: int, nd: int) -> int:
    """``d`` as a negative dim of an ``nd``-dim tensor."""
    if not -nd <= d < nd:
        raise IndexError(f"dim {d} out of range for {nd} dims")
    return d - nd if d >= 0 else d


def _dims(dim, nd: int) -> Tuple[int, ...]:
    if isinstance(dim, int):
        dim = (dim,)
    return tuple(_norm_dim(d, nd) for d in dim)


class RowBlocks:
    """A grid-shaped tensor held as row blocks (see the module docstring).

    ``axis`` is the (negative) dim of the grid rows, the same in every
    block; ``layout`` gives each block's rows and device.
    """

    def __init__(self, blocks: Sequence[torch.Tensor], axis: int,
                 layout: RowLayout, margin: int = 0):
        self.blocks: List[torch.Tensor] = list(blocks)
        self.axis = axis
        self.layout = layout
        # Zero-padded rows on either side of the grid (``F.pad``): each
        # block then holds its rows and ``margin`` more on either side.
        self.margin = margin
        self._ext = {}

    # -- what a tensor reports -------------------------------------------
    @property
    def shape(self) -> torch.Size:
        s = list(self.blocks[0].shape)
        s[self.axis] = self.layout.rows + 2 * self.margin
        return torch.Size(s)

    def dim(self) -> int:
        return self.blocks[0].dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first block's device, where reductions land."""
        return self.blocks[0].device

    def __repr__(self) -> str:
        return (f"RowBlocks(shape={tuple(self.shape)}, axis={self.axis},"
                f" bounds={self.layout.bounds}, dtype={self.dtype})")

    def to(self, dtype) -> "RowBlocks":
        """A dtype conversion (devices are set by the layout)."""
        if not isinstance(dtype, torch.dtype):
            raise NotImplementedError(
                "RowBlocks.to takes a dtype; the layout sets the devices")
        if all(b.dtype == dtype for b in self.blocks):
            return self
        return self._like([b.to(dtype) for b in self.blocks])

    def contiguous(self) -> "RowBlocks":
        return self._like([b.contiguous() for b in self.blocks])

    def new_full(self, size, fill_value, dtype=None) -> torch.Tensor:
        """An unsharded tensor on the first device."""
        return torch.full(size, fill_value, dtype=dtype or self.dtype,
                          device=self.device)

    def reshape(self, *shape):
        return _reshape(self, *shape)

    def flatten(self, start_dim: int = 0, end_dim: int = -1):
        return _flatten(self, start_dim, end_dim)

    def movedim(self, source, destination):
        return _movedim(self, source, destination)

    def sum(self, dim=None, **kwargs):
        return _sum(self, dim, **kwargs)

    def amax(self, dim=None):
        return _amax(self, dim)

    def _like(self, blocks, axis=None) -> "RowBlocks":
        return RowBlocks(blocks, self.axis if axis is None else axis,
                         self.layout)

    # -- rows across blocks ----------------------------------------------
    def rows(self, lo: int, hi: int, device, zero_fill: bool = False
             ) -> torch.Tensor:
        """Global rows ``[lo, hi)`` on ``device``. Rows outside ``[0,
        rows)`` wrap around the grid (as ``torch.roll`` reads them), or are
        zeros with ``zero_fill``."""
        R = self.layout.rows
        pieces = []
        r = lo
        while r < hi:
            if zero_fill and not 0 <= r < R:
                stop = min(hi, 0) if r < 0 else hi
                shape = list(self.blocks[0].shape)
                shape[self.axis] = stop - r
                pieces.append(torch.zeros(shape, dtype=self.dtype,
                                          device=device))
                r = stop
                continue
            g = r % R
            for j, (a, b) in enumerate(self.layout.bounds):
                if a <= g < b:
                    break
            take = min(hi - r, b - g)
            pieces.append(self.blocks[j].narrow(self.axis, g - a, take)
                          .to(device))
            r += take
        if len(pieces) == 1:
            return pieces[0].contiguous()
        return torch.cat(pieces, dim=self.axis)

    def ext(self, halo: int, zero_fill: bool = False) -> List[torch.Tensor]:
        """Each block with ``halo`` rows of its neighbours on either side
        (contiguous, on its device); kept on this object, so a fixed
        operand is extended once."""
        key = (halo, zero_fill)
        if key not in self._ext:
            self._ext[key] = [
                self.rows(a - halo, b + halo, dev, zero_fill)
                for (a, b), dev in zip(self.layout.bounds,
                                       self.layout.devices)]
        return self._ext[key]

    # -- torch functions ---------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name in _ELEMENTWISE:
            return _map(func, args, kwargs)
        handler = _HANDLERS.get(name)
        if handler is None and name.startswith("fft_"):
            handler = _gathered(func)
        if handler is None:
            raise NotImplementedError(
                f"{name} is not defined on row-sharded tensors")
        return handler(*args, **kwargs)

    def __getitem__(self, key):
        return _getitem(self, key)


def _binary(name):
    op = getattr(torch.Tensor, name)

    def method(self, other):
        return _map(op, (self, other), {})

    method.__name__ = name
    return method


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__pow__",
              "__rpow__", "__lt__", "__le__", "__gt__", "__ge__",
              "__and__", "__rand__", "__or__", "__ror__", "__xor__"):
    setattr(RowBlocks, _name, _binary(_name))
RowBlocks.__neg__ = lambda self: _map(torch.Tensor.__neg__, (self,), {})
RowBlocks.__invert__ = lambda self: _map(torch.Tensor.__invert__, (self,),
                                         {})
RowBlocks.__abs__ = lambda self: _map(torch.Tensor.__abs__, (self,), {})


_ELEMENTWISE = {
    "add", "sub", "mul", "div", "true_divide", "pow", "neg", "sqrt", "cos",
    "sin", "atan2", "clamp", "abs", "isfinite", "logical_and", "logical_or",
    "logical_not", "where", "maximum", "minimum", "zeros_like", "ones_like",
    "empty_like", "full_like", "square", "exp",
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__pow__", "__rpow__", "__neg__",
    "__lt__", "__le__", "__gt__", "__ge__", "__and__", "__rand__", "__or__",
    "__ror__", "__xor__", "__invert__", "__abs__",
}


def _layout_of(values) -> Tuple[RowLayout, int]:
    found = None
    for v in values:
        if isinstance(v, RowBlocks):
            if found is None:
                found = (v.layout, v.axis)
            elif v.axis != found[1] or (v.layout is not found[0]
                                        and v.layout != found[0]):
                raise ValueError(
                    f"row-sharded operands differ in layout or row axis:"
                    f" {found} and {(v.layout, v.axis)}")
    return found


def _on(v, i: int, layout: RowLayout, axis: int):
    """Operand ``v`` for block ``i``."""
    if isinstance(v, RowBlocks):
        return v.blocks[i]
    if isinstance(v, torch.Tensor):
        dev = layout.devices[i]
        if v.dim() >= -axis and v.shape[axis] != 1:
            if v.shape[axis] != layout.rows:
                raise ValueError(
                    f"an unsharded tensor of shape {tuple(v.shape)} does"
                    f" not match the {layout.rows} rows of a row-sharded"
                    f" one")
            a, b = layout.bounds[i]
            v = v.narrow(axis, a, b - a)
        return v if v.device == dev else v.to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(_on(x, i, layout, axis) for x in v)
    return v


def _map(func, args, kwargs):
    """``func`` block by block (elementwise: the row axis stays put)."""
    values = list(args) + list(kwargs.values())
    if any(isinstance(v, RowBlocks) and v.margin for v in values):
        raise NotImplementedError("elementwise operations on row-padded"
                                  " tensors; slice them first")
    layout, axis = _layout_of(values)
    blocks = []
    for i in range(len(layout.bounds)):
        a = [_on(v, i, layout, axis) for v in args]
        if kwargs:
            blocks.append(func(*a, **{k: _on(v, i, layout, axis)
                                      for k, v in kwargs.items()}))
        else:
            blocks.append(func(*a))
    return RowBlocks(blocks, axis, layout)


def _combine(partials, op):
    """Partials of the blocks, combined on the first block's device in
    block order."""
    acc = partials[0]
    for p in partials[1:]:
        acc = op(acc, p.to(acc.device))
    return acc


def _reduce(x: RowBlocks, dim, reduce_fn, combine):
    _unpadded(x, "a reduction")
    nd = x.dim()
    if dim is None:
        return _combine([reduce_fn(b) for b in x.blocks], combine)
    dims = _dims(dim, nd)
    partials = [reduce_fn(b, dim=dims) for b in x.blocks]
    if x.axis in dims:
        return _combine(partials, combine)
    return x._like(partials, axis=x.axis + sum(d > x.axis for d in dims))


def _sum(x, dim=None, **kwargs):
    if kwargs:
        raise NotImplementedError(f"sum with {sorted(kwargs)}")
    return _reduce(x, dim, torch.sum, torch.add)


def _amax(x, dim=None):
    return _reduce(x, dim, torch.amax, torch.maximum)


def _max(x, dim=None):
    if dim is not None:
        raise NotImplementedError("max with dim on row-sharded tensors")
    return _reduce(x, None, torch.max, torch.maximum)


def _all(x, dim=None):
    if dim is not None:
        raise NotImplementedError("all with dim on row-sharded tensors")
    return _reduce(x, None, torch.all, torch.logical_and)


def _any(x, dim=None):
    if dim is not None:
        raise NotImplementedError("any with dim on row-sharded tensors")
    return _reduce(x, None, torch.any, torch.logical_or)


def _roll(x: RowBlocks, shifts, dims):
    """``torch.roll`` of a row-sharded tensor: the shift along the row
    axis reads each block's rows from the blocks that hold them."""
    _unpadded(x, "roll")
    if isinstance(shifts, int):
        shifts = (shifts,)
    nd = x.dim()
    dims = _dims(dims, nd)
    row_shift = 0
    local_s, local_d = [], []
    for s, d in zip(shifts, dims):
        if d == x.axis:
            row_shift += s
        else:
            local_s.append(s)
            local_d.append(d)
    blocks = []
    for (a, b), dev in zip(x.layout.bounds, x.layout.devices):
        blk = x.rows(a - row_shift, b - row_shift, dev)
        if local_s:
            blk = torch.roll(blk, tuple(local_s), tuple(local_d))
        blocks.append(blk)
    return x._like(blocks)


def _stack(tensors, dim=0):
    tensors = list(tensors)
    layout, axis = _layout_of(tensors)
    tensors = [split(t, layout, axis) for t in tensors]
    nd = tensors[0].dim()
    d = dim if dim >= 0 else dim + nd + 1
    p = nd + axis
    p_new = p + 1 if d <= p else p
    blocks = [torch.stack([t.blocks[i] for t in tensors], dim=dim)
              for i in range(len(layout))]
    return RowBlocks(blocks, p_new - (nd + 1), layout)


def _getitem(x: RowBlocks, key):
    if not isinstance(key, tuple):
        key = (key,)
    nd = x.dim()
    n_real = sum(1 for k in key if k is not None and k is not Ellipsis)
    at = [i for i, k in enumerate(key) if k is Ellipsis]
    fill = (slice(None),) * (nd - n_real)
    if at:
        key = key[:at[0]] + fill + key[at[0] + 1:]
    else:
        key = key + fill
    row_pos = nd + x.axis
    dim_in = out_dim = 0
    row_key = row_out = None
    for k in key:
        if k is None:
            out_dim += 1
            continue
        if dim_in == row_pos:
            row_key, row_out = k, out_dim
        elif not isinstance(k, (int, slice)):
            raise NotImplementedError("tensor indexing of row-sharded"
                                      " tensors off the row axis")
        if isinstance(k, slice):
            out_dim += 1
        dim_in += 1
    slot = _row_slot(key, row_pos)
    if isinstance(row_key, torch.Tensor):
        return _take(x, key, slot, row_key)
    if not isinstance(row_key, (int, slice)):
        raise NotImplementedError("indexing the rows of a row-sharded"
                                  f" tensor with {type(row_key).__name__}")
    if isinstance(row_key, int):
        if x.margin:
            raise NotImplementedError("a row of a row-padded tensor")
        g = row_key % x.layout.rows
        for j, (a, b) in enumerate(x.layout.bounds):
            if a <= g < b:
                local = list(key)
                local[slot] = g - a
                return x.blocks[j][tuple(local)]
    axis = row_out - out_dim
    if x.margin:
        # A window of the padded rows as long as the grid: each block's
        # rows sit at the same offset in its padded block.
        lo, hi, step = row_key.indices(x.layout.rows + 2 * x.margin)
        if step != 1 or hi - lo != x.layout.rows:
            raise NotImplementedError("a row-padded tensor slices a window"
                                      " of the grid's length")
        blocks = []
        for blk, (a, b) in zip(x.blocks, x.layout.bounds):
            local = list(key)
            local[slot] = slice(lo, lo + b - a)
            blocks.append(blk[tuple(local)])
        return RowBlocks(blocks, axis, x.layout)
    if row_key != slice(None):
        raise NotImplementedError("slicing the row axis of a row-sharded"
                                  " tensor")
    return x._like([b[key] for b in x.blocks], axis=axis)


def _take(x: RowBlocks, key, slot: int, ix: torch.Tensor) -> torch.Tensor:
    """``x[key]`` for an index tensor ``ix`` on the row axis (every other
    entry a full slice): each entry is read from the block that holds it
    and selected on the first device, with no host read."""
    if x.margin or any(k != slice(None) for j, k in enumerate(key)
                       if j != slot):
        raise NotImplementedError("an index tensor on the rows of a"
                                  " row-sharded tensor, with other entries")
    first = x.device
    trailing = (1,) * (-x.axis - 1)
    out = None
    for blk, (a, b) in zip(x.blocks, x.layout.bounds):
        local = list(key)
        local[slot] = (ix.to(blk.device) - a).clamp(0, b - a - 1)
        vals = blk[tuple(local)].to(first)
        if out is None:
            out = vals
            continue
        ix_f = ix.to(first)
        sel = ((ix_f >= a) & (ix_f < b)).reshape(ix.shape + trailing)
        out = torch.where(sel, vals, out)
    return out


def _row_slot(key, row_pos: int) -> int:
    """The position in ``key`` of the row axis' entry."""
    dim_in = 0
    for i, k in enumerate(key):
        if k is None:
            continue
        if dim_in == row_pos:
            return i
        dim_in += 1
    raise IndexError("no row entry")


def _unpadded(x: RowBlocks, what: str) -> None:
    if x.margin:
        raise NotImplementedError(f"{what} of a row-padded tensor")


def _reshape(x: RowBlocks, *shape):
    """Keeps the blocks where the rows stay one axis or split into ``(rows
    // 2, 2)`` onto :meth:`RowLayout.coarsened`; else gathers."""
    _unpadded(x, "reshape")
    if len(shape) == 1 and not isinstance(shape[0], int):
        shape = tuple(shape[0])
    old = tuple(x.shape)
    numel = math.prod(old)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(numel // known if d == -1 else d for d in shape)
    shape = tuple(int(d) for d in shape)
    p = len(old) + x.axis
    pre, post, R = math.prod(old[:p]), math.prod(old[p + 1:]), \
        x.layout.rows
    for q in range(len(shape)):
        if math.prod(shape[:q]) != pre:
            continue
        if shape[q] == R and math.prod(shape[q + 1:]) == post:
            return RowBlocks(
                [blk.reshape(shape[:q] + (b - a,) + shape[q + 1:])
                 for blk, (a, b) in zip(x.blocks, x.layout.bounds)],
                q - len(shape), x.layout)
        if (q + 1 < len(shape) and shape[q:q + 2] == (R // 2, 2)
                and math.prod(shape[q + 2:]) == post):
            coarse = x.layout.coarsened()
            if coarse is not None:
                return RowBlocks(
                    [blk.reshape(shape[:q] + ((b - a) // 2, 2)
                                 + shape[q + 2:])
                     for blk, (a, b) in zip(x.blocks, x.layout.bounds)],
                    q - len(shape), coarse)
    return gather(x).reshape(shape)


def _flatten(x: RowBlocks, start_dim: int = 0, end_dim: int = -1):
    """Keeps the blocks unless the flattened dims start before the rows
    and reach them (then gathers)."""
    _unpadded(x, "flatten")
    nd = x.dim()
    s, e, p = start_dim % nd, end_dim % nd, nd + x.axis
    if s < p <= e:
        return torch.flatten(gather(x), start_dim, end_dim)
    blocks = [blk.flatten(start_dim, end_dim) for blk in x.blocks]
    if p < s:
        return RowBlocks(blocks, x.axis + (e - s), x.layout)
    if p > e:
        return x._like(blocks)
    k = math.prod(x.shape[p + 1:e + 1])
    return RowBlocks(blocks, x.axis + (e - s), x.layout.scaled(k))


def _movedim(x: RowBlocks, source, destination):
    _unpadded(x, "movedim")
    nd = x.dim()
    # Track the row axis through the same move on a sizeless tensor whose
    # dim i has size i + 2.
    moved = torch.empty(tuple(range(2, nd + 2)), device="meta").movedim(
        source, destination).shape
    axis = list(moved).index(nd + x.axis + 2) - nd
    return RowBlocks([blk.movedim(source, destination) for blk in x.blocks],
                     axis, x.layout)


def _repeat_interleave(x: RowBlocks, repeats, dim=None, **kwargs):
    _unpadded(x, "repeat_interleave")
    if not isinstance(repeats, int) or dim is None or kwargs:
        raise NotImplementedError("repeat_interleave of a row-sharded"
                                  " tensor takes an int and a dim")
    blocks = [torch.repeat_interleave(blk, repeats, dim=dim)
              for blk in x.blocks]
    if _norm_dim(dim, x.dim()) == x.axis:
        return RowBlocks(blocks, x.axis, x.layout.scaled(repeats))
    return x._like(blocks)


def _pad(x: RowBlocks, pad, mode: str = "constant", value=None):
    """``F.pad`` with zeros: a pad of the rows extends each block by its
    neighbours' rows (zeros beyond the grid) and marks the margin."""
    _unpadded(x, "pad")
    if mode != "constant" or value not in (None, 0, 0.0):
        raise NotImplementedError(f"pad mode {mode!r} of a row-sharded"
                                  " tensor")
    pad = list(pad)
    j = 2 * (-x.axis - 1)
    top, bottom = (pad[j], pad[j + 1]) if j + 1 < len(pad) else (0, 0)
    if not top and not bottom:
        return x._like([F.pad(blk, pad) for blk in x.blocks])
    if top != bottom:
        raise NotImplementedError("an uneven pad of the rows")
    pad[j] = pad[j + 1] = 0
    return RowBlocks([F.pad(blk, pad) for blk in x.ext(top, zero_fill=True)],
                     x.axis, x.layout, margin=top)


def _gathered(func):
    """``func`` on the blocks gathered onto the first device."""
    def run(*args, **kwargs):
        return func(*(gather(v) for v in args),
                    **{k: gather(v) for k, v in kwargs.items()})
    return run


_HANDLERS = {
    "sum": _sum,
    "amax": _amax,
    "max": _max,
    "all": _all,
    "any": _any,
    "roll": _roll,
    "stack": _stack,
    "reshape": _reshape,
    "flatten": _flatten,
    "movedim": _movedim,
    "repeat_interleave": _repeat_interleave,
    "pad": _pad,
}


# -- placing and gathering ------------------------------------------------

def split(x: torch.Tensor, layout: RowLayout, axis: int) -> RowBlocks:
    """``x`` cut into the blocks of ``layout`` along ``axis``, each moved
    to its device."""
    if isinstance(x, RowBlocks):
        return x
    axis = _norm_dim(axis, x.dim())
    if x.shape[axis] != layout.rows:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} is not"
                         f" {layout.rows} rows")
    return RowBlocks([x.narrow(axis, a, b - a).to(dev).contiguous()
                      for (a, b), dev in zip(layout.bounds,
                                             layout.devices)],
                     axis, layout)


def gather(x):
    """A row-sharded tensor whole, on its first device (a tensor as it
    is)."""
    if not isinstance(x, RowBlocks):
        return x
    dev = x.device
    return torch.cat([b.to(dev) for b in x.blocks], dim=x.axis)


# -- the step kernels per block --------------------------------------------

# Halo rows of a kernel's block: the stencils reach one row; eight keep
# each block on the kernels' 8-row tile.
KERNEL_HALO = 8


class RowStepOperands:
    """:class:`~tdgl_tpu_torch.ops.step_kernels.StepOperands` of a
    row-sharded stencil: one per block, each on the block extended by
    :data:`KERNEL_HALO` rows (with ``valid`` zeroed in the halo, so the
    psi kernel's ``ok`` counts only the block's own sites). A call
    extends its per-call planes, launches each block's kernel (or plain
    version, on the CPU) in block order on its device's stream, and keeps
    the interior rows; ``ok`` is the AND over blocks. The same interface
    as ``StepOperands``: :meth:`rebind`, :meth:`psi_update`,
    :meth:`poisson_rhs` and ``U``."""

    def __init__(self, sten, U=None, dA_dt=None, neumann_term=None):
        from .step_kernels import StencilOperands, StepOperands

        self.sten = sten
        layout = sten.valid.layout
        self.layout = layout
        self.halo = h = KERNEL_HALO
        shards = []
        for i, ((a, b), dev) in enumerate(zip(layout.bounds,
                                              layout.devices)):
            fields = {}
            for name in sten._fields:
                v = getattr(sten, name)
                fields[name] = (v.ext(h)[i] if isinstance(v, RowBlocks)
                                else v.to(dev))
            valid = fields["valid"].clone()
            valid[..., :h, :] = 0
            valid[..., h + b - a:, :] = 0
            fields["valid"] = valid
            shards.append(StepOperands(StencilOperands(
                type(sten)(**fields))))
        self.shards = shards
        self.U = self.dA_dt = self.neumann_term = None
        self._bind(U, dA_dt, neumann_term)

    def _ext(self, v, i):
        if v is None:
            return None
        if (isinstance(v, torch.Tensor) and v.dim() >= 2
                and v.shape[-2] == self.layout.rows):
            v = split(v, self.layout, -2)
        if isinstance(v, RowBlocks):
            return v.ext(self.halo)[i]
        return v.to(self.layout.devices[i])

    def _bind(self, U, dA_dt, neumann_term) -> None:
        from ..models import gtdgl_stencil as gs

        if U is not None:
            self.U = U
        if dA_dt is not None:
            self.dA_dt = dA_dt
        if neumann_term is not None:
            self.neumann_term = neumann_term
        for i, shard in enumerate(self.shards):
            if U is None:
                U_i = None
            elif isinstance(U, gs.FactoredLinkPhases):
                U_i = gs.FactoredLinkPhases(*(self._ext(v, i) for v in U))
            else:
                # The kernels and plain versions read ur/ui only.
                U_i = gs.LinkPhases(self._ext(U.ur, i), self._ext(U.ui, i),
                                    None, None)
            self.shards[i] = shard.rebind(U=U_i,
                                          dA_dt=self._ext(dA_dt, i),
                                          neumann_term=self._ext(
                                              neumann_term, i))

    def rebind(self, U=None, dA_dt=None, neumann_term=None
               ) -> "RowStepOperands":
        new = copy.copy(self)
        new.shards = list(self.shards)
        new._bind(U, dA_dt, neumann_term)
        return new

    def _interior(self, outs):
        h = self.halo
        return [RowBlocks([o.narrow(-2, h, b - a) for o, (a, b) in
                           zip(col, self.layout.bounds)], -2, self.layout)
                for col in outs]

    def psi_update(self, gamma, u, pr, pi, mu, epsilon, dt, abs_sq=None):
        res = []
        for i, shard in enumerate(self.shards):
            res.append(shard.psi_update(
                gamma, u, self._ext(pr, i), self._ext(pi, i),
                self._ext(mu, i), self._ext(epsilon, i),
                dt.to(self.layout.devices[i]) if isinstance(
                    dt, torch.Tensor) else dt, self._ext(abs_sq, i)))
        new_r, new_i, new_sq = self._interior(
            [[r[k] for r in res] for k in range(3)])
        ok = _combine([r[3] for r in res], torch.logical_and)
        return new_r, new_i, new_sq, ok

    def poisson_rhs(self, pr, pi, with_supercurrent: bool = False):
        res = [shard.poisson_rhs(self._ext(pr, i), self._ext(pi, i),
                                 with_supercurrent)
               for i, shard in enumerate(self.shards)]
        if not with_supercurrent:
            return self._interior([res])[0]
        rhs, J_s = self._interior([[r[0] for r in res],
                                   [r[1] for r in res]])
        return rhs, J_s
