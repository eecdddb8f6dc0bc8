"""Distributed FFT screening for row-sharded solves.

Port of :mod:`tdgl_tpu.parallel.fft_sharded`, with the same three names.
Under row sharding (:mod:`tdgl_tpu_torch.parallel.spatial`) the weighted
current is a :class:`~tdgl_tpu_torch.ops.rowblocks.RowBlocks`. Run through
``RowBlocks.__torch_function__``, every FFT of the exact screening
convolution (:mod:`tdgl_tpu_torch.ops.fft_screening`) would gather the
whole grid onto the first device. This module computes the SAME
convolution as a **pencil decomposition** on the blocks directly:

1. columns (per block): zero-pad the columns to ``2 Cp``, ``rfft`` along
   them, pad the ``Cp + 1`` bins to ``cpad`` (a multiple of the block
   count);
2. transpose (the all-to-all): each block's bins split into ``n`` pieces
   of ``cpad / n``; piece ``j`` moves to ``devices[j]`` (``.to()``), where
   the pieces are joined in block order into a column pencil ``(Rp, cpad /
   n)``;
3. rows (per pencil): zero-extend the rows to ``2 Rp``, ``fft`` along
   them, multiply by that device's column shard of the kernel spectra
   ``Ghat`` (a complex product: this package keeps ``Ghat`` complex), take
   the inverse ``fft`` and keep the unaliased ``Rp`` rows;
4. transpose back the same way, ``irfft`` along the columns with ``n = 2
   Cp``, crop to ``Cp`` and mask with each block's ``edge_valid``.

Each pencil's row transforms and spectrum product cover ``1/n`` of the
bins, and each device stores ``1/n`` of ``Ghat``
(:func:`pad_fft_data_for_sharding`); the cost is two transposes of the
current's spectrum. One process holds the devices in order (no
``torch.distributed``); when several blocks share a device, as on one
card, the moves are no-ops and the decomposition only adds host work.
The FFTs are ``torch.fft`` (cuFFT on the card), as in the JAX module,
which calls ``jnp.fft`` outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import rowblocks
from ..ops.fft_screening import FFTScreeningData

__all__ = ["make_sharded_fft_screening", "pad_fft_data_for_sharding"]


def _cpad(Cp: int, n_dev: int) -> int:
    """Column-spectrum length padded to a multiple of the device count."""
    nbins = Cp + 1
    return ((nbins + n_dev - 1) // n_dev) * n_dev


def pad_fft_data_for_sharding(fft_data: FFTScreeningData, n_dev: int,
                              mesh) -> FFTScreeningData:
    """Zero-pad the kernel spectra's column axis to ``_cpad(Cp, n_dev)``
    and give each device of ``mesh`` its own column shard (``fft_data``
    of tensors).

    ``mesh`` is a :class:`~tdgl_tpu_torch.parallel.spatial.DeviceMesh`.
    Returns an :class:`FFTScreeningData` whose ``Ghat`` is a tuple of
    ``n_dev`` tensors ``(3, 2 Rp, cpad / n_dev)``, shard ``j`` on the
    mesh's ``j``-th device (a device listed twice holds two shards), and
    whose ``G0hat`` (the site kernel, which the pencil form does not read)
    is on the first device.
    """
    devices = mesh.devices
    if len(devices) != n_dev:
        raise ValueError(f"a mesh of {len(devices)} devices for"
                         f" n_dev={n_dev}")
    nbins = fft_data.Ghat.shape[-1]
    cpad = _cpad(nbins - 1, n_dev)
    Ghat = F.pad(fft_data.Ghat, (0, cpad - nbins))
    w = cpad // n_dev
    shards = tuple(Ghat[..., j * w:(j + 1) * w].to(dev).contiguous()
                   for j, dev in enumerate(devices))
    return FFTScreeningData(Ghat=shards, G0hat=fft_data.G0hat.to(devices[0]))


def _block(x, bounds, i: int, axis: int, device) -> torch.Tensor:
    """Rows ``bounds[i]`` of ``x`` (a whole tensor with its rows on
    ``axis``, or row blocks of these bounds) on ``device``."""
    if isinstance(x, rowblocks.RowBlocks):
        if x.layout.bounds != bounds:
            raise ValueError("the current and the edge mask are split"
                             " into different row blocks")
        return x.blocks[i]
    a, b = bounds[i]
    return x.narrow(axis, a, b - a).to(device)


def make_sharded_fft_screening(mesh, Rp: int, Cp: int):
    """Build ``eval_fn(fft_data, sten, J_weighted) -> (3, Rp, Cp, 2)``
    computing the induced-potential convolution as per-device pencil FFTs
    (``fft_data`` must be the padded, sharded form from
    :func:`pad_fft_data_for_sharding`).

    ``J_weighted`` is one run's ``(Rp, Cp, 2)``: row blocks (the result
    is row blocks on the same layout, in its dtype) or a whole tensor
    (split into ``n`` equal blocks, one per device, as the JAX function's
    ``shard_map`` splits it). A leading member axis raises: sharded sweeps
    split members, not rows.

    Returns None when the grid cannot be pencil-decomposed over this mesh
    (``Rp`` not divisible by the device count, or a single device);
    callers fall back to the gathered evaluation.
    """
    devices = mesh.devices
    n_dev = len(devices)
    if n_dev <= 1 or Rp % n_dev != 0:
        return None
    cpad = _cpad(Cp, n_dev)
    nbins = Cp + 1
    w = cpad // n_dev
    even = rowblocks.RowLayout(
        tuple((i * Rp // n_dev, (i + 1) * Rp // n_dev)
              for i in range(n_dev)), devices)

    def eval_fn(fft_data: FFTScreeningData, sten, J_weighted):
        if tuple(J_weighted.shape) != (Rp, Cp, 2):
            raise ValueError(
                f"the pencil FFT screening takes one run's ({Rp}, {Cp}, 2)"
                f" current, not {tuple(J_weighted.shape)}")
        shards = fft_data.Ghat
        if len(shards) != n_dev or shards[0].shape[-1] != w:
            raise ValueError("fft_data is not padded and sharded for this"
                             " mesh: use pad_fft_data_for_sharding")
        layout = (J_weighted.layout
                  if isinstance(J_weighted, rowblocks.RowBlocks)
                  else even)
        bounds = layout.bounds
        rdtype = J_weighted.dtype
        # 1. columns: (2, r_i, Cp) per block -> (2, r_i, cpad) bins.
        F1 = []
        for i, dev in enumerate(layout.devices):
            blk = _block(J_weighted, bounds, i, -3, dev).movedim(-1, 0)
            spec = torch.fft.rfft(blk, n=2 * Cp, dim=-1)
            F1.append(F.pad(spec, (0, cpad - nbins)))
        # 2. transpose: pencil j holds bins [j w, (j + 1) w) of all rows.
        A2 = []
        for j, dev in enumerate(devices):
            pencil = torch.cat([f[..., j * w:(j + 1) * w].to(dev)
                                for f in F1], dim=-2)        # (2, Rp, w)
            # 3. rows: zero-extend to 2 Rp, fft, kernel product, ifft,
            #    keep the unaliased rows.
            F2 = torch.fft.fft(pencil, n=2 * Rp, dim=-2)
            # (3, 2, 2 Rp, w)
            prod = shards[j].unsqueeze(1) * F2.unsqueeze(0)
            A2.append(torch.fft.ifft(prod, dim=-2)[..., :Rp, :])
        # 4. transpose back, irfft along the columns, crop and mask.
        blocks = []
        for i, dev in enumerate(layout.devices):
            a, b = bounds[i]
            spec = torch.cat([p[..., a:b, :].to(dev) for p in A2], dim=-1)
            A = torch.fft.irfft(spec[..., :nbins], n=2 * Cp, dim=-1)
            A = A[..., :Cp].movedim(1, -1)           # (3, r_i, Cp, 2)
            ev = _block(sten.edge_valid, bounds, i, -2, dev)
            blocks.append((A * ev[..., None].to(A.dtype)).to(rdtype))
        return rowblocks.RowBlocks(blocks, -3, layout)

    return eval_fn
