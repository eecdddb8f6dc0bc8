"""Fixtures for checking the step kernels; not used by the solver.

Imported by the tests and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

from .device.hexmesh import EDGE_OFFSETS


def periodic_stencil(sten, seed: int):
    """``sten`` (host arrays) with every edge live, wrapped ones included.

    Random positive ``w``, ``dual``, ``inv_len`` and ``inv_area`` on every
    site and edge, ``valid = 1`` and ``fixed_mask = 0``; ``w_m`` and
    ``sym_diag`` follow from ``w`` as in ``build_stencil_operators``. On
    such a stencil the kernels' halo wrap is visible in the result (on a
    real one zero weights hide it), so it checks that edge tiles read the
    values ``torch.roll`` gives. Works on either package's
    ``StencilOperators``.
    """
    rng = np.random.default_rng(seed)
    valid = np.asarray(sten.valid)
    shape, dtype = valid.shape, valid.dtype

    def positive(*lead):
        return rng.uniform(0.5, 1.5, lead + shape).astype(dtype)

    w = positive(3)
    w_m = np.stack([np.roll(w[k], off, axis=(0, 1))
                    for k, off in enumerate(EDGE_OFFSETS)])
    inv_area = positive()
    return sten._replace(
        valid=np.ones(shape, dtype), edge_valid=np.ones((3,) + shape, dtype),
        w=w, w_m=w_m, dual=positive(3), inv_len=positive(3),
        sym_diag=(w + w_m).sum(axis=0).astype(dtype),
        area=(1.0 / inv_area).astype(dtype), inv_area=inv_area,
        fixed_mask=np.zeros(shape, dtype),
    )
