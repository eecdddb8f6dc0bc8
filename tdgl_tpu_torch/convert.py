"""Host arrays -> tensors on a chosen ``torch.device``.

The solver uses these helpers to move its host-built tables (numpy) onto
the device. They take plain numpy arrays, or anything ``np.asarray``
accepts, so the same helpers also move the JAX package's arrays into this
package: ``tdgl_tpu``'s ``StencilOperators``, ``HexMGData``, ``GridState``
(or its ``export_grid_state_arrays`` dict), ``LinkPhases`` and
``FactoredLinkPhases`` convert field by field, which is how the tests feed
both packages the same state. The screening data converts too: either
package's ``FFTScreeningData`` (the JAX package's split real/imaginary
spectra become complex tensors) and the site-evaluation taps.

Every array keeps its dtype, except that :func:`hexmg_to_torch` recasts
the multigrid levels to the working dtype.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from .fv.stencil_operators import StencilOperators
from .models.gtdgl_stencil import FactoredLinkPhases, LinkPhases
from .ops.fft_screening import FFTScreeningData
from .ops.hexmg import HexMGData
from .solver.grid_step import GridState

DeviceLike = Union[str, torch.device]


def to_tensor(a, device: DeviceLike,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array (copied) -> a contiguous tensor on ``device``."""
    arr = np.asarray(a)
    t = torch.tensor(arr)
    if dtype is not None and arr.dtype.kind == "f":
        t = t.to(dtype)
    return t.to(device)


def stencil_to_torch(sten, device: DeviceLike) -> StencilOperators:
    """:class:`StencilOperators` (either package's) -> tensors."""
    return StencilOperators(*(to_tensor(getattr(sten, f), device)
                              for f in StencilOperators._fields))


def hexmg_to_torch(mg, device: DeviceLike,
                   dtype: Optional[torch.dtype] = None) -> HexMGData:
    """A ``HexMGData`` hierarchy (either package's) -> tensors.

    Only the arrays the V-cycle reads travel (``W``, ``inv_diag``,
    ``Ainv``; the JAX package's TPU transfer matrices ``PR``/``PC`` are
    dropped). ``dtype`` pre-casts the float32-stored levels to the working
    dtype, which is what every apply would do anyway.
    """
    keep = ("W", "inv_diag", "Ainv")
    levels = [{k: to_tensor(v, device, dtype) for k, v in lev.items()
               if k in keep} for lev in mg.level_arrays]
    return HexMGData(levels, tuple(mg.offsets), tuple(mg.shapes),
                     p_omega=tuple(mg.p_omega))


def link_phases_to_torch(U, device: DeviceLike):
    """``LinkPhases`` or ``FactoredLinkPhases`` (either package's) ->
    tensors, chosen by field names."""
    cls = (FactoredLinkPhases if hasattr(U, "cf") else LinkPhases)
    return cls(*(to_tensor(getattr(U, f), device) for f in cls._fields))


def fft_screening_to_torch(fd, device: DeviceLike) -> FFTScreeningData:
    """An ``FFTScreeningData`` (this package's complex spectra, or the JAX
    package's ``Ghat_re``/``Ghat_im``/``G0hat_re``/``G0hat_im``) ->
    complex tensors; the JAX package's DFT matrices are dropped."""
    def spectrum(name):
        if hasattr(fd, name + "_re"):
            re = np.asarray(getattr(fd, name + "_re"))
            out = np.empty(re.shape, np.result_type(re.dtype, np.complex64))
            out.real = re
            out.imag = np.asarray(getattr(fd, name + "_im"))
            return to_tensor(out, device)
        return to_tensor(getattr(fd, name), device)

    return FFTScreeningData(Ghat=spectrum("Ghat"), G0hat=spectrum("G0hat"))


def site_taps(taps):
    """Site-evaluation taps (from either package's
    ``build_site_interp_taps``) as a tuple of ``((dr, dc), value)`` with
    Python ints and floats, or None."""
    if taps is None:
        return None
    return tuple(tuple(((int(a), int(b)), float(v)) for (a, b), v in cls)
                 for cls in taps)


_EXPORT_TO_STATE = dict(
    psi_real="psi_r", psi_imag="psi_i", mu="mu",
    supercurrent="supercurrent", normal_current="normal_current",
    induced_vector_potential="A_induced",
    applied_vector_potential="A_applied", epsilon="epsilon",
)


def grid_state_to_torch(state, device: DeviceLike,
                        template: Optional[GridState] = None) -> GridState:
    """A ``GridState`` (either package's) -> tensors.

    ``state`` may also be the mapping of ``export_grid_state_arrays``; the
    fields an export does not hold (``mu_prev``, ``neumann_term``,
    ``dA_dt``, the adaptive-dt window, ``end_time``, ...) are then taken
    from ``template``, and the scalars from its ``diagnostics``
    (``done``/``failed`` included).
    """
    if not isinstance(state, Mapping):
        return GridState(*(to_tensor(getattr(state, f), device)
                           for f in GridState._fields))
    if template is None:
        raise ValueError("converting an exported state needs a template"
                         " GridState for the fields it does not hold")
    fields = {dst: to_tensor(state[src], device)
              for src, dst in _EXPORT_TO_STATE.items()}
    diag = np.asarray(state["diagnostics"], dtype=np.float64)
    rd = template.time.dtype

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    fields.update(
        time=scalar(diag[0], rd), prev_dt=scalar(diag[1], rd),
        tentative_dt=scalar(diag[2], rd),
        step=scalar(int(diag[3]), torch.int32),
        done=scalar(bool(diag[4]), torch.bool),
        failed=scalar(bool(diag[5]), torch.bool),
    )
    return template._replace(**fields)
