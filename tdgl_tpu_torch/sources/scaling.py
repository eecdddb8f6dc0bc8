"""Time-ramp and scale-factor sources (reference ``tdgl/sources/scaling.py``).

Copy of :mod:`tdgl_tpu.sources.scaling`; the ramp clamps a torch tensor
``t`` (the traced path, :meth:`tdgl_tpu_torch.Parameter.evaluate_traced`)
with ``torch.clamp``, on the tensor's own device.
"""

from __future__ import annotations

import torch

from ..parameter import Parameter


def linear_ramp(x, y, z, *, t, tmin, tmax, initial: float = 0.0,
                final: float = 1.0):
    """Linearly interpolate from ``initial`` to ``final`` over [tmin, tmax],
    clamped outside the interval.

    Works for host numbers and for a tensor ``t`` (then the result is a
    tensor on ``t``'s device, and nothing is read back to the host), so a
    LinearRamp-scaled field can run on the traced path."""
    frac = (t - tmin) / (tmax - tmin)
    if isinstance(frac, torch.Tensor):
        frac = torch.clamp(frac, 0.0, 1.0)
    else:
        frac = min(max(frac, 0.0), 1.0)
    return initial + (final - initial) * frac


def LinearRamp(*, tmin: float, tmax: float, initial: float = 0.0,
               final: float = 1.0) -> Parameter:
    """A time-dependent :class:`Parameter` ramping linearly from ``initial``
    to ``final`` between ``tmin`` and ``tmax``. Jittable: it runs on the
    traced path when composed with jittable Parameters."""
    if not tmax > tmin:
        raise ValueError(f"LinearRamp requires tmax > tmin (got tmin={tmin},"
                         f" tmax={tmax}).")
    return Parameter(
        linear_ramp,
        tmin=tmin,
        tmax=tmax,
        initial=initial,
        final=final,
        time_dependent=True,
        jittable=True,
    )


def Scale(func, **kwargs) -> Parameter:
    """Wrap an arbitrary time-dependent scale function
    ``func(x, y, z, *, t, **kwargs)`` as a :class:`Parameter`."""
    kwargs["time_dependent"] = True
    return Parameter(func, **kwargs)
