"""A minimal, self-contained physical-units engine.

The reference framework (py-tdgl) relies on ``pint`` for unit handling
(see reference ``tdgl/em.py:11`` for the registry and ``tdgl/device/device.py:120-207``
for the derived scales). ``pint`` is not available in this environment, so this module
provides a small, fast replacement covering the electromagnetic unit algebra the
framework needs: SI prefixes, derived EM units, the physical constants ``mu_0`` and
``Phi_0``, quantity arithmetic, and unit conversion.

Dimensions are tracked as integer exponents over the SI base vector
``(length, mass, time, current)``.
"""

from __future__ import annotations

import re
from numbers import Number
from typing import Tuple, Union

import numpy as np

Dims = Tuple[int, int, int, int]

_ZERO: Dims = (0, 0, 0, 0)

# name -> (scale to SI, dims (L, M, T, I))
_BASE_UNITS = {
    # base
    "m": (1.0, (1, 0, 0, 0)),
    "meter": (1.0, (1, 0, 0, 0)),
    "g": (1e-3, (0, 1, 0, 0)),
    "gram": (1e-3, (0, 1, 0, 0)),
    "s": (1.0, (0, 0, 1, 0)),
    "sec": (1.0, (0, 0, 1, 0)),
    "second": (1.0, (0, 0, 1, 0)),
    "seconds": (1.0, (0, 0, 1, 0)),
    "volts": (1.0, (2, 1, -3, -1)),
    "amperes": (1.0, (0, 0, 0, 1)),
    "meters": (1.0, (1, 0, 0, 0)),
    "A": (1.0, (0, 0, 0, 1)),
    "amp": (1.0, (0, 0, 0, 1)),
    "ampere": (1.0, (0, 0, 0, 1)),
    # derived mechanical
    "Hz": (1.0, (0, 0, -1, 0)),
    "N": (1.0, (1, 1, -2, 0)),
    "J": (1.0, (2, 1, -2, 0)),
    "joule": (1.0, (2, 1, -2, 0)),
    "W": (1.0, (2, 1, -3, 0)),
    "watt": (1.0, (2, 1, -3, 0)),
    # derived electromagnetic
    "C": (1.0, (0, 0, 1, 1)),
    "coulomb": (1.0, (0, 0, 1, 1)),
    "V": (1.0, (2, 1, -3, -1)),
    "volt": (1.0, (2, 1, -3, -1)),
    "ohm": (1.0, (2, 1, -3, -2)),
    "S": (1.0, (-2, -1, 3, 2)),
    "siemens": (1.0, (-2, -1, 3, 2)),
    "T": (1.0, (0, 1, -2, -1)),
    "tesla": (1.0, (0, 1, -2, -1)),
    "G": (1e-4, (0, 1, -2, -1)),
    "gauss": (1e-4, (0, 1, -2, -1)),
    # H-field unit: 1 Oe = 1000/(4 pi) A/m
    "Oe": (1000.0 / (4 * np.pi), (-1, 0, 0, 1)),
    "oersted": (1000.0 / (4 * np.pi), (-1, 0, 0, 1)),
    "Wb": (1.0, (2, 1, -2, -1)),
    "weber": (1.0, (2, 1, -2, -1)),
    "H": (1.0, (2, 1, -2, -2)),
    "henry": (1.0, (2, 1, -2, -2)),
    "F": (1.0, (-2, -1, 4, 2)),
    "farad": (1.0, (-2, -1, 4, 2)),
    # constants usable as units, like pint's registry
    # mu_0: vacuum permeability [H/m]; Phi_0 = h / 2e: flux quantum [Wb]
    "mu_0": (1.25663706212e-06, (1, 1, -2, -2)),
    "Phi_0": (2.067833848e-15, (2, 1, -2, -1)),
    "h": (6.62607015e-34, (2, 1, -1, 0)),  # Planck constant [J s]
    "e": (1.602176634e-19, (0, 0, 1, 1)),  # elementary charge [C]
    # dimensionless helpers
    "dimensionless": (1.0, _ZERO),
    "rad": (1.0, _ZERO),
    "pi": (np.pi, _ZERO),
}

_PREFIXES = {
    "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15, "p": 1e-12, "n": 1e-9,
    "u": 1e-6, "µ": 1e-6, "m": 1e-3, "c": 1e-2, "d": 1e-1, "da": 1e1,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
}

# Units that accept SI prefixes (constants and non-SI oddities do not).
_PREFIXABLE = {
    "m", "meter", "g", "gram", "s", "sec", "second", "A", "amp", "ampere",
    "Hz", "N", "J", "W", "C", "V", "volt", "ohm", "S", "siemens", "T",
    "tesla", "G", "gauss", "Wb", "H", "henry", "F", "farad",
}


class DimensionalityError(ValueError):
    """Raised when an operation mixes incompatible dimensions."""


def _resolve_symbol(symbol: str) -> Tuple[float, Dims]:
    """Resolve a bare unit symbol (no exponent) to (scale, dims)."""
    if symbol in _BASE_UNITS:
        return _BASE_UNITS[symbol]
    # try prefix + unit, preferring the longest matching base unit
    for plen in (2, 1):
        prefix, rest = symbol[:plen], symbol[plen:]
        if prefix in _PREFIXES and rest in _BASE_UNITS and rest in _PREFIXABLE:
            scale, dims = _BASE_UNITS[rest]
            return _PREFIXES[prefix] * scale, dims
    raise ValueError(f"Unknown unit: {symbol!r}")


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<pow>\*\*|\^)|(?P<op>[*/])|(?P<num>[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?)"
    r"|(?P<sym>[A-Za-zµ_][A-Za-z0-9µ_]*))"
)


def parse_units(text: str) -> Tuple[float, Dims]:
    """Parse a unit expression like ``"uA / um"``, ``"mT"``, ``"A * um**2"``,
    or ``"1 / um"`` into ``(scale_to_SI, dims)``."""
    text = text.strip()
    if not text:
        return 1.0, _ZERO
    pos = 0
    scale = 1.0
    dims = [0, 0, 0, 0]
    pending_op = "*"
    last_factor: Union[Tuple[float, Dims], None] = None

    def apply(factor_scale: float, factor_dims: Dims, op: str, exponent: float = 1.0):
        nonlocal scale
        sign = 1.0 if op == "*" else -1.0
        scale *= factor_scale ** (sign * exponent)
        for i in range(4):
            dims[i] += int(round(sign * exponent * factor_dims[i]))

    tokens = []
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"Cannot parse units: {text!r} at position {pos}")
        pos = m.end()
        tokens.append(m)

    i = 0
    while i < len(tokens):
        m = tokens[i]
        if m.group("op"):
            pending_op = m.group("op")
        elif m.group("pow"):
            # exponent applies to the last factor
            i += 1
            if i >= len(tokens) or not tokens[i].group("num"):
                raise ValueError(f"Expected exponent in {text!r}")
            exp = float(tokens[i].group("num"))
            if last_factor is None:
                raise ValueError(f"Dangling exponent in {text!r}")
            fs, fd = last_factor
            # the factor was already applied once with exponent 1; apply the rest
            apply(fs, fd, pending_op_last, exp - 1.0)
        elif m.group("num"):
            val = float(m.group("num"))
            apply(val, _ZERO, pending_op)
            last_factor = (val, _ZERO)
            pending_op_last = pending_op
        else:
            sym = m.group("sym")
            fs, fd = _resolve_symbol(sym)
            apply(fs, fd, pending_op)
            last_factor = (fs, fd)
            pending_op_last = pending_op
        i += 1
    return scale, tuple(dims)  # type: ignore[return-value]


_SI_NAMES = ("m", "kg", "s", "A")


def format_dims(dims: Dims) -> str:
    """Render dims as an SI unit string, e.g. ``"kg / s ** 2 / A"``."""
    num, den = [], []
    for name, exp in zip(_SI_NAMES, dims):
        if exp > 0:
            num.append(name if exp == 1 else f"{name} ** {exp}")
        elif exp < 0:
            den.append(name if exp == -1 else f"{name} ** {-exp}")
    out = " * ".join(num) if num else ""
    for d in den:
        out += f" / {d}" if out else f"1 / {d}"
    return out or "dimensionless"


class Quantity:
    """A number (or numpy array) with units.

    Mirrors the subset of ``pint.Quantity`` behavior that the framework uses:
    arithmetic, ``.to()``, ``.to_base_units()``, ``.magnitude``, ``.units``,
    ``.dimensionless``.
    """

    __slots__ = ("_mag", "_scale", "_dims", "_units")

    def __init__(self, magnitude, scale: float = 1.0, dims: Dims = _ZERO,
                 units: str = ""):
        self._mag = magnitude
        self._scale = float(scale)
        self._dims = tuple(dims)
        self._units = units or (format_dims(self._dims) if scale == 1.0 else "")

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_units(cls, magnitude, units: str) -> "Quantity":
        scale, dims = parse_units(units)
        return cls(magnitude, scale, dims, units)

    # -- accessors ----------------------------------------------------------
    @property
    def magnitude(self):
        return self._mag

    m = magnitude

    @property
    def units(self) -> str:
        return self._units

    @property
    def dims(self) -> Dims:
        return self._dims

    @property
    def dimensionless(self) -> bool:
        return self._dims == _ZERO

    # -- conversion ---------------------------------------------------------
    def to(self, target: Union[str, "Quantity"]) -> "Quantity":
        if isinstance(target, Quantity):
            t_scale = target._scale
            t_dims = target._dims
            t_units = target._units
            if np.ndim(target._mag) == 0:
                t_scale = t_scale * float(target._mag)
        else:
            t_scale, t_dims = parse_units(target)
            t_units = target
        if t_dims != self._dims:
            raise DimensionalityError(
                f"Cannot convert {format_dims(self._dims)} to {format_dims(t_dims)}"
            )
        return Quantity(self._mag * (self._scale / t_scale), t_scale, t_dims, t_units)

    def to_base_units(self) -> "Quantity":
        return Quantity(self._mag * self._scale, 1.0, self._dims,
                        format_dims(self._dims))

    # -- arithmetic ---------------------------------------------------------
    @staticmethod
    def _coerce(other) -> "Quantity":
        if isinstance(other, Quantity):
            return other
        return Quantity(other)

    def __mul__(self, other):
        o = self._coerce(other)
        dims = tuple(a + b for a, b in zip(self._dims, o._dims))
        units = _join_units(self._units, o._units, "*")
        return Quantity(self._mag * o._mag, self._scale * o._scale, dims, units)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        dims = tuple(a - b for a, b in zip(self._dims, o._dims))
        units = _join_units(self._units, o._units, "/")
        return Quantity(self._mag / o._mag, self._scale / o._scale, dims, units)

    def __rtruediv__(self, other):
        o = self._coerce(other)
        return o.__truediv__(self)

    def __pow__(self, exp):
        if not isinstance(exp, Number):
            return NotImplemented
        dims = tuple(int(round(d * exp)) for d in self._dims)
        units = f"({self._units}) ** {exp}" if self._units else ""
        return Quantity(self._mag ** exp, self._scale ** exp, dims, units)

    def _add_sub(self, other, sign):
        # pint compatibility: adding/subtracting a bare scalar zero is
        # dimensionally neutral, so ``sum(fluxoid)`` works (the reference's
        # own idiom, ``tdgl/test/test_solve.py:180``; ``sum`` starts at 0).
        if isinstance(other, Number) and other == 0:
            return Quantity(self._mag + 0.0, self._scale, self._dims,
                            self._units)
        o = self._coerce(other)
        if o._dims != self._dims:
            raise DimensionalityError(
                f"Cannot add {format_dims(self._dims)} and {format_dims(o._dims)}"
            )
        other_in_self = o._mag * (o._scale / self._scale)
        return Quantity(self._mag + sign * other_in_self, self._scale, self._dims,
                        self._units)

    def __add__(self, other):
        return self._add_sub(other, +1.0)

    __radd__ = __add__

    def __sub__(self, other):
        return self._add_sub(other, -1.0)

    def __rsub__(self, other):
        return self._coerce(other)._add_sub(self, -1.0)

    def __neg__(self):
        return Quantity(-self._mag, self._scale, self._dims, self._units)

    def __abs__(self):
        return Quantity(abs(self._mag), self._scale, self._dims, self._units)

    def __float__(self):
        if not self.dimensionless:
            raise DimensionalityError(
                f"Cannot convert quantity with units {format_dims(self._dims)}"
                " to float"
            )
        return float(self._mag * self._scale)

    def _cmp_value(self, other):
        o = self._coerce(other)
        if o._dims != self._dims:
            raise DimensionalityError("Cannot compare quantities of different dims")
        return np.asarray(self._mag) * self._scale, np.asarray(o._mag) * o._scale

    def __eq__(self, other):
        try:
            a, b = self._cmp_value(other)
        except DimensionalityError:
            return False
        return bool(np.all(a == b))

    def __lt__(self, other):
        a, b = self._cmp_value(other)
        return bool(np.all(a < b))

    def __gt__(self, other):
        a, b = self._cmp_value(other)
        return bool(np.all(a > b))

    def __le__(self, other):
        a, b = self._cmp_value(other)
        return bool(np.all(a <= b))

    def __ge__(self, other):
        a, b = self._cmp_value(other)
        return bool(np.all(a >= b))

    def __hash__(self):
        return hash((np.ndim(self._mag) == 0 and float(self._mag), self._scale,
                     self._dims))

    def __repr__(self):
        return f"{self._mag} {self._units or format_dims(self._dims)}"

    __str__ = __repr__


def _join_units(a: str, b: str, op: str) -> str:
    a = a or "dimensionless"
    b = b or "dimensionless"
    if a == "dimensionless" and op == "*":
        return b
    if b == "dimensionless":
        return a
    return f"({a}) {op} ({b})" if op == "/" else f"{a} {op} {b}"


class UnitRegistry:
    """Callable registry mirroring ``pint.UnitRegistry``: ``ureg("mT")`` returns
    a :class:`Quantity` of magnitude 1 in the given units."""

    def __call__(self, units: str) -> Quantity:
        return Quantity.from_units(1.0, units)

    def Quantity(self, magnitude, units: str = "") -> Quantity:
        if units:
            return Quantity.from_units(magnitude, units)
        return Quantity(magnitude)


#: The global unit registry, analogous to the reference's ``tdgl.em.ureg``.
ureg = UnitRegistry()
