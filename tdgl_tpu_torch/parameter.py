"""User-supplied physics inputs: position/time-dependent parameters.

API parity with the reference ``tdgl/parameter.py:66-439`` (``Parameter``,
``CompositeParameter``, ``Constant``): callables of ``(x, y[, z], *, t)`` with
signature validation, operator algebra, optional result caching for
time-dependent parameters, and pickle round-trips (by value with
cloudpickle where it is installed, by reference without it).

Traced path: a Parameter created with ``jittable=True`` promises that
``func`` takes torch tensors and returns tensors on the same device. The
solver then evaluates it *inside* the chunk, at every step, with ``t`` a 0-d
tensor on the solve's device (no host evaluation and no host read per
step), which is the fast path for time-dependent applied fields and
disorder.
"""

from __future__ import annotations

import hashlib
import inspect
import operator
import pickle
from numbers import Number
from typing import Callable, Optional, Union

import numpy as np
import torch

_OPERATOR_SYMBOLS = {
    operator.add: "+",
    operator.sub: "-",
    operator.mul: "*",
    operator.truediv: "/",
    operator.pow: "**",
}


def _describe(func: Callable) -> str:
    try:
        sig = inspect.signature(func)
        return f"{func.__name__}{sig}"
    except (TypeError, ValueError):
        return repr(func)


def _dump_callable(obj):
    """``obj`` as cloudpickle bytes where cloudpickle is installed (it
    pickles lambdas and closures by value); else ``obj`` itself, which the
    enclosing pickle stores by reference to its module."""
    try:
        import cloudpickle
    except ImportError:
        return obj
    return cloudpickle.dumps(obj)


def _load_callable(state):
    # A cloudpickle stream is a pickle stream; functions pickled by value
    # need cloudpickle installed to load.
    return pickle.loads(state) if isinstance(state, bytes) else state


class Parameter:
    """A callable computing a scalar or vector quantity as a function of
    position ``(x, y[, z])`` and optionally time ``t``.

    Args:
        func: The function to evaluate. Its first positional arguments must be
            ``x, y`` (and optionally ``z`` third); every other argument must be
            a keyword argument. Time-dependent parameters must accept ``t`` as
            a keyword-only argument.
        time_dependent: Declares that ``func`` depends on the keyword ``t``.
        jittable: Declares that ``func`` is jax-traceable, enabling in-jit
            evaluation by the solver (TPU fast path; not in the reference).
        kwargs: Fixed keyword arguments passed to ``func``.
    """

    def __init__(self, func: Callable, time_dependent: bool = False, **kwargs):
        self._use_cache = kwargs.pop("use_cache", None)
        self.jittable = bool(kwargs.pop("jittable", False))
        spec = inspect.getfullargspec(func)
        positional = spec.args
        if positional[:2] != ["x", "y"]:
            raise ValueError(
                "The first two positional arguments must be 'x' and 'y';"
                f" got signature {_describe(func)}"
            )
        num_positional = 2
        if "z" in positional:
            if positional.index("z") != 2:
                raise ValueError("'z' must be the third positional argument (x, y, z).")
            num_positional = 3
        defaults = spec.defaults or ()
        if len(defaults) != len(positional) - num_positional:
            raise ValueError(
                "All arguments other than x, y, z must have default values or be"
                f" keyword-only; got signature {_describe(func)}"
            )
        if time_dependent and "t" not in (spec.kwonlyargs or []):
            raise ValueError(
                "A time-dependent Parameter must accept time 't' as a"
                " keyword-only argument."
            )
        extra = set(kwargs) - set(positional[num_positional:])
        if not extra.issubset(set(spec.kwonlyargs or [])):
            raise ValueError(
                f"Keyword arguments {sorted(extra)} do not match the signature"
                f" of {_describe(func)}"
            )
        merged = dict(zip(positional[num_positional:], defaults))
        merged.update(spec.kwonlydefaults or {})
        merged.update(kwargs)
        self.func = func
        self.kwargs = merged
        self.time_dependent = time_dependent
        self._num_positional = num_positional
        self._cache: dict = {}

    # -- evaluation ----------------------------------------------------------
    def _cache_key(self, x, y, z, t) -> str:
        digest = hashlib.sha1()
        for arr in (x, y, z):
            if arr is not None:
                digest.update(np.ascontiguousarray(arr))
        kw_repr = repr(sorted(
            (k, v.tobytes() if isinstance(v, np.ndarray) else v)
            for k, v in self.kwargs.items()
        ))
        return digest.hexdigest() + kw_repr + repr(t)

    def _evaluate(self, x, y, z=None, t=None):
        kwargs = dict(self.kwargs)
        if t is not None:
            kwargs["t"] = t
        x, y = np.atleast_1d(x, y)
        if z is not None:
            kwargs["z"] = np.atleast_1d(z)
        result = np.asarray(self.func(x, y, **kwargs)).squeeze()
        if result.ndim == 0:
            result = result.item()
        return result

    def __call__(self, x, y, z=None, t: Optional[float] = None):
        if self._use_cache:
            key = self._cache_key(x, y, z, t)
            if key not in self._cache:
                self._cache[key] = self._evaluate(x, y, z, t)
            return self._cache[key]
        return self._evaluate(x, y, z, t)

    def _clear_cache(self) -> None:
        self._cache.clear()

    def evaluate_traced(self, x, y, z=None, t=None):
        """Evaluate without host-side array coercion, on the traced path.

        Only valid when ``jittable=True``: calls ``func`` directly with the
        given arguments and returns its raw result. In this package
        "jittable" means that ``func`` takes torch tensors (the solver
        passes the coordinates and ``t``, a 0-d tensor, on the solve's
        device) and returns tensors on the same device, without reading
        them back to the host.
        """
        kwargs = dict(self.kwargs)
        if self.time_dependent and t is not None:
            kwargs["t"] = t
        if self._num_positional == 3:
            return self.func(x, y, z, **kwargs)
        if z is not None:
            kwargs.setdefault("z", z)
            kwargs.pop("z", None)  # 2-arg funcs don't take z
        return self.func(x, y, **kwargs)

    # -- algebra -------------------------------------------------------------
    def __add__(self, other):
        return CompositeParameter(self, other, operator.add)

    def __radd__(self, other):
        return CompositeParameter(other, self, operator.add)

    def __sub__(self, other):
        return CompositeParameter(self, other, operator.sub)

    def __rsub__(self, other):
        return CompositeParameter(other, self, operator.sub)

    def __mul__(self, other):
        return CompositeParameter(self, other, operator.mul)

    def __rmul__(self, other):
        return CompositeParameter(other, self, operator.mul)

    def __truediv__(self, other):
        return CompositeParameter(self, other, operator.truediv)

    def __rtruediv__(self, other):
        return CompositeParameter(other, self, operator.truediv)

    def __pow__(self, other):
        return CompositeParameter(self, other, operator.pow)

    def __rpow__(self, other):
        return CompositeParameter(other, self, operator.pow)

    # -- identity ------------------------------------------------------------
    def fingerprint(self) -> str:
        """A stable, hashable token for value-based equality.

        Two Parameters wrapping functions with identical bytecode, constants,
        and keyword arguments fingerprint equally. Used to key compiled-step
        caches on *what the parameter computes* rather than on closure
        identity (cf. ``__eq__``).
        """
        digest = hashlib.sha1()
        code = self.func.__code__
        digest.update(code.co_code)
        digest.update(repr(code.co_consts).encode())
        for k in sorted(self.kwargs):
            v = self.kwargs[k]
            digest.update(k.encode())
            if isinstance(v, np.ndarray):
                digest.update(np.ascontiguousarray(v))
            else:
                digest.update(repr(v).encode())
        digest.update(
            f"td={self.time_dependent},jit={self.jittable}".encode()
        )
        return digest.hexdigest()

    def __eq__(self, other) -> bool:
        if other is self:
            return True
        if not isinstance(other, Parameter) or isinstance(other, CompositeParameter):
            return False
        if self.func.__code__ != other.func.__code__:
            return False
        if set(self.kwargs) != set(other.kwargs):
            return False
        for key, a in self.kwargs.items():
            b = other.kwargs[key]
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if np.shape(a) != np.shape(b) or not np.allclose(a, b):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self) -> str:
        kw = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        td = ", time_dependent=True" if self.time_dependent else ""
        return f"Parameter<{self.func.__name__}({kw}){td}>"

    # cloudpickle (where installed) handles the function; drop the cache on
    # pickling.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cache"] = {}
        state["func"] = _dump_callable(state["func"])
        return state

    def __setstate__(self, state):
        state["func"] = _load_callable(state["func"])
        self.__dict__.update(state)


class CompositeParameter(Parameter):
    """The result of arithmetic between Parameters and/or numbers.

    Evaluates its two operands and combines them with the given operator.
    """

    VALID_OPERATORS = _OPERATOR_SYMBOLS

    def __init__(self, left, right, operator_: Union[Callable, str]):
        allowed = (Number, Parameter)
        if not isinstance(left, allowed) or not isinstance(right, allowed):
            raise TypeError(
                "Operands must be numbers or Parameters;"
                f" got {type(left)!r} and {type(right)!r}"
            )
        if isinstance(left, Number) and isinstance(right, Number):
            raise TypeError("At least one operand must be a Parameter.")
        if isinstance(operator_, str):
            inverse = {v: k for k, v in _OPERATOR_SYMBOLS.items()}
            operator_ = inverse.get(operator_.strip())
        if operator_ not in _OPERATOR_SYMBOLS:
            raise ValueError(
                f"Unknown operator {operator_!r};"
                f" valid operators: {list(_OPERATOR_SYMBOLS.values())}"
            )
        self.left = left
        self.right = right
        self.operator = operator_
        self._num_positional = 3
        self._cache: dict = {}
        self._use_cache = None
        self.time_dependent = any(
            isinstance(p, Parameter) and p.time_dependent for p in (left, right)
        )
        self.jittable = all(
            (not isinstance(p, Parameter)) or p.jittable for p in (left, right)
        )
        # Enable caching on time-dependent leaves so repeated composite
        # evaluations at the same (positions, t) reuse work.
        for p in (left, right):
            if isinstance(p, Parameter) and p.time_dependent and p._use_cache is None:
                p._use_cache = True

    def _clear_cache(self) -> None:
        self._cache.clear()
        for p in (self.left, self.right):
            if isinstance(p, Parameter):
                p._clear_cache()

    def __call__(self, x, y, z=None, t: Optional[float] = None):
        values = []
        for operand in (self.left, self.right):
            if isinstance(operand, Parameter):
                if operand.time_dependent:
                    values.append(operand(x, y, z, t=t))
                else:
                    values.append(operand(x, y, z))
            else:
                values.append(operand)
        return self.operator(*values)

    def evaluate_traced(self, x, y, z=None, t=None):
        """Traced evaluation: combine operand results without host
        coercion (see :meth:`Parameter.evaluate_traced`).

        ``x``, ``y``, ``z`` are tensors and ``t`` a 0-d tensor. Only the
        time-dependent operands are called with them, at every call. A
        time-independent operand (``ConstantField`` is numpy code) is
        evaluated once, on the host, on numpy copies of the coordinates,
        and kept as a tensor on their device (the JAX package gets the same
        effect from XLA's constant folding).
        """
        values = []
        for operand in (self.left, self.right):
            if not isinstance(operand, Parameter):
                values.append(operand)
            elif operand.time_dependent:
                values.append(operand.evaluate_traced(x, y, z, t=t))
            else:
                values.append(self._static_value(operand, x, y, z))
        return self.operator(*values)

    def _static_value(self, operand, x, y, z):
        """``operand``'s traced value on the coordinates ``(x, y, z)``
        (tensors), computed on the host once per coordinate set."""
        if not hasattr(self, "_traced_cache"):
            self._traced_cache = {}
        key = (id(operand), id(x), id(y), id(z))
        hit = self._traced_cache.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], (x, y, z))):
            return hit[1]

        def host(v):
            return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else v)

        value = operand.evaluate_traced(host(x), host(y), host(z))
        device = x.device if isinstance(x, torch.Tensor) else None
        value = torch.as_tensor(np.asarray(value), device=device)
        # The coordinates are kept with the value, so their ids stay theirs.
        self._traced_cache[key] = ((x, y, z), value)
        return value

    def fingerprint(self) -> str:
        """Stable hashable token (see :meth:`Parameter.fingerprint`)."""
        parts = []
        for operand in (self.left, self.right):
            if isinstance(operand, Parameter):
                parts.append(operand.fingerprint())
            else:
                parts.append(repr(operand))
        op_name = getattr(self.operator, "__name__", repr(self.operator))
        return hashlib.sha1(
            ("composite:" + op_name + ":" + ":".join(parts)).encode()
        ).hexdigest()

    def __eq__(self, other) -> bool:
        if other is self:
            return True
        if not isinstance(other, CompositeParameter):
            return False
        return (
            self.left == other.left
            and self.right == other.right
            and self.operator is other.operator
        )

    def __repr__(self) -> str:
        return (
            f"CompositeParameter<{self.left!r} "
            f"{_OPERATOR_SYMBOLS[self.operator]} {self.right!r}>"
        )

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cache"] = {}
        state.pop("_traced_cache", None)
        state["left"] = _dump_callable(state["left"])
        state["right"] = _dump_callable(state["right"])
        return state

    def __setstate__(self, state):
        state["left"] = _load_callable(state["left"])
        state["right"] = _load_callable(state["right"])
        self.__dict__.update(state)


class Constant(Parameter):
    """A Parameter whose value is independent of position and time."""

    def __init__(self, value: Number, dimensions: int = 2):
        if dimensions == 2:
            def constant(x, y, value=0):
                return value * np.ones_like(x)
        elif dimensions == 3:
            def constant(x, y, z, value=0):
                return value * np.ones_like(x)
        else:
            raise ValueError(f"dimensions must be 2 or 3, got {dimensions}")
        super().__init__(constant, value=value)
