"""Unpickling of stored callables without the JAX package.

Output files keep callables (the applied vector potential, terminal
currents, disorder) as pickles. A file that ``tdgl_tpu`` wrote names
``tdgl_tpu`` modules in them; :func:`loads` resolves every such name in the
port's module of the same name (``tdgl_tpu.parameter`` ->
``tdgl_tpu_torch.parameter``), also where a cloudpickle stream re-imports a
module of a function's globals, so the JAX package is never imported.
"""

from __future__ import annotations

import io
import pickle


def port_module(module: str) -> str:
    """The name of the port's module for a ``tdgl_tpu`` module name."""
    if module == "tdgl_tpu" or module.startswith("tdgl_tpu."):
        return "tdgl_tpu_torch" + module[len("tdgl_tpu"):]
    return module


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        obj = super().find_class(port_module(module), name)
        if module.startswith("cloudpickle") and name == "subimport":
            return lambda modname: obj(port_module(modname))
        return obj


def loads(raw: bytes):
    """``pickle.loads(raw)`` with ``tdgl_tpu`` names resolved in
    ``tdgl_tpu_torch``. A name the port lacks raises ``AttributeError``;
    a cloudpickle stream needs cloudpickle installed."""
    return _PortUnpickler(io.BytesIO(raw)).load()
