"""Extract plottable site data from output files (the counterpart of
:mod:`tdgl_tpu.visualization.io`).

API parity with the reference ``tdgl/visualization/io.py:12-109``. The
JAX package's functions take an h5py ``File``; these take an
:mod:`~tdgl_tpu_torch.utils.h5lite` ``File`` or ``Group`` (either
package's output file, or the ``.h5.tmp`` side file of a running solve),
or a path, which is opened for the call.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Sequence, Tuple, Union

import numpy as np

from ..fv.mesh import Mesh
from ..solution.data import TDGLData, get_edge_quantity_data, load_state_data
from ..utils import h5lite
from .common import Quantity

H5Source = Union[str, os.PathLike, h5lite.Group]


@contextmanager
def open_h5(source: H5Source):
    """``source`` as an h5lite group: a path is opened read-only for the
    ``with`` block, a group is passed through."""
    if isinstance(source, h5lite.Group):
        yield source
        return
    with h5lite.File(source, "r") as f:
        yield f


def load_mesh(f: h5lite.Group) -> Mesh:
    """The mesh of an output file (``mesh/``), or of the side file (the
    device under ``solution/device``)."""
    from ..device.device import Device

    if "mesh" in f:
        return Mesh.from_hdf5(f["mesh"])
    return Device.from_hdf5(f["solution/device"]).mesh


def get_plot_data(
    h5file: H5Source, mesh: Mesh, quantity: Quantity, frame: int
) -> Tuple[np.ndarray, np.ndarray, Sequence[float]]:
    """Site values, site direction vectors, and color limits for a quantity
    at a saved frame."""
    with open_h5(h5file) as f:
        data = TDGLData.from_hdf5(f, frame)
    n = len(mesh.sites)
    zeros = np.zeros((n, 2))

    if quantity is Quantity.ORDER_PARAMETER and data.psi is not None:
        return np.abs(data.psi), zeros, [0, 1]
    if quantity is Quantity.PHASE and data.psi is not None:
        return np.angle(data.psi) / np.pi, zeros, [-1, 1]
    if quantity is Quantity.SUPERCURRENT and data.supercurrent is not None:
        return get_edge_quantity_data(data.supercurrent, mesh)
    if quantity is Quantity.NORMAL_CURRENT and data.normal_current is not None:
        return get_edge_quantity_data(data.normal_current, mesh)
    if quantity is Quantity.SCALAR_POTENTIAL and data.mu is not None:
        mu = data.mu - np.nanmin(data.mu)
        return mu, zeros, [float(mu.min()), float(mu.max())]
    if (quantity is Quantity.APPLIED_VECTOR_POTENTIAL
            and data.applied_vector_potential is not None):
        a_edge = (data.applied_vector_potential
                  * mesh.edge_mesh.directions).sum(axis=1)
        return get_edge_quantity_data(a_edge, mesh)
    if (quantity is Quantity.INDUCED_VECTOR_POTENTIAL
            and data.induced_vector_potential is not None):
        a_edge = (data.induced_vector_potential
                  * mesh.edge_mesh.directions).sum(axis=1)
        return get_edge_quantity_data(a_edge, mesh)
    if quantity is Quantity.EPSILON and data.epsilon is not None:
        eps = data.epsilon
        return eps, zeros, [float(eps.min()), float(eps.max())]
    if (quantity is Quantity.VORTICITY and data.supercurrent is not None
            and data.normal_current is not None):
        j_site = mesh.get_quantity_on_site(
            data.supercurrent
        ) + mesh.get_quantity_on_site(data.normal_current)
        em = mesh.edge_mesh
        e0, e1 = em.edges[:, 0], em.edges[:, 1]
        grad_jx = (j_site[e1, 0] - j_site[e0, 0]) / em.edge_lengths
        grad_jy = (j_site[e1, 1] - j_site[e0, 1]) / em.edge_lengths
        nd = em.normalized_directions
        vort_edges = grad_jy * nd[:, 0] - grad_jx * nd[:, 1]
        vorticity = mesh.get_quantity_on_site(vort_edges, vector=False)
        vmax = float(np.abs(vorticity).max())
        return vorticity, zeros, [-vmax, vmax]
    return np.zeros(n), zeros, [0, 0]


def get_state_string(h5file: H5Source, frame: int, max_frame: int) -> str:
    """A human-readable summary of a frame's solver state."""
    with open_h5(h5file) as f:
        state = load_state_data(f, frame)
    parts = [f"Frame {frame} of {max_frame}"]
    for i, (key, value) in enumerate(state.items(), start=1):
        if key == "timestamp":
            continue
        sep = ",\n" if i % 3 == 0 else ", "
        if isinstance(value, (float, np.floating)):
            parts.append(f"{sep}{key}: {value:.2e}")
        else:
            parts.append(f"{sep}{key}: {value}")
    return "".join(parts)
