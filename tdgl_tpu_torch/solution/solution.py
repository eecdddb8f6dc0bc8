"""Solution: loading, post-processing, and analysis of TDGL results.

Port of :mod:`tdgl_tpu.solution.solution` on
:mod:`tdgl_tpu_torch.utils.h5lite`. API and HDF5-schema parity with the
reference ``tdgl/solution/solution.py:59-1090``: current densities on
sites (in K0-convention units), vorticity, interpolation, fluxoids,
boundary phases, Biot-Savart fields, magnetic moment, and full save/load
round trips with pickled callables.

Callables (the applied vector potential, terminal currents and disorder)
are stored as attributes where HDF5 can hold them, else pickled: with
cloudpickle where it is installed, else with the standard library's
pickle, which stores functions and classes by reference to their module.
A port :class:`~tdgl_tpu_torch.sources.ConstantField` therefore refers to
``tdgl_tpu_torch.parameter`` and ``tdgl_tpu_torch.sources.constant``, and
``tdgl_tpu.Solution.from_hdf5`` loads it wherever ``tdgl_tpu_torch``
imports. A file that ``tdgl_tpu`` wrote loads without the JAX package:
its pickles name ``tdgl_tpu`` modules, which load as the port's modules of
the same name, and a pickle that needs what this machine lacks (cloudpickle
for a function stored by value, or a name the port does not have) leaves
an attribute that raises on access, while the fields, the dynamics and the
device load. Linear interpolation runs on the mesh without matplotlib
(:mod:`.tri_interp`); cubic interpolation and the ``plot_*`` methods
(:mod:`.plot_solution`) need matplotlib, imported when they are called.
"""

from __future__ import annotations

import dataclasses
import numbers
import operator
import os
import pickle
import shutil
from contextlib import nullcontext
from datetime import datetime
from typing import Any, Callable, Dict, Literal, NamedTuple, Optional, Tuple, Union

import numpy as np

from ..about import version_dict
from ..device.device import Device
from ..device.polygon import Polygon
from ..em import biot_savart_2d, convert_field
from ..fluxoid import Fluxoid
from ..geometry import path_vectors
from ..parameter import Parameter
from ..solver.options import SolverOptions
from ..utils import h5lite, pickles
from ..utils.units import Quantity, ureg
from .data import (DynamicsData, TDGLData, get_data_range,
                   get_edge_quantity_data)
from .tri_interp import LinearTriInterpolator


def dumps(obj) -> bytes:
    """Pickle ``obj`` with cloudpickle where it is installed, else with
    the standard library."""
    try:
        import cloudpickle
    except ImportError:
        return pickle.dumps(obj)
    return cloudpickle.dumps(obj)


def check_picklable(**objects) -> None:
    """Raise ``ValueError`` naming the first argument that cannot be
    stored (an HDF5 attribute or a pickle), so a run cannot fail at its
    last line."""
    for name, obj in objects.items():
        try:
            h5lite.check_attribute(obj)
            continue
        except TypeError:
            pass
        try:
            dumps(obj)
        except Exception as exc:
            raise ValueError(
                f"{name} cannot be saved with the solution: {exc!r}. Pass a"
                " module-level function or a Parameter of one, or install"
                " cloudpickle."
            ) from exc


class _Unloaded:
    """A stored callable that could not be unpickled on this machine."""

    def __init__(self, name: str, exc: Exception):
        self.name = name
        self.exc = exc

    def error(self) -> RuntimeError:
        return RuntimeError(
            f"The solution's {self.name} could not be loaded here"
            f" ({self.exc!r}): its pickle needs cloudpickle or a name that"
            " tdgl_tpu_torch lacks."
        )


def loads(raw: bytes, name: str):
    """Unpickle the stored callable ``name`` with
    :func:`tdgl_tpu_torch.utils.pickles.loads`; where that fails, an
    :class:`_Unloaded` marker that raises when the attribute is read."""
    try:
        return pickles.loads(raw)
    except Exception as exc:
        return _Unloaded(name, exc)


class _StoredCallable:
    """A callable stored with the solution: reading one that could not be
    loaded raises its error."""

    def __set_name__(self, owner, name):
        self.key = "_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        value = obj.__dict__[self.key]
        if isinstance(value, _Unloaded):
            raise value.error()
        return value

    def __set__(self, obj, value):
        obj.__dict__[self.key] = value


class BiotSavartField(NamedTuple):
    """Fields from the supercurrent and normal current, separately."""

    supercurrent: Any
    normal_current: Any


class BoundaryPhases(NamedTuple):
    """Site indices and unwrapped order-parameter phases along a boundary."""

    indices: np.ndarray
    phases: np.ndarray


class Solution:
    """The results of a TDGL simulation.

    Args:
        device: The solved :class:`Device`.
        options: The :class:`SolverOptions` used.
        path: Path to the HDF5 output file.
        applied_vector_potential: The applied vector potential
            Parameter/callable.
        terminal_currents: The terminal currents dict or callable.
        disorder_epsilon: The disorder parameter (float or callable).
        total_seconds: Wall time of the solve.
    """

    applied_vector_potential = _StoredCallable()
    terminal_currents = _StoredCallable()
    disorder_epsilon = _StoredCallable()

    def __init__(
        self,
        *,
        device: Device,
        options: SolverOptions,
        path: str,
        applied_vector_potential,
        terminal_currents,
        disorder_epsilon,
        total_seconds: float,
        _solve_step: int = -1,
    ):
        self.device = device.copy()
        self.device.mesh = device.mesh
        self.options = options
        self.path = path
        self.applied_vector_potential = applied_vector_potential
        self.terminal_currents = terminal_currents
        self.disorder_epsilon = disorder_epsilon
        self.data_range: Optional[Tuple[int, int]] = None
        self.supercurrent_density: Optional[Quantity] = None
        self.normal_current_density: Optional[Quantity] = None
        self._vorticity: Optional[Quantity] = None
        self._linear: Optional[LinearTriInterpolator] = None
        self._field_units = str(options.field_units)
        self._current_units = str(options.current_units)
        self._time_created = datetime.now()
        self.total_seconds = total_seconds
        self.tdgl_data: Optional[TDGLData] = None
        self.dynamics: Optional[DynamicsData] = None
        self._solve_step = _solve_step
        self.load_tdgl_data(self._solve_step)
        self._version_info = version_dict()

    # -- basic properties -----------------------------------------------------
    @property
    def saved_on_disk(self) -> bool:
        """Whether the backing HDF5 file exists."""
        return os.path.exists(self.path)

    @property
    def solve_step(self) -> int:
        """The currently loaded saved step (setting it reloads data)."""
        return self._solve_step

    @solve_step.setter
    def solve_step(self, step: int) -> None:
        self.load_tdgl_data(solve_step=step)

    @property
    def field_units(self) -> str:
        """Units of magnetic fields."""
        return self._field_units

    @property
    def current_units(self) -> str:
        """Units of currents."""
        return self._current_units

    @property
    def time_created(self) -> datetime:
        """Timestamp of solution creation."""
        return self._time_created

    @property
    def version_info(self) -> Dict[str, str]:
        """Dependency versions recorded at creation time."""
        return self._version_info

    @property
    def times(self) -> Optional[np.ndarray]:
        """Simulation time of each saved step."""
        if self.dynamics is None:
            return None
        times = self.dynamics.time
        saved = times[:: self.options.save_every]
        if len(times) and saved[-1] != times[-1]:
            saved = np.concatenate([saved, times[-1:]])
        return saved.copy()

    def closest_solve_step(self, time: float) -> int:
        """Index of the saved step closest in time to ``time``."""
        return int(np.argmin(np.abs(self.times - time)))

    # -- data loading -----------------------------------------------------------
    def load_tdgl_data(self, solve_step: int = -1,
                       h5file: Optional[h5lite.Group] = None) -> None:
        """Load the arrays for a given saved step and derive the current
        densities."""
        context = (h5lite.File(self.path, "r") if h5file is None
                   else nullcontext(h5file))
        with context as f:
            self.data_range = step_min, step_max = get_data_range(f)
            if solve_step == 0:
                step = step_min
            elif solve_step < 0:
                step = step_max + 1 + solve_step
            else:
                step = solve_step
            self.tdgl_data = TDGLData.from_hdf5(f, step)
            self.dynamics = DynamicsData.from_hdf5(f, *self.data_range)
        mesh = self.device.mesh
        self._solve_step = step
        sc_norm, sc_dir, _ = get_edge_quantity_data(
            self.tdgl_data.supercurrent, mesh
        )
        nc_norm, nc_dir, _ = get_edge_quantity_data(
            self.tdgl_data.normal_current, mesh
        )
        K0 = self.device.K0.to(
            f"{self.current_units} / {self.device.length_units}"
        )
        units = f"{self.current_units} / {self.device.length_units}"
        self.supercurrent_density = Quantity.from_units(
            K0.magnitude * sc_norm[:, None] * sc_dir, units
        )
        self.normal_current_density = Quantity.from_units(
            K0.magnitude * nc_norm[:, None] * nc_dir, units
        )
        self._vorticity = None

    @property
    def current_density(self) -> Quantity:
        """Total sheet current density on sites."""
        return self.supercurrent_density + self.normal_current_density

    def _compute_vorticity(self) -> None:
        device = self.device
        mesh = device.mesh
        j_site = mesh.get_quantity_on_site(
            self.tdgl_data.supercurrent
        ) + mesh.get_quantity_on_site(self.tdgl_data.normal_current)
        # curl K on edges, then averaged to sites
        em = mesh.edge_mesh
        e0, e1 = em.edges[:, 0], em.edges[:, 1]
        grad_jx = (j_site[e1, 0] - j_site[e0, 0]) / em.edge_lengths
        grad_jy = (j_site[e1, 1] - j_site[e0, 1]) / em.edge_lengths
        ndirs = em.normalized_directions
        vort_edges = grad_jy * ndirs[:, 0] - grad_jx * ndirs[:, 1]
        vorticity = mesh.get_quantity_on_site(vort_edges, vector=False)
        units = f"{self.current_units} / {self.device.length_units}**2"
        scale = (device.K0 / device.coherence_length).to(units)
        self._vorticity = Quantity.from_units(
            vorticity * scale.magnitude, units
        )

    @property
    def vorticity(self) -> Optional[Quantity]:
        """Vorticity (curl of the sheet current) on sites."""
        if self.supercurrent_density is None:
            return None
        if self._vorticity is None:
            self._compute_vorticity()
        return self._vorticity

    # -- physical observables ---------------------------------------------------
    def magnetic_moment(self, units: Optional[str] = None,
                        with_units: bool = True):
        """z-component of the film's magnetic dipole moment,
        ``m_z = (1/2) int r x K d^2r``."""
        device = self.device
        mesh = device.mesh
        xi = device.coherence_length.magnitude
        sites = xi * (mesh.sites - np.atleast_2d(mesh.center_of_mass))
        areas = mesh.areas * xi**2
        units = units or f"{self.current_units} * {device.length_units}**2"
        K = self.current_density
        K_mag = K.to(
            f"{self.current_units} / {device.length_units}"
        ).magnitude
        # z component of r x K (np.cross on 2-vectors is deprecated in
        # NumPy 2.0).
        cross_z = sites[:, 0] * K_mag[:, 1] - sites[:, 1] * K_mag[:, 0]
        mz = np.sum(0.5 * cross_z * areas)
        m = Quantity.from_units(
            mz, f"{self.current_units} * {device.length_units}"
        ) * ureg(device.length_units)
        m = m.to(units)
        if not with_units:
            return m.magnitude
        return m

    def grid_current_density(self, *, dataset: Optional[str] = None,
                             grid_shape=(200, 200), method: str = "linear",
                             units: Optional[str] = None,
                             with_units: bool = False, **kwargs):
        """Current density interpolated onto a rectangular grid. Returns
        ``(xgrid, ygrid, J)``."""
        if isinstance(grid_shape, int):
            grid_shape = (grid_shape, grid_shape)
        (xmin, ymin), (xmax, ymax) = self.device.film.bbox
        xs = np.linspace(xmin, xmax, grid_shape[1])
        ys = np.linspace(ymin, ymax, grid_shape[0])
        xgrid, ygrid = np.meshgrid(xs, ys)
        positions = np.stack([xgrid.ravel(), ygrid.ravel()], axis=1)
        J = self.interp_current_density(
            positions, dataset=dataset, method=method, units=units,
            with_units=False, **kwargs,
        )
        J = J.reshape(*grid_shape, 2).transpose(2, 0, 1)
        if with_units:
            units = units or f"{self.current_units}/{self.device.length_units}"
            J = Quantity.from_units(J, units)
        return xgrid, ygrid, J

    def _interpolator(self, method: str):
        """``f(values, x, y)``: mesh interpolation of site ``values``
        (NaN outside the mesh)."""
        if method not in ("linear", "cubic"):
            raise ValueError(f"Invalid interpolation method: {method}.")
        if method == "linear":
            if self._linear is None:
                self._linear = LinearTriInterpolator(self.device.points,
                                                     self.device.triangles)
            return self._linear
        import matplotlib.tri as mtri

        tri = self.device.triangulation
        return lambda values, x, y: mtri.CubicTriInterpolator(
            tri, values)(x, y).data

    def interp_current_density(self, positions: np.ndarray, *,
                               dataset: Optional[str] = None,
                               method: Literal["linear", "cubic"] = "linear",
                               units: Optional[str] = None,
                               with_units: bool = False):
        """Interpolate the sheet current density at arbitrary positions."""
        if dataset is None:
            J = self.current_density
        elif dataset == "supercurrent":
            J = self.supercurrent_density
        elif dataset == "normal_current":
            J = self.normal_current_density
        else:
            raise ValueError(f"Unexpected dataset: {dataset}.")
        units = units or f"{self.current_units} / {self.device.length_units}"
        interp = self._interpolator(method)
        positions = np.atleast_2d(positions)
        J_mag = J.to(units).magnitude
        Jx = interp(J_mag[:, 0], positions[:, 0], positions[:, 1])
        Jy = interp(J_mag[:, 1], positions[:, 0], positions[:, 1])
        out = np.stack([Jx, Jy], axis=1)
        out[~np.isfinite(out).all(axis=1)] = 0
        out[~self.device.contains_points(positions)] = 0
        if with_units:
            return Quantity.from_units(out, units)
        return out

    def interp_order_parameter(self, positions: np.ndarray,
                               method: Literal["linear", "cubic"] = "linear"
                               ) -> np.ndarray:
        """Interpolate the complex order parameter at arbitrary positions."""
        interp = self._interpolator(method)
        positions = np.atleast_2d(positions)
        psi = self.tdgl_data.psi
        re = interp(psi.real, positions[:, 0], positions[:, 1])
        im = interp(psi.imag, positions[:, 0], positions[:, 1])
        return re + 1j * im

    def interp_epsilon(self, positions: np.ndarray,
                       method: Literal["linear", "cubic"] = "linear"
                       ) -> np.ndarray:
        """Interpolate the disorder parameter at arbitrary positions."""
        interp = self._interpolator(method)
        positions = np.atleast_2d(positions)
        return interp(self.tdgl_data.epsilon, positions[:, 0],
                      positions[:, 1])

    # -- fluxoids -------------------------------------------------------------------
    def polygon_fluxoid(
        self,
        polygon_points,
        interp_method: Literal["linear", "cubic"] = "linear",
        units: str = "Phi_0",
        with_units: bool = True,
    ) -> Fluxoid:
        """Fluxoid (flux + supercurrent parts) through a closed polygon:
        ``Phi_f = oint A . dl + oint mu_0 Lambda K_s . dl``."""
        device = self.device
        units = units or f"{self.field_units} * {device.length_units}**2"
        polygon = Polygon(points=polygon_points)
        points = np.concatenate([polygon.points, polygon.points[:1]], axis=0)
        if not device.film.contains_points(polygon.points).all():
            raise ValueError(
                "The polygon must lie completely within the film."
            )
        J_units = f"{self.current_units} / {device.length_units}"
        J_poly = self.interp_current_density(
            points, dataset="supercurrent", method=interp_method,
            units=J_units, with_units=False,
        )
        zs = device.layer.z0 * np.ones(len(points))
        dl = np.diff(points, axis=0, prepend=points[:1])
        A_poly = self.vector_potential_at_position(
            points, zs=zs,
            units=f"{self.field_units} * {device.length_units}",
            with_units=False, return_sum=True,
        )[:, :2]
        # flux part: oint A . dl
        int_A = np.trapezoid((A_poly * dl).sum(axis=1))
        flux_part = (
            Quantity.from_units(
                int_A, f"{self.field_units} * {device.length_units}"
            ) * ureg(device.length_units)
        ).to(units)
        # supercurrent part: oint mu_0 Lambda / |psi|^2 K_s . dl
        psi_poly = self.interp_order_parameter(points, method=interp_method)
        ns = np.abs(psi_poly) ** 2
        Lambda_eff = device.layer.Lambda / ns
        int_J = np.trapezoid(
            (Lambda_eff[:, None] * J_poly * dl).sum(axis=1)
        )
        supercurrent_part = (
            ureg("mu_0")
            * Quantity.from_units(int_J, f"{self.current_units}")
            * ureg(device.length_units)
        ).to(units)
        if not with_units:
            return Fluxoid(flux_part.magnitude, supercurrent_part.magnitude)
        return Fluxoid(flux_part, supercurrent_part)

    def hole_fluxoid(
        self,
        hole_name: str,
        points: Optional[np.ndarray] = None,
        interp_method: Literal["linear", "cubic"] = "linear",
        units: str = "Phi_0",
        with_units: bool = True,
    ) -> Fluxoid:
        """Fluxoid for a polygon enclosing the named hole."""
        if points is None:
            from ..fluxoid import make_fluxoid_polygons

            points = make_fluxoid_polygons(self.device,
                                           holes=hole_name)[hole_name]
        hole = {h.name: h for h in self.device.holes}[hole_name]
        if not Polygon(points=points).contains_points(hole.points).all():
            raise ValueError(
                f"Hole {hole_name} is not completely enclosed by the polygon."
            )
        return self.polygon_fluxoid(points, interp_method=interp_method,
                                    units=units, with_units=with_units)

    def boundary_phases(self, delta: bool = False
                        ) -> Dict[str, BoundaryPhases]:
        """Unwrapped order-parameter phase along each boundary loop.
        ``(phases[-1] - phases[0]) / (2 pi)`` is the winding number."""
        boundary_indices = self.device.boundary_sites()
        theta = np.angle(self.tdgl_data.psi)
        phases = {}
        for name, indices in boundary_indices.items():
            # Close the loop so the winding number measures a full circuit.
            closed = np.concatenate([indices, indices[:1]])
            phase = np.unwrap(theta[closed])
            if delta:
                phase = phase - phase[0]
            phases[name] = BoundaryPhases(closed, phase)
        return phases

    def current_through_path(
        self,
        path_coords: np.ndarray,
        dataset: Optional[str] = None,
        method: Literal["linear", "cubic"] = "linear",
        units: Optional[str] = None,
        with_units: bool = True,
    ):
        """Total current crossing a path."""
        device = self.device
        units = units or self.current_units
        path_coords = np.asarray(path_coords)
        J = self.interp_current_density(
            path_coords, dataset=dataset, method=method,
            units=f"{units} / {device.length_units}", with_units=False,
        )
        edge_positions = (path_coords[:-1] + path_coords[1:]) / 2
        J_edge = (J[:-1] + J[1:]) / 2
        edge_lengths, unit_normals = path_vectors(path_coords)
        J_dot_n = (J_edge * unit_normals).sum(axis=1)
        in_device = device.contains_points(edge_positions)
        total = np.trapezoid((J_dot_n * edge_lengths)[in_device])
        if with_units:
            return Quantity.from_units(total, units)
        return float(total)

    # -- Biot-Savart ---------------------------------------------------------------
    def _positions_and_zs(self, positions, zs):
        positions = np.atleast_2d(positions)
        if positions.shape[1] == 3:
            if zs is not None:
                raise ValueError(
                    "If positions has shape (m, 3), zs cannot be given."
                )
            zs = positions[:, 2]
            positions = positions[:, :2]
        elif isinstance(zs, numbers.Real):
            zs = zs * np.ones(len(positions))
        zs = np.asarray(zs).squeeze()
        if zs.ndim == 0:
            zs = zs[None]
        return positions, zs

    def field_at_position(
        self,
        positions: np.ndarray,
        *,
        zs: Union[float, np.ndarray, None] = None,
        vector: bool = False,
        units: Optional[str] = None,
        with_units: bool = True,
        return_sum: bool = True,
    ):
        """Magnetic field from the device's currents at arbitrary points."""
        device = self.device
        points = device.points
        units = units or self.field_units
        positions, zs = self._positions_and_zs(positions, zs)
        layer = device.layer
        weights = device.mesh.areas * device.coherence_length.magnitude**2
        if np.all((zs - layer.z0) == 0):
            if device.film.contains_points(positions).any():
                raise ValueError("Cannot interpolate fields within a film.")
        fields = []
        for name in ("supercurrent_density", "normal_current_density"):
            J = getattr(self, name).to(
                f"{self.current_units} / {device.length_units}"
            ).magnitude
            H = biot_savart_2d(
                positions[:, 0], positions[:, 1], zs,
                positions=points, areas=weights, current_densities=J,
                z0=layer.z0, length_units=device.length_units,
                current_units=self.current_units, vector=vector,
            )
            fields.append(
                convert_field(H, units, old_units="tesla",
                              with_units=with_units)
            )
        result = BiotSavartField(*fields)
        if return_sum:
            return fields[0] + fields[1]
        return result

    def vector_potential_at_position(
        self,
        positions: np.ndarray,
        *,
        zs: Union[float, np.ndarray, None] = None,
        units: Optional[str] = None,
        with_units: bool = True,
        return_sum: bool = True,
    ):
        """Total vector potential (applied + induced by device currents) at
        arbitrary points."""
        device = self.device
        points = device.points
        areas = device.mesh.areas * device.coherence_length.magnitude**2
        units = units or f"{self.field_units} * {device.length_units}"
        positions, zs = self._positions_and_zs(positions, zs)
        A_kwargs = {}
        if (isinstance(self.applied_vector_potential, Parameter)
                and self.applied_vector_potential.time_dependent):
            A_kwargs["t"] = self.times[self.solve_step]
        applied = np.asarray(
            self.applied_vector_potential(
                positions[:, 0], positions[:, 1], zs, **A_kwargs
            )
        )
        if applied.ndim == 1:
            applied = applied[None, :]
        if applied.shape[1] == 2:
            applied = np.concatenate(
                [applied, np.zeros_like(applied[:, :1])], axis=1
            )
        applied_q = Quantity.from_units(
            applied, f"{self.field_units} * {device.length_units}"
        ).to(units)
        out = {"applied": applied_q.magnitude}
        dz = (zs - device.layer.z0)[:, None]
        diff = positions[:, None, :] - points[None, :, :]
        rho = np.sqrt(np.sum(diff**2, axis=2) + dz**2)
        J_units = f"{self.current_units} / {device.length_units}"
        mu0_over_4pi = (
            (ureg("mu_0") / (4 * np.pi))
            * ureg(self.current_units)
        ).to(units).magnitude
        for name in ("supercurrent_density", "normal_current_density"):
            J = getattr(self, name).to(J_units).magnitude
            Axy = np.einsum("ms,sk,s->mk", 1.0 / rho, J, areas)
            A = np.concatenate([Axy, np.zeros_like(Axy[:, :1])], axis=1)
            out[name] = mu0_over_4pi * A
        if return_sum:
            total = sum(out.values())
            if with_units:
                return Quantity.from_units(total, units)
            return total
        if with_units:
            return {k: Quantity.from_units(v, units) for k, v in out.items()}
        return out

    # -- serialization -----------------------------------------------------------
    def _save_to_hdf5_file(self, h5file, save_tdgl_data: bool = False,
                           save_mesh: bool = True) -> None:
        def serialize_func(func, name, group):
            try:
                group.attrs[name] = func
            except TypeError:
                group[f"{name}.pickle"] = np.void(dumps(func))

        if isinstance(h5file, str):
            mode = "x" if save_tdgl_data else "r+"
            context = h5lite.File(h5file, mode)
        else:
            context = nullcontext(h5file)
        with context as f:
            f.require_group("version_info").attrs.update(self.version_info)
            data_grp = f.require_group("data")
            if save_tdgl_data:
                self.tdgl_data.to_hdf5(data_grp)
                self.dynamics.to_hdf5(
                    data_grp.require_group(
                        f"{self.tdgl_data.step}/running_state"
                    )
                )
            if "solution" in f:
                del f["solution"]
            group = f.create_group("solution")
            options_grp = group.create_group("options")
            for k, v in dataclasses.asdict(self.options).items():
                if k == "sparse_solver":
                    v = v.value
                if v is not None:
                    options_grp.attrs[k] = v
            group.attrs["time_created"] = self.time_created.isoformat()
            group.attrs["current_units"] = self.current_units
            group.attrs["field_units"] = self.field_units
            group.attrs["total_seconds"] = self.total_seconds
            serialize_func(self.applied_vector_potential,
                           "applied_vector_potential", group)
            serialize_func(self.terminal_currents, "terminal_currents", group)
            serialize_func(self.disorder_epsilon, "disorder_epsilon", group)
            self.device.to_hdf5(group.create_group("device"),
                                save_mesh=save_mesh)

    def to_hdf5(self, h5path: Optional[str] = None,
                save_mesh: bool = True) -> None:
        """Append solution metadata to the existing output file, or write a
        standalone file at ``h5path``."""
        if self.saved_on_disk:
            if h5path is None:
                self._save_to_hdf5_file(self.path, save_mesh=save_mesh)
            else:
                shutil.copy(self.path, h5path)
                self._save_to_hdf5_file(h5path, save_mesh=save_mesh)
            return
        if h5path is None:
            raise ValueError(
                "The solution HDF5 file does not exist and no new path was"
                " given."
            )
        self._save_to_hdf5_file(h5path, save_tdgl_data=True,
                                save_mesh=save_mesh)

    @staticmethod
    def from_hdf5(path: str, solve_step: int = -1) -> "Solution":
        """Load a solution saved with :meth:`to_hdf5`."""

        def deserialize_func(name, group):
            if name in group.attrs:
                return group.attrs[name]
            if f"{name}.pickle" in group:
                # A cloudpickle stream loads with pickle (functions pickled
                # by value need cloudpickle installed).
                return loads(np.void(group[f"{name}.pickle"]).tobytes(),
                             name)
            raise IOError(f"Unable to load {name}.")

        with h5lite.File(path, "r") as f:
            grp = f["solution"]
            options_kwargs = dict(grp["options"].attrs)
            for key, val in list(options_kwargs.items()):
                if isinstance(val, np.generic):
                    options_kwargs[key] = val.item()
            options = SolverOptions(**options_kwargs)
            options.validate()
            time_created = datetime.fromisoformat(grp.attrs["time_created"])
            vector_potential = deserialize_func("applied_vector_potential",
                                                grp)
            terminal_currents = deserialize_func("terminal_currents", grp)
            disorder_epsilon = deserialize_func("disorder_epsilon", grp)
            total_seconds = grp.attrs["total_seconds"]
            device = Device.from_hdf5(grp["device"])
        solution = Solution(
            device=device,
            options=options,
            path=path,
            applied_vector_potential=vector_potential,
            terminal_currents=terminal_currents,
            disorder_epsilon=disorder_epsilon,
            total_seconds=total_seconds,
            _solve_step=solve_step,
        )
        solution._time_created = time_created
        return solution

    def delete_hdf5(self) -> None:
        """Remove the backing HDF5 file."""
        if self.saved_on_disk:
            os.remove(self.path)

    # -- comparison ----------------------------------------------------------------
    def equals(self, other: Any, require_same_timestamp: bool = False) -> bool:
        """Whether two solutions describe the same simulation and data."""
        if other is self:
            return True
        if not isinstance(other, Solution):
            return False

        def compare_callables(first, second):
            if isinstance(first, Parameter) or not hasattr(first, "__code__"):
                return first == second
            if callable(first):
                if not callable(second):
                    return False
                get_code = operator.attrgetter("co_code", "co_consts")
                return get_code(first.__code__) == get_code(second.__code__)
            return first == second

        if not (
            self.device == other.device
            and self.options == other.options
            and self.solve_step == other.solve_step
            and compare_callables(self.applied_vector_potential,
                                  other.applied_vector_potential)
            and compare_callables(self.terminal_currents,
                                  other.terminal_currents)
            and compare_callables(self.disorder_epsilon,
                                  other.disorder_epsilon)
            and self.tdgl_data == other.tdgl_data
            and self.dynamics == other.dynamics
        ):
            return False
        if require_same_timestamp and self.time_created != other.time_created:
            return False
        return True

    def __eq__(self, other) -> bool:
        return self.equals(other, require_same_timestamp=True)

    # -- plotting aliases --------------------------------------------------------------
    def plot_currents(self, **kwargs):
        """Alias of :func:`tdgl_tpu_torch.plot_currents`."""
        from .plot_solution import plot_currents

        return plot_currents(self, **kwargs)

    def plot_order_parameter(self, **kwargs):
        """Alias of :func:`tdgl_tpu_torch.plot_order_parameter`."""
        from .plot_solution import plot_order_parameter

        return plot_order_parameter(self, **kwargs)

    def plot_field_at_positions(self, positions, **kwargs):
        """Alias of :func:`tdgl_tpu_torch.plot_field_at_positions`."""
        from .plot_solution import plot_field_at_positions

        return plot_field_at_positions(self, positions, **kwargs)

    def plot_vorticity(self, **kwargs):
        """Alias of :func:`tdgl_tpu_torch.plot_vorticity`."""
        from .plot_solution import plot_vorticity

        return plot_vorticity(self, **kwargs)

    def plot_scalar_potential(self, **kwargs):
        """Alias of :func:`tdgl_tpu_torch.plot_scalar_potential`."""
        from .plot_solution import plot_scalar_potential

        return plot_scalar_potential(self, **kwargs)
