"""Raw solver data containers and per-step dynamics.

Port of :mod:`tdgl_tpu.solution.data` on :mod:`tdgl_tpu_torch.utils.h5lite`
(no h5py, tqdm or matplotlib). API and HDF5-schema parity with the
reference ``tdgl/solution/data.py`` (``TDGLData:68``, ``DynamicsData:146``,
``get_current_through_paths:506``). The plots import matplotlib when they
are called.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Literal, Optional, Sequence, Tuple, Union

import numpy as np

from ..geometry import path_vectors
from ..utils import h5lite
from ..utils.h5lite import Group


def progress(iterable, desc: str, enabled: bool):
    """``iterable`` wrapped in a tqdm bar when ``enabled`` and tqdm is
    installed."""
    if enabled:
        try:
            from tqdm import tqdm
        except ImportError:
            return iterable
        return tqdm(iterable, desc=desc)
    return iterable


def get_data_range(h5file: Group) -> Tuple[int, int]:
    """Minimum and maximum saved solve steps in the file."""
    keys = np.asarray([int(key) for key in h5file["data"]])
    return int(keys.min()), int(keys.max())


def load_state_data(h5file: Group, step: int) -> Dict[str, Any]:
    """The state attrs (step/time/dt) for a saved solve step."""
    return dict(h5file["data"][str(step)].attrs)


def array_safe_equals(a: Any, b: Any) -> bool:
    """Equality that tolerates numpy arrays."""
    if a is b:
        return True
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.shape == b.shape and np.allclose(a, b)
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


def dataclass_equals(dc1: Any, dc2: Any) -> bool:
    """Field-wise equality for dataclasses that may hold numpy arrays."""
    if dc1 is dc2:
        return True
    if dc1.__class__ is not dc2.__class__:
        return False
    for f in dataclasses.fields(dc1):
        if not array_safe_equals(getattr(dc1, f.name), getattr(dc2, f.name)):
            return False
    return True


def get_edge_quantity_data(
    quantity_on_edges: np.ndarray, mesh
) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float]]:
    """Magnitude and direction of an edge vector quantity evaluated on sites."""
    vectors = mesh.get_quantity_on_site(quantity_on_edges)
    norm = np.linalg.norm(vectors, axis=1)
    directions = vectors / np.maximum(norm, 1e-12)[:, np.newaxis]
    return norm, directions, (float(norm.min()), float(norm.max()))


@dataclasses.dataclass(eq=False)
class TDGLData:
    """Raw TDGL arrays for a single saved solve step (dimensionless units)."""

    step: int
    epsilon: np.ndarray
    psi: np.ndarray
    mu: np.ndarray
    applied_vector_potential: np.ndarray
    induced_vector_potential: np.ndarray
    supercurrent: np.ndarray
    normal_current: np.ndarray
    state: Dict[str, Any]

    @staticmethod
    def from_hdf5(h5file: Group, step: int) -> "TDGLData":
        """Load a step from an output file; arrays stored at the file root are
        treated as time-independent (fixed) values."""
        step = str(step)

        def get(key):
            if key == "step":
                return int(step)
            if key == "state":
                return load_state_data(h5file, step)
            for holder in (h5file, h5file["data"][step]):
                if key in holder:
                    return np.asarray(holder[key])
            return None

        return TDGLData(
            **{f.name: get(f.name) for f in dataclasses.fields(TDGLData)}
        )

    def to_hdf5(self, h5group: Group) -> None:
        """Save under ``h5group[str(step)]``."""
        group = h5group.create_group(str(self.step))
        for f in dataclasses.fields(self):
            key = f.name
            value = getattr(self, key)
            if key == "step":
                continue
            if key == "state":
                group.attrs.update(value)
            elif value is not None:
                group[key] = value

    def __eq__(self, other: Any) -> bool:
        return dataclass_equals(self, other)


@dataclasses.dataclass(eq=False)
class DynamicsData:
    """Per-time-step scalars: dt, probe-point potentials and phases.

    ``time`` is the cumulative sum of ``dt``.
    """

    dt: np.ndarray
    time: np.ndarray = dataclasses.field(init=False)
    mu: Optional[np.ndarray] = None
    theta: Optional[np.ndarray] = None
    screening_iterations: Optional[np.ndarray] = None

    def __post_init__(self):
        self.time = np.cumsum(self.dt)

    def time_slice(self, tmin: float = -np.inf, tmax: float = np.inf
                   ) -> np.ndarray:
        """Indices of time steps with ``tmin <= t <= tmax``."""
        (ix,) = np.where((self.time >= tmin) & (self.time <= tmax))
        return ix

    def closest_time(self, time: float) -> int:
        """Index of the time step closest to ``time``."""
        return int(np.argmin(np.abs(self.time - time)))

    def voltage(self, i: int = 0, j: int = 1) -> np.ndarray:
        """Voltage ``V_ij(t) = mu_i(t) - mu_j(t)`` between probe points."""
        if self.mu is None:
            raise ValueError("No voltage data available.")
        if self.mu.shape[0] == 1:
            raise ValueError("The solution has only one probe point.")
        return self.mu[i] - self.mu[j]

    def phase_difference(self, i: int = 0, j: int = 1) -> np.ndarray:
        """Order-parameter phase difference between probe points."""
        if self.theta is None:
            raise ValueError("No phase data available.")
        if self.theta.shape[0] == 1:
            raise ValueError("The solution has only one probe point.")
        return self.theta[i] - self.theta[j]

    def mean_voltage(self, i: int = 0, j: int = 1, tmin: float = -np.inf,
                     tmax: float = np.inf) -> float:
        """dt-weighted time average of the voltage over a time window."""
        if self.mu is None:
            raise ValueError("No voltage data available.")
        ix = self.time_slice(tmin, tmax)
        return float(np.average(self.voltage(i, j)[ix], weights=self.dt[ix]))

    def resample(self, num_points: Optional[int] = None) -> "DynamicsData":
        """Linear-interpolate onto a uniform time grid."""
        time = self.time
        if num_points is None:
            num_points = len(time)
        ts = np.linspace(time.min(), time.max(), num_points)
        mu = theta = None
        if self.mu is not None:
            mu = np.stack([np.interp(ts, time, row) for row in self.mu])
        if self.theta is not None:
            theta = np.stack([np.interp(ts, time, row) for row in self.theta])
        return DynamicsData(dt=(ts[1] - ts[0]) * np.ones_like(ts), mu=mu,
                            theta=theta)

    def plot(self, i: int = 0, j: int = 1, tmin: float = -np.inf,
             tmax: float = np.inf, grid: bool = True,
             mean_voltage: bool = True, labels: bool = True,
             legend: bool = False):
        """Plot the voltage and phase difference vs time."""
        import matplotlib.pyplot as plt

        fig, (ax, bx) = plt.subplots(2, 1, sharex=True)
        ax.grid(grid)
        bx.grid(grid)
        ix = self.time_slice(tmin, tmax)
        ts = self.time
        ax.plot(ts[ix], self.voltage(i, j)[ix])
        if mean_voltage:
            ax.axhline(self.mean_voltage(i, j, tmin, tmax),
                       label="Mean voltage", color="k", ls="--")
        bx.plot(ts[ix], np.unwrap(self.phase_difference(i, j))[ix] / np.pi)
        if labels:
            ax.set_ylabel(f"Voltage\n$\\Delta\\mu_{{{i},{j}}}$ [$V_0$]")
            bx.set_xlabel("Time, $t$ [$\\tau_0$]")
            bx.set_ylabel(
                f"Phase difference\n$\\Delta\\theta_{{{i},{j}}}/\\pi$")
        if legend:
            ax.legend(loc=0)
        return fig, (ax, bx)

    def plot_dt(self, tmin: float = -np.inf, tmax: float = np.inf,
                grid: bool = True, labels: bool = True, **histogram_kwargs):
        """Plot dt vs time and a histogram of dt."""
        import matplotlib.pyplot as plt

        fig, (ax, bx) = plt.subplots(
            1, 2, gridspec_kw=dict(width_ratios=[2, 1])
        )
        ax.sharey(bx)
        ax.grid(grid)
        bx.grid(grid)
        ix = self.time_slice(tmin, tmax)
        ax.plot(self.time[ix], self.dt[ix])
        histogram_kwargs.setdefault("bins", 101)
        histogram_kwargs.setdefault("density", True)
        histogram_kwargs["orientation"] = "horizontal"
        bx.hist(self.dt[ix], **histogram_kwargs)
        if labels:
            ax.set_xlabel("Time, $t$ [$\\tau_0$]")
            ax.set_ylabel("Time step, $\\Delta t$ [$\\tau_0$]")
            bx.set_xlabel("Density" if histogram_kwargs.get("density")
                          else "Counts per bin")
        fig.tight_layout()
        return fig, (ax, bx)

    @staticmethod
    def from_hdf5(h5file: Group,
                  step_min: Optional[int] = None,
                  step_max: Optional[int] = None) -> "DynamicsData":
        """Load from either a ``DynamicsData.to_hdf5`` group or by
        concatenating ``running_state`` groups across saved steps (dropping
        the zero-dt padding in partial buffers)."""
        iterations = None
        if "theta" in h5file:
            dt = np.array(h5file["dt"])
            theta = np.array(h5file["theta"])
            mu = np.array(h5file["mu"]) if "mu" in h5file else None
            if "screening_iterations" in h5file:
                iterations = np.array(h5file["screening_iterations"])
        else:
            dts: List[np.ndarray] = []
            mus: List[np.ndarray] = []
            thetas: List[np.ndarray] = []
            screening: List[np.ndarray] = []
            if step_min is None:
                step_min, step_max = get_data_range(h5file)
            for i in range(step_min, step_max + 1):
                grp = h5file[f"data/{i}"]
                if "running_state" not in grp:
                    continue
                grp = grp["running_state"]
                dts.append(np.atleast_1d(np.array(grp["dt"])))
                if "mu" in grp:
                    mus.append(np.atleast_2d(np.array(grp["mu"])))
                if "theta" in grp:
                    thetas.append(np.atleast_2d(np.array(grp["theta"])))
                if "screening_iterations" in grp:
                    screening.append(
                        np.atleast_1d(np.array(grp["screening_iterations"]))
                    )
            dt = np.concatenate(dts)
            mask = dt > 0
            dt = dt[mask]
            mu = theta = None
            if mus:
                mu = np.concatenate(mus, axis=1)[..., mask]
            if thetas:
                theta = np.concatenate(thetas, axis=1)[..., mask]
            if screening:
                iterations = np.concatenate(screening)[mask]
        return DynamicsData(dt, mu=mu, theta=theta,
                            screening_iterations=iterations)

    def to_hdf5(self, h5group: Group) -> None:
        """Save the dynamics arrays."""
        h5group["dt"] = self.dt
        for key in ("mu", "theta", "screening_iterations"):
            value = getattr(self, key)
            if value is not None:
                h5group[key] = value

    @staticmethod
    def from_solution(solution_path: str,
                      probe_points: Optional[Sequence] = None,
                      progress_bar: bool = False) -> "DynamicsData":
        """Reconstruct coarse dynamics from the saved snapshots of a solution
        (one sample per ``save_every`` steps)."""
        from .solution import Solution

        solution = Solution.from_hdf5(solution_path)
        device = solution.device
        mesh = device.mesh
        if probe_points is None:
            probe_points = device.probe_points
        if probe_points is None:
            raise ValueError("No probe points were provided.")
        probe_points = np.asarray(probe_points).squeeze()
        if probe_points.ndim != 2 or probe_points.shape[1] != 2:
            raise ValueError(
                f"Probe points must have shape (n, 2); got"
                f" {probe_points.shape}."
            )
        if not device.contains_points(probe_points).all():
            raise ValueError("All probe points must lie within the film.")
        xi = device.layer.coherence_length
        probe_ix = [mesh.closest_site(xy) for xy in probe_points / xi]
        step_min, step_max = solution.data_range
        num_steps = step_max - step_min + 1
        times = np.zeros(num_steps)
        mus = np.zeros((len(probe_points), num_steps))
        thetas = np.zeros((len(probe_points), num_steps))
        with h5lite.File(solution_path, "r") as f:
            for i in progress(range(step_min, step_max + 1), "Time steps",
                              progress_bar):
                grp = f[f"data/{i}"]
                times[i] = float(grp.attrs["time"])
                mus[:, i] = np.array(grp["mu"])[probe_ix]
                thetas[:, i] = np.angle(np.array(grp["psi"]))[probe_ix]
        return DynamicsData(dt=np.diff(times), mu=mus, theta=thetas)

    def __eq__(self, other: Any) -> bool:
        return dataclass_equals(self, other)


def get_current_through_paths(
    solution_path: str,
    paths: Union[np.ndarray, List[np.ndarray]],
    dataset: Optional[str] = None,
    interp_method: Literal["linear", "cubic"] = "linear",
    units: Optional[str] = None,
    with_units: bool = True,
    progress_bar: bool = True,
):
    """Time series of the total current crossing one or more paths.

    Args:
        solution_path: Path to a solution HDF5 file.
        paths: One ``(n, 2)`` path array or a list of them.
        dataset: None (total current), "supercurrent", or "normal_current".
        interp_method: "linear" or "cubic" interpolation.
        units: Current units of the result.
        with_units: Attach units to the result.
        progress_bar: Display progress over saved steps.

    Returns:
        ``(times, currents)`` — currents is an array per path (or a single
        array if a single path was given).
    """
    from ..utils.units import ureg as _ureg
    from .solution import Solution

    solution = Solution.from_hdf5(solution_path)
    device = solution.device
    interp_type = solution._interpolator(interp_method)
    if dataset not in (None, "supercurrent", "normal_current"):
        raise ValueError(f"Invalid dataset name: {dataset}.")
    units = units or solution.current_units

    single = isinstance(paths, np.ndarray)
    if single:
        paths = [paths]
    paths = [np.asarray(p) for p in paths]
    edge_positions, edge_lengths, unit_normals, in_device = [], [], [], []
    for path in paths:
        edge_positions.append((path[:-1] + path[1:]) / 2)
        lengths, normals = path_vectors(path)
        edge_lengths.append(lengths)
        unit_normals.append(normals)
        in_device.append(device.contains_points(edge_positions[-1]))

    K0 = device.K0.to(
        f"{solution.current_units} / {device.length_units}"
    ).magnitude
    step_min, step_max = solution.data_range
    times = solution.times
    raw = [np.zeros(step_max - step_min + 1) for _ in paths]
    mesh = device.mesh
    with h5lite.File(solution_path, "r") as f:
        for i in progress(range(step_min, step_max + 1), "Time steps",
                          progress_bar):
            grp = f[f"data/{i}"]
            if dataset is None:
                K_edge = (np.array(grp["supercurrent"])
                          + np.array(grp["normal_current"]))
            else:
                K_edge = np.array(grp[dataset])
            K_site = K0 * mesh.get_quantity_on_site(K_edge)
            for p, path in enumerate(paths):
                pos = edge_positions[p]
                jx = interp_type(K_site[:, 0], pos[:, 0], pos[:, 1])
                jy = interp_type(K_site[:, 1], pos[:, 0], pos[:, 1])
                J_dot_n = jx * unit_normals[p][:, 0] + jy * unit_normals[p][:, 1]
                integrand = np.where(
                    in_device[p] & np.isfinite(J_dot_n),
                    J_dot_n * edge_lengths[p], 0.0,
                )
                raw[p][i - step_min] = np.trapezoid(integrand)
    scale = _ureg(f"{solution.current_units}").to(units).magnitude
    currents = [r * scale for r in raw]
    if with_units:
        currents = [Quantity_array(c, units) for c in currents]
    if single:
        return times, currents[0]
    return times, currents


def Quantity_array(values: np.ndarray, units: str):
    from ..utils.units import Quantity

    return Quantity.from_units(values, units)
