"""Publication plotting for solutions (the counterpart of
:mod:`tdgl_tpu.solution.plot_solution`).

API parity with the reference ``tdgl/solution/plot_solution.py:14-726``:
``plot_currents``, ``plot_order_parameter``, ``plot_vorticity``,
``plot_scalar_potential``, ``plot_field_at_positions``,
``plot_current_through_paths``, and the ``cross_section`` helper.
matplotlib is imported inside each plotting function, so this module
imports where matplotlib is not installed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def auto_grid(num_plots: int, max_cols: int = 3, **kwargs):
    """A figure with enough subplots for ``num_plots`` panels."""
    import matplotlib.pyplot as plt

    ncols = min(max_cols, num_plots)
    nrows = int(np.ceil(num_plots / ncols))
    fig, axes = plt.subplots(nrows, ncols, squeeze=False, **kwargs)
    axes = np.asarray(axes)
    for ax in axes.flat[num_plots:]:
        ax.axis("off")
    return fig, axes


def setup_color_limits(
    dict_of_arrays,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = False,
    auto_range_cutoff: Optional[float] = None,
):
    """Per-quantity (vmin, vmax), optionally shared and/or symmetric."""
    clims = {}
    for name, array in dict_of_arrays.items():
        array = np.asarray(array)
        finite = array[np.isfinite(array)]
        if auto_range_cutoff:
            lo, hi = auto_range_iqr(finite, cutoff_percentile=auto_range_cutoff)
        else:
            lo, hi = float(finite.min()), float(finite.max())
        clims[name] = (lo, hi)
    if vmin is not None or vmax is not None:
        clims = {k: (vmin if vmin is not None else v[0],
                     vmax if vmax is not None else v[1])
                 for k, v in clims.items()}
    if share_color_scale:
        lo = min(v[0] for v in clims.values())
        hi = max(v[1] for v in clims.values())
        clims = {k: (lo, hi) for k in clims}
    if symmetric_color_scale:
        clims = {k: (-max(abs(v[0]), abs(v[1])), max(abs(v[0]), abs(v[1])))
                 for k, v in clims.items()}
    return clims


def auto_range_iqr(data_array: np.ndarray,
                   cutoff_percentile: Union[float, Tuple[float, float]] = 1.0
                   ) -> Tuple[float, float]:
    """Outlier-robust color range based on the interquartile range."""
    if np.isscalar(cutoff_percentile):
        cutoff_percentile = (cutoff_percentile, cutoff_percentile)
    pmin, pmax = cutoff_percentile
    data = np.asarray(data_array).ravel()
    q1, q3 = np.percentile(data, [25, 75])
    iqr = q3 - q1
    lo = np.percentile(data, pmin)
    hi = np.percentile(data, 100 - pmax)
    vmin = max(lo, q1 - 1.5 * iqr)
    vmax = min(hi, q3 + 1.5 * iqr)
    if vmin >= vmax:
        vmin, vmax = float(data.min()), float(data.max() or 1)
    return float(vmin), float(vmax)


def cross_section(
    dataset_coords: np.ndarray,
    dataset_values: np.ndarray,
    cross_section_coords: Union[np.ndarray, Sequence[np.ndarray]],
    interp_method: str = "linear",
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Linear cross sections through scattered data.

    Returns ``(paths, path_coords, values)`` where ``path_coords`` is the
    arc-length coordinate along each path.
    """
    from scipy.interpolate import griddata

    if isinstance(cross_section_coords, np.ndarray):
        cross_section_coords = [cross_section_coords]
    paths, coords, values = [], [], []
    for path in cross_section_coords:
        path = np.asarray(path)
        dr = np.linalg.norm(np.diff(path, axis=0), axis=1)
        arc = np.concatenate([[0], np.cumsum(dr)])
        arc = arc - arc.max() / 2
        vals = griddata(dataset_coords, dataset_values, path,
                        method=interp_method)
        paths.append(path)
        coords.append(arc)
        values.append(vals)
    return paths, coords, values


def _plot_scalar(solution, values, title, units_label, ax=None,
                 cmap="viridis", vmin=None, vmax=None, shading="gouraud",
                 symmetric=False, **kwargs):
    import matplotlib.pyplot as plt

    device = solution.device
    tri = device.triangulation
    if ax is None:
        _, ax = plt.subplots()
    fig = ax.get_figure()
    values = np.asarray(values, dtype=float)
    if symmetric:
        v = np.nanmax(np.abs(values))
        vmin, vmax = -v, v
    pc = ax.tripcolor(tri, values, cmap=cmap, vmin=vmin, vmax=vmax,
                      shading=shading)
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.set_xlabel(f"$x$ [{device.length_units}]")
    ax.set_ylabel(f"$y$ [{device.length_units}]")
    cbar = fig.colorbar(pc, ax=ax)
    cbar.set_label(units_label)
    return fig, ax


def plot_currents(
    solution,
    dataset: Optional[str] = None,
    ax=None,
    units: Optional[str] = None,
    cmap: str = "inferno",
    colorbar: bool = True,
    auto_range_cutoff: Optional[float] = None,
    symmetric_color_scale: bool = False,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    streamplot: bool = True,
    min_stream_amp: float = 0.025,
    cross_section_coords=None,
    **kwargs,
):
    """Plot the sheet current density, optionally with streamlines."""
    import matplotlib.pyplot as plt

    device = solution.device
    units = units or f"{solution.current_units} / {device.length_units}"
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.get_figure()
    xgrid, ygrid, J = solution.grid_current_density(
        dataset=dataset, grid_shape=(200, 200), units=units,
        with_units=False,
    )
    Jx, Jy = J
    Jnorm = np.sqrt(Jx**2 + Jy**2)
    if vmin is None or vmax is None:
        if auto_range_cutoff:
            vmin, vmax = auto_range_iqr(Jnorm[np.isfinite(Jnorm)],
                                        auto_range_cutoff)
        else:
            vmin, vmax = float(np.nanmin(Jnorm)), float(np.nanmax(Jnorm))
    pc = ax.pcolormesh(xgrid, ygrid, Jnorm, cmap=cmap, vmin=vmin, vmax=vmax,
                       shading="auto")
    if streamplot:
        mask = Jnorm < (min_stream_amp * np.nanmax(Jnorm))
        Jx_m = np.where(mask, np.nan, Jx)
        Jy_m = np.where(mask, np.nan, Jy)
        ax.streamplot(xgrid, ygrid, Jx_m, Jy_m, color="w", linewidth=0.75,
                      density=1.2)
    ax.set_aspect("equal")
    ax.set_xlabel(f"$x$ [{device.length_units}]")
    ax.set_ylabel(f"$y$ [{device.length_units}]")
    if colorbar:
        cbar = fig.colorbar(pc, ax=ax)
        cbar.set_label(f"$|\\mathbf{{K}}|$ [{units}]")
    return fig, ax


def plot_order_parameter(
    solution,
    squared: bool = False,
    mag_cmap: str = "viridis",
    phase_cmap: str = "twilight_shifted",
    shading: str = "gouraud",
    figsize=None,
    **kwargs,
):
    """Plot |psi| (or |psi|^2) and arg(psi)."""
    import matplotlib.pyplot as plt

    psi = solution.tdgl_data.psi
    mag = np.abs(psi) ** 2 if squared else np.abs(psi)
    mag_label = "$|\\psi|^2$" if squared else "$|\\psi|$"
    fig, axes = plt.subplots(1, 2, figsize=figsize or (8, 3.5))
    _plot_scalar(solution, mag, mag_label, mag_label, ax=axes[0],
                 cmap=mag_cmap, vmin=0, vmax=1, shading=shading)
    _plot_scalar(solution, np.angle(psi), "$\\arg(\\psi)$",
                 "$\\arg(\\psi)$ [rad]", ax=axes[1], cmap=phase_cmap,
                 vmin=-np.pi, vmax=np.pi, shading=shading)
    fig.tight_layout()
    return fig, axes


def plot_vorticity(solution, ax=None, cmap: str = "coolwarm",
                   units: Optional[str] = None,
                   auto_range_cutoff: Optional[float] = None,
                   symmetric_color_scale: bool = True, vmin=None, vmax=None,
                   shading: str = "gouraud", **kwargs):
    """Plot the vorticity (curl of the sheet current)."""
    device = solution.device
    units = units or (
        f"{solution.current_units} / {device.length_units}**2"
    )
    vorticity = solution.vorticity.to(units).magnitude
    return _plot_scalar(
        solution, vorticity, "Vorticity",
        f"$(\\nabla\\times\\mathbf{{K}})\\cdot\\hat{{z}}$ [{units}]",
        ax=ax, cmap=cmap, vmin=vmin, vmax=vmax, shading=shading,
        symmetric=symmetric_color_scale,
    )


def plot_scalar_potential(solution, ax=None, cmap: str = "magma",
                          auto_range_cutoff=None, vmin=None, vmax=None,
                          shading: str = "gouraud", **kwargs):
    """Plot the electric scalar potential mu."""
    mu = solution.tdgl_data.mu
    mu = mu - np.nanmin(mu)
    return _plot_scalar(solution, mu, "Scalar potential",
                        "$\\mu/v_0$", ax=ax, cmap=cmap, vmin=vmin, vmax=vmax,
                        shading=shading)


def plot_field_at_positions(
    solution,
    positions: np.ndarray,
    zs: Union[float, np.ndarray, None] = None,
    vector: bool = False,
    units: Optional[str] = None,
    grid_shape=(200, 200),
    cmap: str = "cividis",
    colorbar: bool = True,
    auto_range_cutoff=None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = False,
    vmin=None,
    vmax=None,
    cross_section_coords=None,
    **kwargs,
):
    """Plot the Biot-Savart field from the device's currents at given
    positions (outside the film plane)."""
    import matplotlib.pyplot as plt
    from scipy.interpolate import griddata

    device = solution.device
    units = units or solution.field_units
    fields = solution.field_at_position(
        positions, zs=zs, vector=vector, units=units, with_units=False,
        return_sum=True,
    )
    fields = np.asarray(fields)
    if fields.ndim == 2:
        fields = fields[:, 2]  # z-component
    positions = np.atleast_2d(positions)[:, :2]
    if isinstance(grid_shape, int):
        grid_shape = (grid_shape, grid_shape)
    xs = np.linspace(positions[:, 0].min(), positions[:, 0].max(),
                     grid_shape[1])
    ys = np.linspace(positions[:, 1].min(), positions[:, 1].max(),
                     grid_shape[0])
    xgrid, ygrid = np.meshgrid(xs, ys)
    F = griddata(positions, fields, (xgrid, ygrid), method="linear")
    fig, ax = plt.subplots()
    if symmetric_color_scale and vmin is None:
        v = np.nanmax(np.abs(F))
        vmin, vmax = -v, v
    pc = ax.pcolormesh(xgrid, ygrid, F, cmap=cmap, vmin=vmin, vmax=vmax,
                       shading="auto")
    ax.set_aspect("equal")
    ax.set_xlabel(f"$x$ [{device.length_units}]")
    ax.set_ylabel(f"$y$ [{device.length_units}]")
    if colorbar:
        cbar = fig.colorbar(pc, ax=ax)
        cbar.set_label(f"$\\mu_0 H_z$ [{units}]")
    return fig, ax


def plot_current_through_paths(
    solution_path: str,
    paths,
    dataset: Optional[str] = None,
    interp_method: str = "linear",
    units: Optional[str] = None,
    progress_bar: bool = True,
    grid: bool = True,
    labels: bool = True,
    legend: bool = True,
    **kwargs,
):
    """Plot the current through one or more paths vs time."""
    import matplotlib.pyplot as plt

    from .data import get_current_through_paths

    times, currents = get_current_through_paths(
        solution_path, paths, dataset=dataset, interp_method=interp_method,
        units=units, with_units=False, progress_bar=progress_bar,
    )
    single = isinstance(currents, np.ndarray)
    if single:
        currents = [currents]
    fig, ax = plt.subplots()
    for i, current in enumerate(currents):
        ax.plot(times, current, label=f"Path {i}", **kwargs)
    ax.grid(grid)
    if labels:
        ax.set_xlabel("Time, $t$ [$\\tau_0$]")
        units_str = units or "current units"
        ax.set_ylabel(f"Current [{units_str}]")
    if legend and not single:
        ax.legend(loc=0)
    return fig, ax
