"""Device: the full problem specification (geometry + material + terminals).

API parity with the reference ``tdgl/device/device.py:49-915``: derived
physical scales (xi, lambda, Lambda, kappa, Bc2, A0, K0, tau0, V0), mesh
creation in dimensionless units (scaled by the coherence length), terminal
site/edge lookup, affine transforms, plotting, and HDF5 round trips.
"""

from __future__ import annotations

import logging
import numbers
import os
import time
from contextlib import contextmanager, nullcontext
from operator import attrgetter, itemgetter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from ..fv.mesh import Mesh
from ..fv.util import get_oriented_boundary
from ..utils.units import Quantity, ureg
from .layer import Layer
from .meshing import generate_mesh
from .polygon import Polygon

logger = logging.getLogger(__name__)


class TerminalInfo(NamedTuple):
    """Information about a single current terminal.

    Args:
        name: The terminal name.
        site_indices: Mesh site indices belonging to the terminal.
        edge_indices: Mesh edge indices belonging to the terminal.
        boundary_edge_indices: Indices into the *boundary edge list* for the
            terminal's edges.
        length: Total terminal length in physical units.
    """

    name: str
    site_indices: np.ndarray
    edge_indices: np.ndarray
    boundary_edge_indices: np.ndarray
    length: float


class Device:
    """A thin-film superconducting device.

    Args:
        name: Device name.
        layer: The superconducting :class:`Layer`.
        film: The film :class:`Polygon`.
        holes: Polygons representing holes in the film.
        terminals: Polygons marking current terminals; boundary mesh sites
            inside a terminal get current source/sink boundary conditions.
        probe_points: ``(n, 2)`` voltage-probe positions.
        length_units: Units of all coordinates.
    """

    ureg = ureg

    def __init__(
        self,
        name: str,
        *,
        layer: Layer,
        film: Polygon,
        holes: Optional[List[Polygon]] = None,
        terminals: Optional[List[Polygon]] = None,
        probe_points: Optional[Sequence[Tuple[float, float]]] = None,
        length_units: str = "um",
    ):
        self.name = name
        self.layer = layer
        self.film = film
        self.holes = list(holes or [])
        self.terminals = tuple(terminals or [])
        names = set()
        for terminal in self.terminals:
            terminal.mesh = False
            if terminal.name is None or terminal.name in names:
                raise ValueError("All terminals must have a unique name.")
            names.add(terminal.name)
        for polygon in [self.film] + self.holes:
            if not polygon.is_valid:
                raise ValueError(f"Invalid polygon: {polygon!r}")
        if len(self.holes) != len({h.name for h in self.holes}):
            raise ValueError("All holes must have a unique name.")
        if probe_points is not None:
            probe_points = np.asarray(probe_points).squeeze()
            if probe_points.ndim != 2 or probe_points.shape[1] != 2:
                raise ValueError(
                    f"Probe points must have shape (n, 2); got"
                    f" {probe_points.shape}"
                )
            if not self.contains_points(probe_points).all():
                raise ValueError("All probe points must lie within the film.")
        self.probe_points = probe_points
        self._length_units = length_units
        self.mesh: Optional[Mesh] = None
        self._triangulation = None

    # -- units & scales ------------------------------------------------------
    @property
    def length_units(self) -> str:
        """Length units of the device geometry."""
        return self._length_units

    @property
    def coherence_length(self) -> Quantity:
        """GL coherence length :math:`\\xi`."""
        return self.layer.coherence_length * ureg(self.length_units)

    @property
    def london_lambda(self) -> Quantity:
        """London penetration depth :math:`\\lambda`."""
        return self.layer.london_lambda * ureg(self.length_units)

    @property
    def thickness(self) -> Quantity:
        """Film thickness :math:`d`."""
        return self.layer.thickness * ureg(self.length_units)

    @property
    def Lambda(self) -> Quantity:
        """Effective magnetic penetration depth :math:`\\Lambda=\\lambda^2/d`."""
        return self.london_lambda**2 / self.thickness

    @property
    def conductivity(self) -> Optional[Quantity]:
        """Normal-state conductivity :math:`\\sigma`."""
        if self.layer.conductivity is None:
            return None
        return self.layer.conductivity * ureg(f"siemens / {self.length_units}")

    @property
    def kappa(self) -> float:
        """GL parameter :math:`\\kappa=\\lambda/\\xi`."""
        return float(
            (self.london_lambda / self.coherence_length).to_base_units().magnitude
        )

    @property
    def Bc2(self) -> Quantity:
        """Upper critical field :math:`B_{c2}=\\Phi_0/(2\\pi\\xi^2)`."""
        return (
            ureg("Phi_0") / (2 * np.pi * self.coherence_length**2)
        ).to_base_units()

    @property
    def A0(self) -> Quantity:
        """Vector potential scale :math:`A_0=\\xi B_{c2}`."""
        return (self.Bc2 * self.coherence_length).to_base_units()

    @property
    def K0(self) -> Quantity:
        """Sheet current density scale
        :math:`K_0=4\\xi B_{c2}/(\\mu_0\\Lambda)`."""
        return (
            4 * self.coherence_length * self.Bc2 / (ureg("mu_0") * self.Lambda)
        ).to_base_units()

    def tau0(self, conductivity: Optional[Quantity] = None) -> Quantity:
        """Time scale :math:`\\tau_0=\\mu_0\\sigma\\lambda^2`."""
        conductivity = conductivity or self.conductivity
        if conductivity is None:
            raise ValueError(
                "tau0 requires the normal-state conductivity to be defined."
            )
        return (ureg("mu_0") * conductivity * self.london_lambda**2).to("seconds")

    def V0(self, conductivity: Optional[Quantity] = None) -> Quantity:
        """Voltage scale :math:`V_0=\\xi J_0/\\sigma`."""
        conductivity = conductivity or self.conductivity
        if conductivity is None:
            raise ValueError(
                "V0 requires the normal-state conductivity to be defined."
            )
        J0 = self.K0 / self.thickness
        return (self.coherence_length * J0 / conductivity).to("volts")

    # -- mesh-derived quantities ----------------------------------------------
    @property
    def triangulation(self):
        """Matplotlib triangulation of the mesh (in ``length_units``)."""
        if self.mesh is None:
            return None
        if self._triangulation is None:
            from matplotlib.tri import Triangulation

            sites = self.points
            self._triangulation = Triangulation(
                sites[:, 0], sites[:, 1], self.mesh.elements
            )
        return self._triangulation

    @property
    def polygons(self) -> Tuple[Polygon, ...]:
        """All polygons of the device: film, holes, terminals."""
        return (self.film,) + tuple(self.holes) + self.terminals

    @property
    def points(self) -> Optional[np.ndarray]:
        """Mesh site coordinates in ``length_units``."""
        if self.mesh is None:
            return None
        return self.mesh.sites * self.layer.coherence_length

    @property
    def triangles(self) -> Optional[np.ndarray]:
        """Mesh triangle indices."""
        return None if self.mesh is None else self.mesh.elements

    @property
    def edges(self) -> Optional[np.ndarray]:
        """Mesh edge site-index pairs."""
        return None if self.mesh is None else self.mesh.edge_mesh.edges

    @property
    def edge_lengths(self) -> Optional[np.ndarray]:
        """Edge lengths in ``length_units``."""
        if self.mesh is None:
            return None
        return self.mesh.edge_mesh.edge_lengths * self.layer.coherence_length

    @property
    def areas(self) -> Optional[np.ndarray]:
        """Voronoi site areas in ``length_units**2``."""
        if self.mesh is None:
            return None
        return self.mesh.areas * self.layer.coherence_length**2

    @property
    def probe_point_indices(self) -> Optional[List[int]]:
        """Mesh site indices closest to the probe points."""
        if self.mesh is None or self.probe_points is None:
            return None
        xi = self.layer.coherence_length
        return [self.mesh.closest_site(xy) for xy in self.probe_points / xi]

    def terminal_info(self) -> Tuple[TerminalInfo, ...]:
        """Terminal site/edge membership info, sorted by terminal length."""
        mesh = self.mesh
        xi = self.layer.coherence_length
        sites = self.points
        edge_centers = xi * mesh.edge_mesh.centers
        ix_boundary = mesh.edge_mesh.boundary_edge_indices
        boundary_edge_lengths = self.edge_lengths[ix_boundary]
        boundary_edge_centers = edge_centers[ix_boundary]
        info = []
        for terminal in self.terminals:
            site_ix = np.intersect1d(
                terminal.contains_points(sites, index=True),
                mesh.boundary_indices,
            )
            edge_ix = np.intersect1d(
                terminal.contains_points(edge_centers, index=True), ix_boundary
            )
            b_edge_ix = terminal.contains_points(boundary_edge_centers,
                                                 index=True)
            length = float(boundary_edge_lengths[b_edge_ix].sum())
            info.append(
                TerminalInfo(terminal.name, site_ix, edge_ix, b_edge_ix, length)
            )
        return tuple(sorted(info, key=attrgetter("length")))

    def boundary_sites(self) -> Optional[Dict[str, np.ndarray]]:
        """Site indices on the boundary of the film and each hole, ordered
        counterclockwise, as ``{polygon_name: indices}``."""
        if self.mesh is None:
            return None
        points = self.points
        edge_mesh = self.mesh.edge_mesh
        boundary_edges = edge_mesh.edges[edge_mesh.boundary_edge_indices]
        loops = get_oriented_boundary(points, boundary_edges)
        result = {}
        for polygon in [self.film] + list(self.holes):
            best, best_frac = None, 0.0
            for loop in loops:
                on = polygon.on_boundary(
                    points[loop], radius=1e-6 * max(polygon.extents)
                    + 0.51 * float(np.max(self.edge_lengths))
                )
                frac = float(np.mean(on))
                if frac > best_frac:
                    best, best_frac = loop, frac
            result[polygon.name] = best
        return result

    def contains_points(
        self, points: np.ndarray, index: bool = False, radius: float = 0
    ) -> np.ndarray:
        """Whether points lie inside the film and outside all holes."""
        points = np.atleast_2d(np.asarray(points, dtype=float))
        mask = self.film.contains_points(points, radius=radius)
        for hole in self.holes:
            mask &= ~hole.contains_points(points, radius=-radius)
        if index:
            return np.where(mask)[0]
        return mask

    # -- transforms ------------------------------------------------------------
    def copy(self, with_mesh: bool = True) -> "Device":
        """Copy the device (optionally sharing its mesh)."""
        device = Device(
            self.name,
            layer=self.layer.copy(),
            film=self.film.copy(),
            holes=[h.copy() for h in self.holes],
            terminals=[t.copy() for t in self.terminals],
            probe_points=None if self.probe_points is None
            else self.probe_points.copy(),
            length_units=self.length_units,
        )
        if with_mesh and self.mesh is not None:
            device.mesh = self.mesh
        return device

    def _transformed(self, polygon_func, point_func) -> "Device":
        if self.mesh is not None:
            logger.warning(
                "Transforming a meshed device returns a new device without a"
                " mesh; call make_mesh() on the result."
            )
        new = self.copy(with_mesh=False)
        for polygon in new.polygons:
            polygon_func(polygon)
        if new.probe_points is not None:
            new.probe_points = point_func(np.asarray(new.probe_points, float))
        return new

    def translate(self, dx: float = 0, dy: float = 0, dz: float = 0,
                  inplace: bool = False) -> "Device":
        """Translate the device by ``(dx, dy)`` (and the layer by ``dz``).

        With ``inplace=False`` (default) returns a translated copy without
        a mesh (call ``make_mesh()`` on it). With ``inplace=True`` the
        device — including an existing mesh, which a translation shifts
        exactly (an isometry: areas/lengths are unchanged) — is modified
        and returned, matching the reference
        (``tdgl/device/device.py:468-504``).
        """
        if not inplace:
            new = self._transformed(
                lambda p: p.translate(dx, dy),
                lambda pts: pts + np.array([dx, dy]),
            )
            if dz:
                new.layer.z0 += dz
            return new
        for polygon in self.polygons:
            polygon.translate(dx, dy)
        if self.probe_points is not None:
            self.probe_points = (
                np.asarray(self.probe_points, dtype=float)
                + np.array([dx, dy])
            )
        if dz:
            self.layer.z0 += dz
        if self.mesh is not None:
            xi = self.layer.coherence_length
            self.mesh.translate_in_place(np.array([dx, dy]) / xi)
        return self

    @contextmanager
    def translation(self, dx: float, dy: float, dz: float = 0):
        """Context manager that temporarily translates the device
        in-place, then returns it to its original position (reference
        parity: ``tdgl/device/device.py:505-521``)."""
        try:
            self.translate(dx, dy, dz=dz, inplace=True)
            yield
        finally:
            self.translate(-dx, -dy, dz=-dz, inplace=True)

    def rotate(self, degrees: float,
               origin: Tuple[float, float] = (0, 0)) -> "Device":
        """Return a copy rotated CCW by ``degrees`` about ``origin``."""
        from ..geometry import rotate as rotate_coords

        origin_arr = np.asarray(origin, dtype=float)
        return self._transformed(
            lambda p: p.rotate(degrees, origin=origin),
            lambda pts: rotate_coords(pts - origin_arr, degrees) + origin_arr,
        )

    def scale(self, xfact: float = 1, yfact: float = 1,
              origin: Tuple[float, float] = (0, 0)) -> "Device":
        """Return a copy scaled about ``origin``."""
        if not (
            isinstance(origin, tuple)
            and len(origin) == 2
            and all(isinstance(v, numbers.Real) for v in origin)
        ):
            raise TypeError("origin must be a tuple of floats (x, y).")
        origin_arr = np.asarray(origin, dtype=float)
        factors = np.array([xfact, yfact], dtype=float)
        return self._transformed(
            lambda p: p.scale(xfact=xfact, yfact=yfact, origin=origin),
            lambda pts: (pts - origin_arr) * factors + origin_arr,
        )

    # -- meshing ---------------------------------------------------------------
    def make_mesh(
        self,
        max_edge_length: Optional[float] = None,
        min_points: Optional[int] = None,
        smooth: int = 0,
        structured: bool = False,
        cut_cells: bool = True,
        **mesh_kwargs,
    ) -> None:
        """Generate the dimensionless FV mesh for the device.

        Args:
            max_edge_length: Max edge length in ``length_units``
                (default: 1.0 * coherence_length).
            min_points: Minimum number of mesh sites.
            smooth: Laplacian smoothing iterations (unstructured meshes
                only; a structured lattice must stay exact).
            structured: Mesh on a clipped triangular lattice instead of an
                unstructured Delaunay mesh. Structured meshes map every
                finite-volume operator onto dense array stencils — the fast
                (gather-free) TPU solver path. The film boundary becomes a
                lattice staircase; with ``cut_cells`` (default) the
                finite-volume weights are corrected to the true polygon
                boundary, restoring boundary accuracy comparable to a
                boundary-conforming mesh. Prefer structured meshes for
                performance; the unstructured mesher remains for
                boundary-conforming needs.
            cut_cells: Structured meshes only — replace the staircase
                boundary cells' Voronoi areas and dual-edge lengths with
                their values clipped against the true film polygon
                (:mod:`tdgl_tpu.device.cutcell`). Set False for the raw
                staircase discretization.
        """
        logger.info("Generating mesh...")
        t0 = time.perf_counter()
        if max_edge_length is None:
            max_edge_length = 1.0 * self.layer.coherence_length
        if structured:
            if mesh_kwargs:
                raise ValueError(
                    "make_mesh(structured=True) accepts only"
                    " max_edge_length and min_points; unstructured-mesher"
                    f" options {sorted(mesh_kwargs)} are not applicable to"
                    " the lattice mesher."
                )
            if smooth:
                raise ValueError(
                    "make_mesh(structured=True) does not support `smooth`:"
                    " a structured lattice must stay exact."
                )
            from .hexmesh import generate_structured_mesh

            points, triangles, grid = generate_structured_mesh(
                self.film.points,
                hole_coords=[hole.points for hole in self.holes],
                min_points=min_points,
                max_edge_length=max_edge_length,
            )
            self._create_dimensionless_mesh(points, triangles)
            self._attach_grid(grid)
            if cut_cells:
                from .cutcell import apply_cut_cell_corrections

                xi = self.layer.coherence_length
                apply_cut_cell_corrections(
                    self.mesh,
                    np.asarray(self.film.points) / xi,
                    [np.asarray(hole.points) / xi for hole in self.holes],
                )
        else:
            points, triangles = generate_mesh(
                self.film.points,
                hole_coords=[hole.points for hole in self.holes],
                min_points=min_points,
                max_edge_length=max_edge_length,
                **mesh_kwargs,
            )
            if smooth:
                mesh = Mesh.from_triangulation(
                    points, triangles, create_submesh=False
                ).smooth(smooth, create_submesh=False)
                points, triangles = mesh.sites, mesh.elements
            self._create_dimensionless_mesh(points, triangles)
        logger.info(
            "Generated mesh with %d sites and %d elements in %.3f s",
            len(points), len(triangles), time.perf_counter() - t0,
        )
        self._validate_terminals_on_mesh(structured=structured)

    def _validate_terminals_on_mesh(self, structured: bool) -> None:
        """Fail LOUDLY at mesh time when a terminal polygon did not map
        cleanly onto the generated mesh boundary.

        On a structured lattice the film boundary is a staircase of the
        lattice spacing ``h``: a terminal polygon narrower than ~``h``
        can capture no boundary sites at all, and two nearby terminals
        can staircase into the *same* boundary sites. Both were silent
        failure modes before (the solver only caught the empty case, at
        construction time, with no explanation).
        """
        if not self.terminals or self.mesh is None:
            return
        spacing = None
        if self.mesh.grid is not None:
            spacing = self.mesh.grid.spacing * self.layer.coherence_length
        hint = (
            (f" On a structured mesh the boundary is a staircase of the"
             f" lattice spacing (h = {spacing:.3g} {self.length_units});"
             " terminal polygons must be wider than one lattice spacing"
             " to reliably capture boundary sites. Widen the terminal,"
             " use a finer mesh (larger min_points / smaller"
             " max_edge_length), or mesh with structured=False.")
            if structured else ""
        )
        infos = self.terminal_info()
        for info in infos:
            if len(info.site_indices) == 0 or info.length == 0:
                raise ValueError(
                    f"Terminal {info.name!r} contains no boundary mesh"
                    f" sites/edges of the generated mesh.{hint}"
                )
        for i, a in enumerate(infos):
            for b in infos[i + 1:]:
                shared = np.intersect1d(a.site_indices, b.site_indices)
                if len(shared):
                    raise ValueError(
                        f"Terminals {a.name!r} and {b.name!r} overlap on"
                        f" {len(shared)} boundary mesh site(s) of the"
                        f" generated mesh.{hint}"
                    )

    def _attach_grid(self, grid) -> None:
        """Attach (dimensionless) grid metadata to the mesh."""
        from .hexmesh import HexGrid

        xi = self.layer.coherence_length
        self.mesh.grid = HexGrid(
            rows=grid.rows, cols=grid.cols,
            spacing=grid.spacing / xi,
            origin=(grid.origin[0] / xi, grid.origin[1] / xi),
            site_rc=grid.site_rc,
            grid_site=grid.grid_site,
        ).with_edges(self.mesh.edge_mesh.edges)

    def _create_dimensionless_mesh(
        self, points: np.ndarray, triangles: np.ndarray
    ) -> None:
        self.mesh = Mesh.from_triangulation(
            points / self.layer.coherence_length, triangles, create_submesh=True
        )
        self._triangulation = None
        # The finite-volume discretization is only well-posed if every
        # Voronoi cell has positive area (degenerate/inverted triangles
        # violate this and make the solver diverge, not just lose accuracy).
        min_area = float(self.mesh.areas.min())
        if min_area <= 0:
            raise ValueError(
                f"Mesh generation produced a non-positive Voronoi cell area"
                f" ({min_area:.3e}). Try different meshing parameters"
                " (e.g. fewer smoothing iterations, a different"
                " max_edge_length, or Polygon.resample() on the film)."
            )

    def mesh_stats_dict(self) -> Dict[str, Union[float, int, str, None]]:
        """Summary statistics of the mesh."""
        edge_lengths = self.edge_lengths
        areas = self.areas

        def stat(arr, fn):
            return None if arr is None else float(fn(arr))

        return dict(
            num_sites=None if self.mesh is None else len(self.mesh.sites),
            num_elements=None if self.mesh is None else len(self.mesh.elements),
            min_edge_length=stat(edge_lengths, np.min),
            max_edge_length=stat(edge_lengths, np.max),
            mean_edge_length=stat(edge_lengths, np.mean),
            min_area=stat(areas, np.min),
            max_area=stat(areas, np.max),
            mean_area=stat(areas, np.mean),
            coherence_length=float(self.layer.coherence_length),
            length_units=self.length_units,
        )

    def mesh_stats(self, precision: int = 3) -> str:
        """An HTML table of mesh statistics (for notebooks)."""
        rows = ["<table>", "<tr><b>Mesh Statistics</b></tr>"]
        for key, value in self.mesh_stats_dict().items():
            if isinstance(value, float):
                value = f"{value:.{precision}e}"
            rows.append(f"<tr><td><b>{key}</b></td><td>{value}</td></tr>")
        rows.append("</table>")
        html = "".join(rows)
        try:
            from IPython.display import HTML

            return HTML(html)
        except ImportError:
            return html

    # -- plotting ----------------------------------------------------------------
    @property
    def patches(self) -> Dict[str, "object"]:
        """``{polygon_name: matplotlib PathPatch}`` for visualizing the
        device, with hole interiors cut out of their enclosing polygons
        (reference parity: ``tdgl/device/device.py:684-708``)."""
        from matplotlib.patches import PathPatch
        from matplotlib.path import Path

        hole_names = {hole.name for hole in self.holes}
        patches = {}
        for polygon in self.polygons:
            if polygon.name in hole_names:
                continue
            # Close each ring explicitly: CLOSEPOLY's vertex is a
            # placeholder, so it must land on a repeated first vertex, not
            # on a real one.
            ring = polygon.points.tolist()
            coords = ring + ring[:1]
            codes = [Path.LINETO] * len(coords)
            codes[0] = Path.MOVETO
            codes[-1] = Path.CLOSEPOLY
            for hole in self.holes:
                if polygon.contains_points(hole.points).all():
                    # CW sub-path cuts the hole out of the CCW outer ring.
                    hole_ring = hole.points.tolist()[::-1]
                    hole_coords = hole_ring + hole_ring[:1]
                    hole_codes = [Path.LINETO] * len(hole_coords)
                    hole_codes[0] = Path.MOVETO
                    hole_codes[-1] = Path.CLOSEPOLY
                    coords.extend(hole_coords)
                    codes.extend(hole_codes)
            patches[polygon.name] = PathPatch(Path(coords, codes))
        return patches

    def plot(self, ax=None, legend: bool = True, figsize=None,
             mesh: bool = False, mesh_kwargs=None, **kwargs):
        """Plot the device geometry (and optionally the mesh)."""
        import matplotlib.pyplot as plt

        if ax is None:
            fig, ax = plt.subplots(figsize=figsize)
        else:
            fig = ax.get_figure()
        ax.set_aspect("equal")
        for polygon in self.polygons:
            polygon.plot(ax=ax, **kwargs)
        if mesh and self.mesh is not None:
            pts = self.points
            ax.triplot(pts[:, 0], pts[:, 1], self.mesh.elements,
                       **(mesh_kwargs or dict(color="k", lw=0.3)))
        if self.probe_points is not None:
            ax.plot(*np.asarray(self.probe_points).T, "ko",
                    label="Probe points")
        if legend:
            ax.legend(bbox_to_anchor=(1, 1), loc="upper left")
        ax.set_xlabel(f"x [{self.length_units}]")
        ax.set_ylabel(f"y [{self.length_units}]")
        return fig, ax

    def draw(self, *args, **kwargs):
        """Alias of :meth:`plot`."""
        return self.plot(*args, **kwargs)

    # -- serialization -------------------------------------------------------------
    def to_hdf5(
        self,
        path_or_group: Union[str, h5py.File, h5py.Group],
        save_mesh: bool = True,
    ) -> None:
        """Save the device; same schema as the reference
        (``tdgl/device/device.py:772-810``)."""
        if isinstance(path_or_group, str):
            path = path_or_group
            if not path.endswith(".h5"):
                path += ".h5"
            if os.path.exists(path):
                raise IOError(f"Path already exists: {path}")
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            import h5py

            context = h5py.File(path, "x")
        else:
            context = nullcontext(path_or_group)
        with context as f:
            f.attrs["name"] = self.name
            f.attrs["length_units"] = self.length_units
            self.layer.to_hdf5(f.create_group("layer"))
            self.film.to_hdf5(f.create_group("film"))
            for terminal in self.terminals:
                grp = f.require_group("terminals")
                terminal.to_hdf5(grp.create_group(terminal.name))
            if self.probe_points is not None:
                f["probe_points"] = self.probe_points
            for hole in sorted(self.holes, key=attrgetter("name")):
                grp = f.require_group("holes")
                hole.to_hdf5(grp.create_group(hole.name))
            if save_mesh and self.mesh is not None:
                self.mesh.to_hdf5(f.create_group("mesh"))

    @classmethod
    def from_hdf5(
        cls, path_or_group: Union[str, h5py.File, h5py.Group]
    ) -> "Device":
        """Load a device saved with :meth:`to_hdf5`."""
        if isinstance(path_or_group, str):
            import h5py

            context = h5py.File(path_or_group, "r")
        else:
            context = nullcontext(path_or_group)
        terminals = holes = probe_points = mesh = None
        with context as f:
            name = f.attrs["name"]
            length_units = f.attrs["length_units"]
            layer = Layer.from_hdf5(f["layer"])
            film = Polygon.from_hdf5(f["film"])
            if "terminals" in f:
                terminals = [Polygon.from_hdf5(g) for g in f["terminals"].values()]
            if "holes" in f:
                holes = [
                    Polygon.from_hdf5(g)
                    for _, g in sorted(f["holes"].items(), key=itemgetter(0))
                ]
            if "probe_points" in f:
                probe_points = np.array(f["probe_points"])
            if "mesh" in f:
                mesh = Mesh.from_hdf5(f["mesh"])
        device = Device(
            name,
            layer=layer,
            film=film,
            holes=holes,
            terminals=terminals,
            probe_points=probe_points,
            length_units=length_units,
        )
        if mesh is not None:
            device.mesh = mesh
        return device

    def __repr__(self) -> str:
        return (
            f"Device({self.name!r}, layer={self.layer!r}, film={self.film!r},"
            f" holes={self.holes!r}, terminals={self.terminals!r},"
            f" probe_points={self.probe_points!r},"
            f" length_units={self.length_units!r})"
        )

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, Device):
            return False
        by_name = attrgetter("name")
        if (self.probe_points is None) != (other.probe_points is None):
            same_probes = False
        elif self.probe_points is None:
            same_probes = True
        else:
            same_probes = np.allclose(self.probe_points, other.probe_points)
        return (
            self.name == other.name
            and self.layer == other.layer
            and self.film == other.film
            and sorted(self.holes, key=by_name) == sorted(other.holes, key=by_name)
            and sorted(self.terminals, key=by_name)
            == sorted(other.terminals, key=by_name)
            and same_probes
            and self.length_units == other.length_units
        )
