"""Triangular mesh with Voronoi dual for the finite-volume method.

API and HDF5-schema parity with the reference ``tdgl/finite_volume/mesh.py:24-423``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils import h5lite
from .edge_mesh import EdgeMesh
from .util import (
    build_voronoi_polygons,
    circumcenters,
    get_edges,
    triangle_areas,
    voronoi_site_areas,
)


class Mesh:
    """A triangular mesh of a simply- or multiply-connected polygon.

    Use :meth:`Mesh.from_triangulation` to construct one from raw
    sites/elements.

    Args:
        sites: ``(n, 2)`` vertex coordinates.
        elements: ``(m, 3)`` triangle indices.
        boundary_indices: Site indices on the boundary.
        areas: ``(n,)`` Voronoi cell area per site.
        dual_sites: ``(m, 2)`` circumcenters (Voronoi vertices).
        edge_mesh: The edge-centric view.
        voronoi_polygons: Per-site Voronoi cell vertex arrays (for plotting).
    """

    def __init__(
        self,
        sites: Sequence[Tuple[float, float]],
        elements: Sequence[Tuple[int, int, int]],
        boundary_indices: Sequence[int],
        areas: Optional[np.ndarray] = None,
        dual_sites: Optional[np.ndarray] = None,
        edge_mesh: Optional[EdgeMesh] = None,
        voronoi_polygons: Optional[List[np.ndarray]] = None,
    ):
        self.sites = np.asarray(sites).squeeze()
        self.elements = np.asarray(elements, dtype=np.int64)
        self.boundary_indices = np.asarray(boundary_indices, dtype=np.int64)
        self.areas = None if areas is None else np.asarray(areas)
        self.dual_sites = None if dual_sites is None else np.asarray(dual_sites)
        self.edge_mesh = edge_mesh
        self._voronoi_polygons = voronoi_polygons
        self._center_of_mass: Optional[Tuple[float, float]] = None
        # Structured-lattice layout (tdgl_tpu.device.hexmesh.HexGrid), set
        # when the mesh was generated with Device.make_mesh(structured=True).
        # Enables the gather-free stencil solver path.
        self.grid = None

    @property
    def voronoi_polygons(self) -> Optional[List[np.ndarray]]:
        """Per-site Voronoi cell vertex arrays (computed lazily: only
        plotting and full HDF5 serialization need them)."""
        if self._voronoi_polygons is None and self.edge_mesh is not None:
            self._voronoi_polygons = build_voronoi_polygons(
                self.sites, self.elements, self.dual_sites,
                self.edge_mesh.edges, self.edge_mesh.boundary_edge_indices,
                self.boundary_indices,
            )
        return self._voronoi_polygons

    @voronoi_polygons.setter
    def voronoi_polygons(self, value) -> None:
        self._voronoi_polygons = value

    @property
    def x(self) -> np.ndarray:
        """x-coordinates of the mesh sites."""
        return self.sites[:, 0]

    @property
    def y(self) -> np.ndarray:
        """y-coordinates of the mesh sites."""
        return self.sites[:, 1]

    @property
    def center_of_mass(self) -> Tuple[float, float]:
        """Area-weighted center of mass of the mesh."""
        if self._center_of_mass is None:
            tri_areas = np.abs(triangle_areas(self.sites, self.elements))
            centroids = self.sites[self.elements].mean(axis=1)
            self._center_of_mass = tuple(
                np.average(centroids, axis=0, weights=tri_areas)
            )
        return self._center_of_mass

    def closest_site(self, xy: Tuple[float, float]) -> int:
        """Index of the site closest to ``(x, y)``."""
        return int(
            np.argmin(np.linalg.norm(self.sites - np.atleast_2d(xy), axis=1))
        )

    def translate_in_place(self, offset) -> "Mesh":
        """Shift every stored coordinate by ``offset`` (a 2-vector).

        A translation is an isometry: areas, edge lengths, directions, and
        dual-edge lengths are unchanged; only positions (sites, dual
        sites, edge centers, Voronoi cell vertices, structured-grid
        origin) move.
        """
        offset = np.asarray(offset, dtype=float).reshape(1, 2)
        self.sites = self.sites + offset
        if self.dual_sites is not None:
            self.dual_sites = self.dual_sites + offset
        if self.edge_mesh is not None:
            self.edge_mesh.centers = self.edge_mesh.centers + offset
        if self._voronoi_polygons is not None:
            self._voronoi_polygons = [
                p + offset for p in self._voronoi_polygons
            ]
        self._center_of_mass = None
        if self.grid is not None:
            import dataclasses

            self.grid = dataclasses.replace(
                self.grid,
                origin=(
                    self.grid.origin[0] + float(offset[0, 0]),
                    self.grid.origin[1] + float(offset[0, 1]),
                ),
            )
        return self

    @staticmethod
    def compute_voronoi_areas_polygons(
        sites: np.ndarray,
        elements: np.ndarray,
        dual_sites: np.ndarray,
        edge_mesh,
        boundary_indices: np.ndarray,
    ):
        """Voronoi cell areas and CCW cell vertices for each site
        (reference parity: ``tdgl/finite_volume/mesh.py:168-201``)."""
        areas = voronoi_site_areas(sites, elements, dual_sites)
        polygons = build_voronoi_polygons(
            sites, elements, dual_sites, edge_mesh.edges,
            edge_mesh.boundary_edge_indices, np.asarray(boundary_indices),
        )
        return areas, polygons

    @staticmethod
    def from_triangulation(
        sites: np.ndarray,
        elements: np.ndarray,
        create_submesh: bool = True,
    ) -> "Mesh":
        """Construct a full FV mesh (edges, Voronoi dual, site areas) from a
        triangulation."""
        sites = np.asarray(sites).squeeze()
        elements = np.asarray(elements).squeeze()
        if sites.ndim != 2 or sites.shape[1] != 2:
            raise ValueError(f"sites must have shape (n, 2); got {sites.shape}")
        if elements.ndim != 2 or elements.shape[1] != 3:
            raise ValueError(
                f"elements must have shape (m, 3); got {elements.shape}"
            )
        boundary_indices = Mesh.find_boundary_indices(elements)
        areas = dual_sites = edge_mesh = polygons = None
        if create_submesh:
            dual_sites = circumcenters(sites, elements)
            edge_mesh = EdgeMesh.from_mesh(sites, elements, dual_sites)
            areas = voronoi_site_areas(sites, elements, dual_sites)
            # Voronoi cell polygons are built lazily on first access.
        return Mesh(
            sites=sites,
            elements=elements,
            boundary_indices=boundary_indices,
            areas=areas,
            dual_sites=dual_sites,
            edge_mesh=edge_mesh,
            voronoi_polygons=polygons,
        )

    @staticmethod
    def find_boundary_indices(elements: np.ndarray) -> np.ndarray:
        """Site indices on the mesh boundary (edges with multiplicity 1)."""
        edges, is_boundary = get_edges(elements)
        return np.unique(edges[is_boundary])

    def get_quantity_on_site(
        self,
        quantity_on_edge: np.ndarray,
        vector: bool = True,
        **_,
    ) -> np.ndarray:
        """Average an edge quantity onto the sites.

        For a vector quantity given as its flow along each edge, returns the
        shape ``(n, 2)`` vector at each site; for a scalar, shape ``(n,)``.
        Matches the reference's edge-to-site averaging
        (``tdgl/finite_volume/mesh.py:203-243``).
        """
        edge_mesh = self.edge_mesh
        directions = edge_mesh.normalized_directions
        edges = edge_mesh.edges
        if vector:
            flux_x = quantity_on_edge * directions[:, 0]
            flux_y = quantity_on_edge * directions[:, 1]
        else:
            flux_x = flux_y = quantity_on_edge
        sites = np.concatenate([edges[:, 0], edges[:, 1]])
        counts = np.bincount(sites, minlength=len(self.sites))
        sum_x = np.bincount(sites, weights=np.concatenate([flux_x, flux_x]),
                            minlength=len(self.sites))
        sum_y = np.bincount(sites, weights=np.concatenate([flux_y, flux_y]),
                            minlength=len(self.sites))
        result = np.stack([sum_x, sum_y], axis=1) / (
            2 * np.maximum(counts, 1)[:, None]
        )
        if vector:
            return result
        return result[:, 0]

    def smooth(self, iterations: int, create_submesh: bool = True) -> "Mesh":
        """Laplacian smoothing: move each interior vertex to the mean of its
        neighbors, ``iterations`` times."""
        elements = self.elements
        edges, _ = get_edges(elements)
        sites = self.sites.copy()
        n = len(sites)
        boundary = self.boundary_indices
        i = np.concatenate([edges[:, 0], edges[:, 1]])
        j = np.concatenate([edges[:, 1], edges[:, 0]])
        counts = np.bincount(i, minlength=n).astype(float)
        for _ in range(iterations):
            sums = np.zeros((n, 2))
            np.add.at(sums, i, sites[j])
            new_sites = sums / counts[:, None]
            new_sites[boundary] = sites[boundary]
            sites = new_sites
        return Mesh.from_triangulation(sites, elements,
                                       create_submesh=create_submesh)

    def plot(
        self,
        ax=None,
        show_sites: bool = True,
        show_edges: bool = False,
        show_dual_edges: bool = True,
        show_voronoi_centroids: bool = False,
        site_color=None,
        edge_color="k",
        centroid_color=None,
        dual_edge_color="k",
        linewidth: float = 0.75,
        linestyle: str = "-",
        marker: str = ".",
    ):
        """Plot the mesh (and optionally its Voronoi dual)."""
        import matplotlib.pyplot as plt

        from ..geometry import close_curve
        from .util import convex_polygon_centroid

        if ax is None:
            _, ax = plt.subplots()
        ax.set_aspect("equal")
        x, y = self.sites.T
        if show_edges:
            ax.triplot(x, y, self.elements, color=edge_color, ls=linestyle,
                       lw=linewidth)
        if show_dual_edges and self.voronoi_polygons is not None:
            for poly in self.voronoi_polygons:
                ax.plot(*close_curve(poly).T, color=dual_edge_color,
                        ls=linestyle, lw=linewidth)
        if show_sites:
            ax.plot(x, y, marker=marker, ls="", color=site_color)
        if show_voronoi_centroids and self.voronoi_polygons is not None:
            centroids = np.array(
                [convex_polygon_centroid(p) for p in self.voronoi_polygons]
            )
            ax.plot(*centroids.T, marker=marker, ls="", color=centroid_color)
        return ax

    def to_hdf5(self, h5group: h5lite.Group, compress: bool = False) -> None:
        """Save the mesh; same schema as the reference
        (``tdgl/finite_volume/mesh.py:345-368``)."""
        h5group["sites"] = self.sites
        h5group["elements"] = self.elements
        if not compress:
            h5group["boundary_indices"] = self.boundary_indices
            h5group["areas"] = self.areas
            self.edge_mesh.to_hdf5(h5group.create_group("edge_mesh"))
            if self.dual_sites is not None:
                h5group["dual_sites"] = self.dual_sites
            split_indices = np.cumsum(
                [len(p) for p in self.voronoi_polygons[:-1]]
            )
            h5group["voronoi_polygons_flat"] = np.concatenate(
                self.voronoi_polygons, axis=0
            )
            h5group["voronoi_split_indices"] = split_indices

    @staticmethod
    def is_restorable(h5group: h5lite.Group) -> bool:
        """Whether the group holds everything needed to restore without
        recomputation."""
        required = (
            "sites", "elements", "boundary_indices", "areas", "edge_mesh",
            "dual_sites", "voronoi_polygons_flat", "voronoi_split_indices",
        )
        return all(key in h5group for key in required)

    @staticmethod
    def from_hdf5(h5group: h5lite.Group) -> "Mesh":
        """Load a mesh from HDF5, recomputing the dual if necessary."""
        if not ("sites" in h5group and "elements" in h5group):
            raise IOError("Cannot load mesh: missing sites/elements.")
        if Mesh.is_restorable(h5group):
            flat = np.array(h5group["voronoi_polygons_flat"])
            splits = np.array(h5group["voronoi_split_indices"])
            return Mesh(
                sites=np.array(h5group["sites"]),
                elements=np.array(h5group["elements"], dtype=np.int64),
                boundary_indices=np.array(h5group["boundary_indices"],
                                          dtype=np.int64),
                areas=np.array(h5group["areas"]),
                dual_sites=np.array(h5group["dual_sites"]),
                edge_mesh=EdgeMesh.from_hdf5(h5group["edge_mesh"]),
                voronoi_polygons=np.split(flat, splits),
            )
        return Mesh.from_triangulation(
            np.array(h5group["sites"]).squeeze(),
            np.array(h5group["elements"]),
        )
