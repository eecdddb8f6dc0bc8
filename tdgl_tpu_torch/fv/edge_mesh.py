"""Edge-centric view of a triangular mesh.

API parity with the reference ``tdgl/finite_volume/edge_mesh.py:9-133``.
"""

from __future__ import annotations

import numpy as np

from ..utils import h5lite
from .util import get_dual_edge_lengths, get_edges


class EdgeMesh:
    """Mesh edges with centers, directions, lengths, and dual-edge lengths.

    Args:
        centers: ``(e, 2)`` edge-center coordinates.
        edges: ``(e, 2)`` site indices of each edge's endpoints.
        boundary_edge_indices: Indices of edges on the boundary.
        directions: ``(e, 2)`` vectors from the first endpoint to the second.
        edge_lengths: ``(e,)`` edge lengths.
        dual_edge_lengths: ``(e,)`` lengths of the crossing Voronoi edges.
    """

    def __init__(
        self,
        centers: np.ndarray,
        edges: np.ndarray,
        boundary_edge_indices: np.ndarray,
        directions: np.ndarray,
        edge_lengths: np.ndarray,
        dual_edge_lengths: np.ndarray,
    ):
        self.centers = np.asarray(centers)
        self.edges = np.asarray(edges)
        self.boundary_edge_indices = np.asarray(boundary_edge_indices,
                                                dtype=np.int64)
        self.directions = np.asarray(directions)
        self.normalized_directions = (
            self.directions
            / np.linalg.norm(self.directions, axis=1, keepdims=True)
        )
        self.edge_lengths = np.asarray(edge_lengths)
        self.dual_edge_lengths = np.asarray(dual_edge_lengths)

    @property
    def x(self) -> np.ndarray:
        """x-coordinates of the edge centers."""
        return self.centers[:, 0]

    @property
    def y(self) -> np.ndarray:
        """y-coordinates of the edge centers."""
        return self.centers[:, 1]

    @staticmethod
    def from_mesh(
        sites: np.ndarray, elements: np.ndarray, dual_sites: np.ndarray
    ) -> "EdgeMesh":
        """Build the edge mesh of a triangulation given its Voronoi vertices."""
        edges, is_boundary = get_edges(elements)
        boundary_edge_indices = np.where(is_boundary)[0]
        endpoint_coords = sites[edges]  # (e, 2, 2)
        centers = endpoint_coords.mean(axis=1)
        directions = endpoint_coords[:, 1] - endpoint_coords[:, 0]
        edge_lengths = np.linalg.norm(directions, axis=1)
        dual_edge_lengths = get_dual_edge_lengths(
            sites, elements, dual_sites, edges
        )
        return EdgeMesh(
            centers, edges, boundary_edge_indices, directions, edge_lengths,
            dual_edge_lengths,
        )

    _FIELDS = ("centers", "edges", "boundary_edge_indices", "directions",
               "edge_lengths", "dual_edge_lengths")

    def to_hdf5(self, h5group: h5lite.Group) -> None:
        """Save to an HDF5 group (same schema as the reference)."""
        for field in self._FIELDS:
            h5group[field] = getattr(self, field)

    @classmethod
    def from_hdf5(cls, h5group: h5lite.Group) -> "EdgeMesh":
        """Load from an HDF5 group."""
        missing = [f for f in cls._FIELDS if f not in h5group]
        if missing:
            raise IOError(f"Cannot load EdgeMesh; missing datasets: {missing}")
        return EdgeMesh(
            centers=np.array(h5group["centers"]),
            edges=np.array(h5group["edges"], dtype=np.int64),
            boundary_edge_indices=np.array(
                h5group["boundary_edge_indices"], dtype=np.int64
            ),
            directions=np.array(h5group["directions"]),
            edge_lengths=np.array(h5group["edge_lengths"]),
            dual_edge_lengths=np.array(h5group["dual_edge_lengths"]),
        )
