from .edge_mesh import EdgeMesh
from .mesh import Mesh

__all__ = ["EdgeMesh", "Mesh"]
