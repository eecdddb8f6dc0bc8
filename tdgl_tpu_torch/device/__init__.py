from .layer import Layer
from .meshing import generate_mesh
from .polygon import Polygon

__all__ = ["Layer", "Polygon", "generate_mesh"]
