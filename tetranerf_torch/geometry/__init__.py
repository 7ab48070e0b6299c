from .delaunay import triangulate
from .mesh import TorchMesh, build_mesh

__all__ = ["TorchMesh", "build_mesh", "triangulate"]
