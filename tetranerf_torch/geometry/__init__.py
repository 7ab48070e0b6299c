from .delaunay import find_average_spacing, triangulate
from .io import load_tetrahedra, save_tetrahedra
from .mesh import TorchMesh, build_mesh
from .ply import read_ply, write_ply

__all__ = ["TorchMesh", "build_mesh", "find_average_spacing", "load_tetrahedra", "read_ply",
           "save_tetrahedra", "triangulate", "write_ply"]
