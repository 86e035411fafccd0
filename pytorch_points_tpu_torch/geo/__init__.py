"""Mesh and point geometry (counterpart of the JAX ``geo``): mesh
operators, mean value coordinates for cage deformation, differentiable
point splatting."""

from pytorch_points_tpu_torch.geo.cage import (
    deform_with_cage,
    mean_value_coordinates,
)
from pytorch_points_tpu_torch.geo.mesh_ops import (
    cot_laplacian,
    dihedral_angles,
    edge_lengths,
    face_areas,
    face_normals,
    mean_curvature,
    mesh_edges,
    point_laplacian,
    uniform_laplacian,
    vertex_normals,
)
from pytorch_points_tpu_torch.geo.splatting import Camera, render_points

__all__ = [
    "Camera",
    "cot_laplacian",
    "deform_with_cage",
    "dihedral_angles",
    "edge_lengths",
    "face_areas",
    "face_normals",
    "mean_curvature",
    "mean_value_coordinates",
    "mesh_edges",
    "point_laplacian",
    "render_points",
    "uniform_laplacian",
    "vertex_normals",
]
