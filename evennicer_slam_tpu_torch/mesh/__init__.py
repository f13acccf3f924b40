"""Meshing (counterpart of ``evennicer_slam_tpu/mesh``)."""

from evennicer_slam_tpu_torch.mesh.marching import marching_cubes
from evennicer_slam_tpu_torch.mesh.mesher import Mesher
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
