"""Multi-device layout of the port: one-axis meshes of torch devices."""

from lazzaro_tpu_torch.parallel.mesh import (Mesh, make_hybrid_mesh,
                                             make_mesh, replica_group_meshes,
                                             single_device_mesh)

__all__ = ["Mesh", "make_mesh", "single_device_mesh", "make_hybrid_mesh",
           "replica_group_meshes"]
