"""Runtime helpers of the port: the typed env registry, device
resolution, the process group and the multi-axis mesh (``context``)."""

from .context import (DATA_AXIS, MESH_AXES, batch_sharding, device_count,
                      get_device, get_host_comm, get_mesh, get_rank,
                      get_world_size, init_mesh, init_process_group,
                      is_initialized, replicated_sharding)

__all__ = ["DATA_AXIS", "MESH_AXES", "batch_sharding", "device_count",
           "get_device", "get_host_comm", "get_mesh", "get_rank",
           "get_world_size", "init_mesh", "init_process_group",
           "is_initialized", "replicated_sharding"]
