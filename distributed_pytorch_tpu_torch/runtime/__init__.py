"""Runtime helpers of the port: the typed env registry, device
resolution, the process group and the multi-axis mesh (``context``), the
launchers, failure detection (supervision, heartbeats, orphan cleanup),
deterministic fault injection and chaos campaigns, elastic restart, the
host topology of several hosts, and the typed comm-failure hierarchy."""

from . import (chaos, context, elastic, faults, launcher, multihost,
               multiprocess, native, watchdog)
from .context import (DATA_AXIS, MESH_AXES, batch_sharding, device_count,
                      get_device, get_host_comm, get_mesh, get_rank,
                      get_world_size, init_mesh, init_process_group,
                      is_initialized, replicated_sharding)
from .elastic import ElasticResult, elastic_attempt, elastic_run, is_elastic
from .launcher import find_free_port, launch
from .multiprocess import launch_multiprocess
from .native import CommCorrupt, CommError, CommPeerDied, CommTimeout
from .watchdog import (Heartbeat, HeartbeatMonitor, ProcessSupervisor,
                       StalledWorker, WorkerFailure, kill_orphan_workers)

__all__ = ["CommCorrupt", "CommError", "CommPeerDied", "CommTimeout",
           "DATA_AXIS", "ElasticResult", "Heartbeat", "HeartbeatMonitor",
           "MESH_AXES", "ProcessSupervisor", "StalledWorker",
           "WorkerFailure", "batch_sharding", "chaos", "context",
           "device_count", "elastic", "elastic_attempt", "elastic_run",
           "faults", "find_free_port", "get_device", "get_host_comm",
           "get_mesh", "get_rank", "get_world_size", "init_mesh",
           "init_process_group", "is_elastic", "is_initialized",
           "kill_orphan_workers", "launch", "launch_multiprocess",
           "launcher", "multihost", "multiprocess", "native",
           "replicated_sharding", "watchdog"]
