"""The public helper API: the 18 functions of reference ``distributed.py``.

Counterpart of ``distributed_pytorch_tpu/api.py``, over torch.distributed:
the same names, call shapes and graceful degradation (every function is
safe before init and without distribution). ``import
distributed_pytorch_tpu_torch as dist`` reads like the reference's
``import distributed as dist`` (``min_DDP.py:7``).

==== ======================================  =========================================
#    reference (distributed.py)              here
==== ======================================  =========================================
1    find_free_port          (:32-37)        runtime.launcher.find_free_port
2    launch                  (:40-58)        runtime.launcher.launch
3    init_process_group      (:62-66)        runtime.context.init_process_group
4    is_dist_avail_and_initialized (:69-74)  is_dist_avail_and_initialized (below)
5    cleanup                 (:77-79)        cleanup (below)
6    get_rank                (:82-85)        runtime.context.get_rank
7    get_device              (:88-91)        runtime.context.get_device
8    is_primary              (:94-95)        utils.logging.is_primary
9    get_world_size          (:98-101)       runtime.context.get_world_size
10   data_sampler            (:105-108)      data.sampler.data_sampler
11   prepare_ddp_model       (:112-115)      parallel.data_parallel.prepare_ddp_model
12   all_reduce              (:119-133)      comm.collectives.all_reduce
13   reduce                  (:136-144)      comm.collectives.reduce
14   gather                  (:147-160)      comm.collectives.gather
15   sync_params             (:163-170)      comm.collectives.sync_params
16   barrier                 (:173-177)      comm.collectives.barrier
17   wait_for_everyone       (:181-182)      comm.collectives.wait_for_everyone
18   print_primary           (:185-187)      utils.logging.print_primary
==== ======================================  =========================================

Beside them: ``all_gather``, ``broadcast``, ``device_count``,
``get_backend``, ``shard_batch`` and ``replicate``, as in the JAX
package, and ``launch_multiprocess`` (the multi-process door, which
``launch`` takes at world > 1).
"""

from __future__ import annotations

from .comm.collectives import (all_gather, all_reduce, barrier, broadcast,
                               gather, reduce, sync_params, wait_for_everyone)
from .data.sampler import data_sampler
from .parallel.data_parallel import prepare_ddp_model
from .runtime import context as _context
from .runtime.context import (device_count, get_backend, get_device,
                              get_rank, get_world_size, init_process_group,
                              replicate, shard_batch)
from .runtime.launcher import find_free_port, launch
from .runtime.multiprocess import launch_multiprocess
from .utils.logging import is_primary, print_primary


def is_dist_avail_and_initialized() -> bool:
    """Whether torch.distributed is available and this process is in a
    group (reference ``distributed.py:69-74``)."""
    return _context.is_initialized()


def cleanup() -> None:
    """Leave the group iff in one (reference ``distributed.py:77-79``)."""
    if is_dist_avail_and_initialized():
        _context.destroy_process_group()


__all__ = [
    "find_free_port", "launch", "init_process_group",
    "is_dist_avail_and_initialized", "cleanup", "get_rank", "get_device",
    "is_primary", "get_world_size", "data_sampler", "prepare_ddp_model",
    "all_reduce", "reduce", "gather", "sync_params", "barrier",
    "wait_for_everyone", "print_primary",
    "all_gather", "broadcast", "device_count", "get_backend", "shard_batch",
    "replicate", "launch_multiprocess",
]
