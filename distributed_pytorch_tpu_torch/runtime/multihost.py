"""Several hosts: the rendezvous, the host topology and the hybrid mesh.

Counterpart of ``distributed_pytorch_tpu/runtime/multihost.py``. The
reference cannot span nodes (its rendezvous is ``MASTER_ADDR=localhost``
and its world the local device count, reference ``distributed.py:41,
48``). Here :func:`initialize` joins a ``torch.distributed`` group at a
coordinator's ``tcp://`` address, and :func:`init_hybrid_mesh` lays the
ranks out with the axes that cross hosts (DCN, the datacenter network)
outermost, so a collective over an inner axis stays on one host's
NVLink.

A host holds ``LOCAL_WORLD_SIZE`` ranks (torchrun's variable), else one
per visible card; a rank of a gloo group of CPU processes is a host of
its own. :func:`num_hosts` is the world over that. One process outside
a group is one host of one device: every function works unchanged there
(``num_hosts() == 1``, a hybrid mesh degrades to its ICI axes), as the
reference degrades from N ranks to 1. :func:`process_allgather` and
:func:`broadcast_from_primary` move small host values (metrics, health
beacons) over the group's CPU path, never the data path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import context
from . import env as _env

_initialized = False
_cpu_group = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the group of ``num_processes`` processes as ``process_id``,
    rendezvousing at ``coordinator_address`` (``host:port``; the
    process 0 serves the TCP store there). Idempotent, and a no-op
    without arguments (one host: nothing to join; a later explicit call
    still joins). Rank r owns card ``r % LOCAL_WORLD_SIZE`` (or of the
    visible cards), or the CPU under ``DPX_MULTIPROC_ACCEL=cpu`` (gloo).
    A failure of an explicit call propagates: swallowing it would split
    one job into independent "primary" jobs."""
    global _initialized
    if _initialized or context.is_initialized():
        _initialized = True
        return
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        return
    if any(a is None for a in args):
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            f"process_id together, got {args}")
    host, sep, port = str(coordinator_address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be 'host:port', got "
                         f"{coordinator_address!r}")
    import torch.distributed as tdist
    rank, world = int(process_id), int(num_processes)
    if _env.get("DPX_MULTIPROC_ACCEL").strip().lower() == "cpu":
        device = torch.device("cpu")
    else:
        n_local = _env.get("LOCAL_WORLD_SIZE") or torch.cuda.device_count()
        if n_local < 1:
            raise RuntimeError(
                "no CUDA device is visible: set DPX_MULTIPROC_ACCEL=cpu to "
                "join a gloo group of CPU processes")
        device = torch.device("cuda", rank % n_local)
        torch.cuda.set_device(device)
    tdist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{host}:{port}", rank=rank, world_size=world)
    context._state.device = device
    _initialized = True


def _local_world() -> int:
    """Ranks per host: ``LOCAL_WORLD_SIZE``, else one per visible card
    (at most the world); 1 for a CPU rank or a process outside a group."""
    n = _env.get("LOCAL_WORLD_SIZE")
    if n:
        return int(n)
    if not context.is_initialized() or context.get_device().type == "cpu":
        return 1
    return max(1, min(torch.cuda.device_count(), context.get_world_size()))


def num_hosts() -> int:
    """Hosts in the job (1 on a single host)."""
    return max(1, context.get_world_size() // _local_world())


def host_index() -> int:
    """This process's host (0 on a single host)."""
    return context.get_rank() // _local_world()


def is_primary_host() -> bool:
    """True on host 0: the host extension of the reference's rank-0
    ``is_primary`` (``distributed.py:94-95``)."""
    return host_index() == 0


def local_device_slice() -> Tuple[int, int]:
    """(start, stop) of this host's devices (ranks) in the global order."""
    per_host = _local_world()
    start = host_index() * per_host
    return start, start + per_host


def init_hybrid_mesh(ici: Sequence[Tuple[str, int]],
                     dcn: Sequence[Tuple[str, int]] = (),
                     devices=None):
    """A ``DeviceMesh`` whose ``ici`` axes stay within a host and whose
    ``dcn`` axes span hosts, the DCN axes outermost::

        # 4 hosts x 8 cards: dp over the hosts, dp x tp within each
        mesh = init_hybrid_mesh(ici=[("dp", 2), ("tp", 4)],
                                dcn=[("dp_outer", 4)])

    ``ici`` / ``dcn`` are ``(axis name, size)`` pairs whose sizes
    multiply to the ranks meshed: ``devices`` (rank ids, default every
    rank of the group). Ranks are host-grouped (rank r on host
    ``r // local world``), so reshaping with the DCN axes first keeps
    each ICI block on one host. On one host the ``dcn`` axes must have
    size 1 or be left out, and the mesh is an ICI mesh. Outside a group
    the one process is the mesh's one device."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = (list(devices) if devices is not None
             else list(range(context.get_world_size())))
    if not ranks:
        raise ValueError("no devices to mesh")
    dcn_size = int(np.prod([s for _, s in dcn])) if dcn else 1
    ici_size = int(np.prod([s for _, s in ici])) if ici else 1
    if dcn_size * ici_size != len(ranks):
        raise ValueError(
            f"mesh {dcn_size}x{ici_size} != {len(ranks)} devices")
    n_slices = len({r // _local_world() for r in ranks})
    if n_slices > 1 and dcn_size != n_slices:
        raise ValueError(
            f"dcn axes multiply to {dcn_size} but the devices span "
            f"{n_slices} slices — the DCN dimension must equal the slice "
            "count so ici axes stay within one ICI domain")
    shape = tuple(s for _, s in dcn) + tuple(s for _, s in ici)
    names = tuple(n for n, _ in dcn) + tuple(n for n, _ in ici)
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    if not context.is_initialized():
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
        return DeviceMesh(device_type, mesh, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    if context.get_host_comm() is not None:
        raise ValueError("init_hybrid_mesh needs a torch.distributed group "
                         "(nccl or gloo), not the native host group")
    return DeviceMesh(context.get_device().type, mesh, mesh_dim_names=names)


def _gloo_group():
    """The group's CPU path: the group itself under gloo, else a gloo
    group over the same ranks, made at the first call (collective)."""
    global _cpu_group
    import torch.distributed as tdist
    if tdist.get_backend() == "gloo":
        return None
    if _cpu_group is None:
        _cpu_group = tdist.new_group(backend="gloo")
    return _cpu_group


def _world() -> int:
    if context.get_host_comm() is not None:
        raise ValueError("process_allgather / broadcast_from_primary need "
                         "a torch.distributed group, not the host group")
    return context.get_world_size()


def process_allgather(x) -> np.ndarray:
    """A small host value of every process, stacked on axis 0 (the
    process index). One process: ``x`` with a leading axis of 1."""
    x = np.asarray(x)
    if _world() == 1:
        return x[None]
    import torch.distributed as tdist
    out = [None] * context.get_world_size()
    tdist.all_gather_object(out, x, group=_gloo_group())
    return np.stack([np.asarray(v) for v in out])


def broadcast_from_primary(x) -> np.ndarray:
    """Process 0's value of a small host value, on every process: the
    host-data analog of ``sync_params``' broadcast from rank 0
    (reference ``distributed.py:163-170``). One process: ``x``."""
    x = np.asarray(x)
    if _world() == 1:
        return x
    import torch.distributed as tdist
    box = [x if context.get_rank() == 0 else None]
    tdist.broadcast_object_list(box, src=0, group=_gloo_group())
    return np.asarray(box[0])
