"""The process group and the device of this rank, over torch.distributed.

Counterpart of ``distributed_pytorch_tpu/runtime/context.py`` (reference
``distributed.py:62-101``: functions #3, #4, #6, #7 and #9 of the API).
The port runs the reference's own execution model: one OS process per
rank, each holding its own tensors, so the JAX package's device mesh
has no counterpart here. Rank r owns ``cuda:r`` and its group speaks
NCCL, unless the rank was started for the CPU (``DPX_MULTIPROC_ACCEL=cpu``,
which ``launch_multiprocess(..., device="cpu")`` sets), when it holds
CPU tensors and speaks gloo. The world size of ``launch`` is
``torch.cuda.device_count()``, which honours ``CUDA_VISIBLE_DEVICES``.

With ``backend="host"`` (or ``DPX_BACKEND=host``, which
``launch_multiprocess(..., backend="host")`` sets in every rank) the
group is instead the native TCP process group of ``native/dpxhost.cpp``
(:class:`~.native.HostComm`, the JAX package's ``"host"`` backend,
``context.py:150-168``); the collectives of ``comm/collectives.py`` then
run on it. A host rank's device is chosen as any other rank's:
``cuda:r`` unless the rank was started for the CPU.

The multi-axis mesh (JAX ``context.py:197-307``): :func:`init_mesh`
lays the live group's ranks out as a ``DeviceMesh`` over the axes
:data:`MESH_AXES` (``dp``, ``tp``, ``sp``, ``pp``, ``ep``, rank order
row-major as the JAX package reshapes its devices), on ``cuda`` or, for
a gloo group of CPU ranks, ``cpu``; :func:`get_mesh` returns it, and
:func:`batch_sharding` / :func:`replicated_sharding` are the placements
over its ``dp`` dimension. Unlike the JAX package, where ``get_world_size()``
becomes the ``dp`` axis after ``init_mesh`` (``:220``), the port's
``get_world_size()`` and ``get_rank()`` stay the process group's: a rank
is a process, the helper API's collectives run over every rank, and a
rank's place on an axis is ``get_mesh()[axis].get_local_rank()`` (the
data of a dp x tp mesh is split over ``dp`` by the caller).

Every query is safe before ``init_process_group``: rank 0, world 1, no
backend. ``get_device`` then names the card, and raises where there is
none: an entry point asks for the CPU explicitly, it never falls back to
it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as tdist

from . import env
from .device import resolve_device


#: The mesh axes, in order (JAX ``context.py``): data, tensor, sequence,
#: pipeline and expert parallelism.
MESH_AXES = ("dp", "tp", "sp", "pp", "ep")
DATA_AXIS = "dp"


@dataclasses.dataclass
class _State:
    device: Optional[torch.device] = None  # this rank's, while a group lives
    host_comm: Any = None                  # the native group, if "host"
    mesh: Any = None                       # init_mesh's DeviceMesh


_state = _State()


def device_count() -> int:
    """Number of visible CUDA devices: the world size ``launch`` uses
    (reference ``distributed.py:41``); 0 on a host without a card."""
    return torch.cuda.device_count()


def _rank_device(rank: int) -> torch.device:
    """The device rank ``rank`` owns, from ``DPX_MULTIPROC_ACCEL``
    (unset: the card)."""
    accel = env.get("DPX_MULTIPROC_ACCEL").strip().lower()
    if accel == "cpu":
        return torch.device("cpu")
    if accel not in ("", "cuda"):
        raise ValueError(f"DPX_MULTIPROC_ACCEL={accel!r} is not supported "
                         "(use 'cuda' or 'cpu')")
    n = torch.cuda.device_count()
    if rank >= n:
        raise RuntimeError(
            f"rank {rank} has no CUDA device of its own ({n} visible): "
            "start CPU ranks with launch_multiprocess(..., device='cpu') "
            "to make a gloo group")
    return torch.device("cuda", rank)


def init_process_group(rank: int, world_size: int,
                       backend: Optional[str] = None) -> None:
    """Join the ``world_size``-rank group as ``rank`` (reference
    ``distributed.py:62-66``), rendezvousing at ``tcp://DPX_MASTER_ADDR:
    DPX_MASTER_PORT``, which ``launch_multiprocess`` sets in every rank.

    ``backend`` defaults as the reference picks it (``:63-64``): nccl
    when the rank owns a CUDA device, gloo for CPU ranks; ``"host"``
    (the default under ``DPX_BACKEND=host``) makes the native group,
    whose rank r listens on ``DPX_MASTER_PORT + r``."""
    if backend is None and env.get("DPX_BACKEND") == "host":
        backend = "host"
    device = _rank_device(rank)
    port = env.get("DPX_MASTER_PORT")
    if port is None:
        raise KeyError("DPX_MASTER_PORT is not set: start the ranks with "
                       "launch_multiprocess, or export it in every rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "host":
        from .native import HostComm
        _state.host_comm = HostComm(env.get("DPX_MASTER_ADDR"), port, rank,
                                    world_size)
        _state.device = device
        return
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    tdist.init_process_group(
        backend, init_method=f"tcp://{env.get('DPX_MASTER_ADDR')}:{port}",
        rank=rank, world_size=world_size)
    _state.device = device


def is_initialized() -> bool:
    """Whether this process is in a group (reference ``distributed.py:
    69-74``)."""
    return _state.host_comm is not None or (
        tdist.is_available() and tdist.is_initialized())


def destroy_process_group() -> None:
    """Leave the group (reference ``distributed.py:77-79``); a host
    group's links are closed."""
    comm, _state.host_comm = _state.host_comm, None
    if comm is not None:
        comm.close()
    else:
        tdist.destroy_process_group()
    _state.device = None
    _state.mesh = None


def abort_process_group() -> None:
    """Tear this rank's group down after a failure, without waiting on
    peers: a host group's links are aborted (its peers fail typed within
    one deadline tick) and closed; a torch.distributed group is
    destroyed. A no-op outside a group."""
    comm, _state.host_comm = _state.host_comm, None
    if comm is not None:
        comm.abort()
        comm.close()
    elif tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _state.device = None
    _state.mesh = None


def get_host_comm():
    """The native :class:`~.native.HostComm` of a ``"host"`` group, else
    ``None`` (JAX ``context.py:246``)."""
    return _state.host_comm


def get_rank() -> int:
    """This process's rank; 0 outside a group (reference ``:82-85``)."""
    if _state.host_comm is not None:
        return _state.host_comm.rank
    return tdist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """The group's size; 1 outside a group (reference ``:98-101``)."""
    if _state.host_comm is not None:
        return _state.host_comm.world
    return tdist.get_world_size() if is_initialized() else 1


def get_backend() -> Optional[str]:
    """``"host"``, ``"nccl"`` or ``"gloo"`` inside a group, else
    ``None``."""
    if _state.host_comm is not None:
        return "host"
    return tdist.get_backend() if is_initialized() else None


def get_device() -> torch.device:
    """The device of this rank's tensors (reference ``:88-91``):
    ``cuda:{rank}``, or the CPU when the group was made for CPU ranks.
    Outside a group it is ``cuda:0``, and with no card it raises."""
    if is_initialized() and _state.device is not None:
        return _state.device
    resolve_device(None)
    return torch.device("cuda", get_rank())


def init_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              ep: int = 1, backend: Optional[str] = None):
    """Lay the live group's ranks out as a ``DeviceMesh`` of shape
    ``(dp, tp, sp, pp, ep)`` named by :data:`MESH_AXES` (through
    ``init_device_mesh``) and make it :func:`get_mesh`'s; returns it.

    ``backend`` is the mesh's device type: ``None`` takes this rank's
    (``cuda``, or ``cpu`` in a gloo group of CPU ranks). The axes must
    multiply to the world size (the JAX package's ``ValueError``). A
    ``"host"`` group has no torch.distributed group to lay out and is
    refused; so is a world of more than one rank with no group."""
    from torch.distributed.device_mesh import init_device_mesh
    world = get_world_size()
    need = dp * tp * sp * pp * ep
    if need != world:
        raise ValueError(
            f"mesh {dp}x{tp}x{sp}x{pp}x{ep}={need} does not match "
            f"{world} visible devices")
    if _state.host_comm is not None:
        raise ValueError("init_mesh needs a torch.distributed group (nccl "
                         "or gloo), not the native host group")
    if not is_initialized():
        raise RuntimeError("init_mesh needs a live process group: call "
                           "init_process_group first (get_mesh() gives a "
                           "trivial mesh without one)")
    device_type = backend or get_device().type
    _state.mesh = init_device_mesh(device_type, (dp, tp, sp, pp, ep),
                                   mesh_dim_names=MESH_AXES)
    return _state.mesh


def get_mesh():
    """The mesh of :func:`init_mesh`. In a torch.distributed group with
    none, the 1-D ``dp`` mesh over every rank (the JAX package's
    ``init_process_group`` mesh), made at the first call; outside one (or
    in a ``"host"`` group), a trivial one-rank ``dp`` mesh with no group
    behind it."""
    if _state.mesh is not None:
        return _state.mesh
    if is_initialized() and _state.host_comm is None:
        from torch.distributed.device_mesh import init_device_mesh
        _state.mesh = init_device_mesh(get_device().type,
                                       (get_world_size(),),
                                       mesh_dim_names=(DATA_AXIS,))
        return _state.mesh
    from torch.distributed.device_mesh import DeviceMesh
    device_type = (_state.device.type if _state.device is not None
                   else "cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh(device_type, [0], mesh_dim_names=(DATA_AXIS,),
                      _init_backend=False, _rank=0)


def batch_sharding() -> tuple:
    """The placement over the ``dp`` dimension that splits axis 0 of a
    batch across it."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated_sharding() -> tuple:
    """The placement over the ``dp`` dimension that replicates a value
    on every rank (DDP's parameters)."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def map_tensors(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every tensor of a nest of tuples, lists and
    dicts; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def shard_batch(batch: Any) -> Any:
    """This rank's local batch moved to :func:`get_device` (the per-rank
    ``x.to(device)`` of reference ``min_DDP.py:96``; each rank already
    holds only its own shard)."""
    device = get_device()
    return map_tensors(lambda t: t.to(device), batch)


def replicate(tree: Any) -> Any:
    """The tensors of ``tree`` on :func:`get_device`, holding rank 0's
    values on every rank (DDP's constructor broadcast)."""
    from ..comm.collectives import broadcast
    device = get_device()
    return map_tensors(lambda t: broadcast(t.to(device), src=0), tree)
