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


@dataclasses.dataclass
class _State:
    device: Optional[torch.device] = None  # this rank's, while a group lives


_state = _State()


def device_count() -> int:
    """Number of visible CUDA devices: the world size ``launch`` uses
    (reference ``distributed.py:41``); 0 on a host without a card."""
    return torch.cuda.device_count()


def _rank_device(rank: int) -> torch.device:
    """The device rank ``rank`` owns, from ``DPX_MULTIPROC_ACCEL``."""
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
    when the rank owns a CUDA device, gloo for CPU ranks."""
    device = _rank_device(rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    port = env.get("DPX_MASTER_PORT")
    if port is None:
        raise KeyError("DPX_MASTER_PORT is not set: start the ranks with "
                       "launch_multiprocess, or export it in every rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend, init_method=f"tcp://{env.get('DPX_MASTER_ADDR')}:{port}",
        rank=rank, world_size=world_size)
    _state.device = device


def is_initialized() -> bool:
    """Whether this process is in a group (reference ``distributed.py:
    69-74``)."""
    return tdist.is_available() and tdist.is_initialized()


def destroy_process_group() -> None:
    """Leave the group (reference ``distributed.py:77-79``)."""
    tdist.destroy_process_group()
    _state.device = None


def get_rank() -> int:
    """This process's rank; 0 outside a group (reference ``:82-85``)."""
    return tdist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """The group's size; 1 outside a group (reference ``:98-101``)."""
    return tdist.get_world_size() if is_initialized() else 1


def get_backend() -> Optional[str]:
    """``"nccl"`` or ``"gloo"`` inside a group, else ``None``."""
    return tdist.get_backend() if is_initialized() else None


def get_device() -> torch.device:
    """The device of this rank's tensors (reference ``:88-91``):
    ``cuda:{rank}``, or the CPU when the group was made for CPU ranks.
    Outside a group it is ``cuda:0``, and with no card it raises."""
    if is_initialized() and _state.device is not None:
        return _state.device
    resolve_device(None)
    return torch.device("cuda", get_rank())


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
