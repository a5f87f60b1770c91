"""The collectives of the helper API (reference ``distributed.py:119-182``).

Counterpart of ``distributed_pytorch_tpu/comm/collectives.py`` as its
per-rank front door (``comm/host_backend.py:145-290``) defines them:
each rank passes its own tensor, and the collectives run on
torch.distributed (NCCL between cards, gloo between CPU ranks). The
reference's quirks are kept:

* ``all_reduce``: ``sum``, ``avg`` (sum, then divide by the world size;
  an integer tensor keeps its dtype, the quotient truncated toward zero
  as the JAX door's float64 ``sum / world`` cast back gives it), ``max``
  or ``min``, in place; any other op raises
  ``ValueError('"prod" is an invalid reduce operation!')``;
* ``reduce``: a sum into rank 0's tensor; every other rank gets its own
  tensor back unchanged;
* ``gather``: rank 0 gets every rank's tensor; every other rank gets
  the zeros it allocated (the input's shape, dtype and device);
* at world 1 each is the identity with the reference's shapes
  (``gather`` returns ``[x]``).

The op is checked at every world size, world 1 included, so that a
wrong op raises before a run ever reaches more ranks (the reference
checks it only at world > 1).

While a native host group is live (``DPX_BACKEND=host``,
``runtime/context.py``), every collective at world > 1 runs on it
instead (``comm/host_backend.py``), with the same results. There
``all_reduce`` and ``sync_params`` honour ``wire=`` (``"quant"``,
``"q4"``, ``"adaptive"``: the quantized ring). On torch.distributed the
wire is checked and the bytes stay exact, as on the JAX package's
single-controller door.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as tdist

from ..runtime import context
from . import host_backend

_OPS = {"sum": tdist.ReduceOp.SUM, "avg": tdist.ReduceOp.SUM,
        "max": tdist.ReduceOp.MAX, "min": tdist.ReduceOp.MIN}


def _check_op(op: str, valid) -> None:
    if op not in valid:
        raise ValueError(f'"{op}" is an invalid reduce operation!')


def all_reduce(tensor: torch.Tensor, op: str = "sum",
               wire: str = "exact") -> torch.Tensor:
    """Reduce ``tensor`` over the ranks, in place on every rank; returns
    it (reference ``distributed.py:119-133``). ``wire``: see the module
    docstring."""
    _check_op(op, _OPS)
    host_backend._check_wire(wire)
    world = context.get_world_size()
    if world == 1:
        return tensor
    comm = context.get_host_comm()
    if comm is not None:
        return host_backend.all_reduce(comm, tensor, op, wire=wire)
    tdist.all_reduce(tensor, op=_OPS[op])
    if op == "avg":
        if tensor.is_floating_point() or tensor.is_complex():
            tensor /= world
        else:
            tensor.div_(world, rounding_mode="trunc")
    return tensor


def reduce(tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Sum ``tensor`` into rank 0's, in place (reference ``distributed.py:
    136-144``). Every other rank gets its tensor back unchanged: the
    collective runs on a copy there, whatever the backend does to a
    non-root buffer."""
    _check_op(op, ("sum",))
    if context.get_world_size() == 1:
        return tensor
    comm = context.get_host_comm()
    if comm is not None:
        return host_backend.reduce(comm, tensor, op)
    if context.get_rank() == 0:
        tdist.reduce(tensor, dst=0)
    else:
        tdist.reduce(tensor.clone(), dst=0)
    return tensor


def gather(data: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``data`` in rank order on rank 0; zeros on every
    other rank (reference ``distributed.py:147-160``). All ranks pass
    tensors of one shape."""
    world = context.get_world_size()
    if world == 1:
        return [data]
    comm = context.get_host_comm()
    if comm is not None:
        return host_backend.gather(comm, data)
    out = [torch.zeros_like(data) for _ in range(world)]
    tdist.gather(data, out if context.get_rank() == 0 else None, dst=0)
    return out


def all_gather(data: torch.Tensor) -> torch.Tensor:
    """Every rank's ``data`` stacked in rank order, ``(world, *shape)``,
    on every rank (no reference counterpart: its ``gather`` is rooted)."""
    world = context.get_world_size()
    if world == 1:
        return data.unsqueeze(0)
    comm = context.get_host_comm()
    if comm is not None:
        return host_backend.all_gather(comm, data)
    out = [torch.empty_like(data) for _ in range(world)]
    tdist.all_gather(out, data)
    return torch.stack(out)


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place; returns it."""
    world = context.get_world_size()
    if not 0 <= src < world:
        raise ValueError(f"broadcast src={src} out of range for "
                         f"world={world}")
    if world > 1:
        comm = context.get_host_comm()
        if comm is not None:
            return host_backend.broadcast(comm, tensor, src)
        tdist.broadcast(tensor, src=src)
    return tensor


def sync_params(params: Sequence[torch.Tensor],
                wire: str = "exact") -> list:
    """Rank 0's values of ``params`` on every rank, in place, without
    autograd (reference ``distributed.py:163-170``); returns them.
    ``wire``: see the module docstring (a quantized wire leaves every
    rank, rank 0 included, with the dequantized float32 values)."""
    host_backend._check_wire(wire)
    params = list(params)
    comm = context.get_host_comm()
    if comm is not None and context.get_world_size() > 1:
        return host_backend.sync_params(comm, params, wire=wire)
    if context.get_world_size() > 1:
        with torch.no_grad():
            for p in params:
                tdist.broadcast(p, src=0)
    return params


def barrier() -> None:
    """Block until every rank reaches this point (reference
    ``distributed.py:173-177``); nothing to wait for at world 1."""
    if context.get_world_size() == 1:
        return
    comm = context.get_host_comm()
    if comm is not None:
        return host_backend.barrier(comm)
    device = context.get_device()
    if device.type == "cuda":
        tdist.barrier(device_ids=[device.index])
    else:
        tdist.barrier()


def wait_for_everyone() -> None:
    """Readability alias of :func:`barrier` (reference ``:181-182``)."""
    barrier()
