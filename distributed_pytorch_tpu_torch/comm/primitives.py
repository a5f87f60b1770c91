"""Collective primitives over torch.distributed, each rank passing its own
block.

Counterpart of ``distributed_pytorch_tpu/comm/primitives.py``. There a
primitive runs inside a compiled ``shard_map`` region and names the mesh
axis; here each rank process calls it with its own tensor and it runs
over the default torch.distributed group (NCCL between cards, gloo
between CPU ranks). Every primitive returns a new tensor and leaves its
input alone; at world 1 each is the identity (with the shapes JAX gives:
``all_gather`` adds the axis), and the divisibility errors are JAX's.

Plain: :func:`psum`, :func:`pmean`, :func:`pmax`, :func:`pmin`,
:func:`all_gather`, :func:`reduce_scatter`, :func:`all_to_all`.

Quantized (the EQuARX recipe on the block codec of ``comm/wire.py``,
``ops/quant.py`` ``quantize_grad_blocks``): :func:`quantized_pmean` (each
rank quantizes its world chunk-rows, an ``all_to_all`` brings every rank
the world copies of its chunk, which it dequantize-sums in f32, divides,
requantizes and all-gathers: both legs move int8 + one f32 scale per
block), :func:`quantized_reduce_scatter` and
:func:`quantized_all_gather` (its two halves, ZeRO-1's legs), and
:func:`quantized_pmean_wire_bytes`.

Not ported yet: ``ppermute``, ``ring_shift`` and ``line_shift`` (the
sequence- and pipeline-parallel transports).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from ..ops.quant import dequantize_grad_blocks, quantize_grad_blocks
from ..runtime import context
from .wire import (QUANT_BLOCK, quant_leg_wire_bytes,  # noqa: F401
                   quant_ring_allreduce_wire_bytes, quant_wire_bytes,
                   ring_allreduce_wire_bytes)


def _world() -> int:
    return context.get_world_size()


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    out = x.clone()
    tdist.all_reduce(out, op=op)
    return out


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks."""
    return x if _world() == 1 else _all_reduce(x, tdist.ReduceOp.SUM)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks (DDP's gradient averaging)."""
    world = _world()
    return x if world == 1 else _all_reduce(x, tdist.ReduceOp.SUM) / world


def pmax(x: torch.Tensor) -> torch.Tensor:
    return x if _world() == 1 else _all_reduce(x, tdist.ReduceOp.MAX)


def pmin(x: torch.Tensor) -> torch.Tensor:
    return x if _world() == 1 else _all_reduce(x, tdist.ReduceOp.MIN)


def _gather_flat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, rank order."""
    world = _world()
    x = x.contiguous()
    out = torch.empty((world,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    gather_into = getattr(tdist, "all_gather_single", None) \
        or tdist.all_gather_into_tensor
    gather_into(out.reshape(-1), x.reshape(-1))
    return out


def all_gather(x: torch.Tensor, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x``: stacked on a new axis ``axis``, or with
    ``tiled`` concatenated along ``axis``."""
    stacked = x.unsqueeze(0) if _world() == 1 else _gather_flat(x)
    if tiled:
        return torch.cat(list(stacked.unbind(0)), dim=axis)
    return stacked.movedim(0, axis)


def reduce_scatter(x: torch.Tensor, scatter_axis: int = 0) -> torch.Tensor:
    """The sum over the ranks, cut into world chunks along
    ``scatter_axis``; this rank's chunk (rank r gets chunk r)."""
    world = _world()
    if world == 1:
        return x
    if x.shape[scatter_axis] % world:
        raise ValueError(f"reduce_scatter needs axis {scatter_axis} "
                         f"({x.shape[scatter_axis]}) divisible by the "
                         f"world ({world})")
    moved = x.movedim(scatter_axis, 0).contiguous()
    out = torch.empty((moved.shape[0] // world,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    scatter = getattr(tdist, "reduce_scatter_single", None) \
        or tdist.reduce_scatter_tensor
    scatter(out, moved)
    return out.movedim(0, scatter_axis)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``x`` cut into world chunks along ``split_axis``, chunk i sent to
    rank i; the chunks received, in rank order, concatenated along
    ``concat_axis`` (``tiled``) or stacked on a new axis there."""
    world = _world()
    if x.shape[split_axis] % world:
        raise ValueError(f"all_to_all needs axis {split_axis} "
                         f"({x.shape[split_axis]}) divisible by the world "
                         f"({world})")
    if world == 1:
        return x if tiled else x.unsqueeze(concat_axis)
    send = torch.stack(x.chunk(world, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send)
    if tiled:
        return torch.cat(list(recv.unbind(0)), dim=concat_axis)
    return recv.movedim(0, concat_axis)


def quantized_pmean_wire_bytes(n: int, world: int,
                               block: int = QUANT_BLOCK) -> int:
    """Wire bytes (all ranks, both legs) of one :func:`quantized_pmean`
    of ``n`` elements: in each leg every rank ships world - 1 quantized
    chunks of the zero-padded bucket's 1/world rows."""
    if world <= 1:
        return 0
    padded = n + ((-n) % (world * block))
    chunk = quant_wire_bytes(padded // world, block)
    return 2 * world * (world - 1) * chunk


def quantized_pmean(x: torch.Tensor, *, block: int = QUANT_BLOCK,
                    bits: int = 8) -> torch.Tensor:
    """The mean over the ranks on the block-quantized wire (8 or 4 bits):
    lossy, at most one quantization step per leg
    (``|err| <= blockmax|x| / (2 levels) + blockmax|mean| / (2
    levels)``), and bit-identical on every rank. Returns ``x``'s shape
    and dtype."""
    n = _world()
    if n == 1:
        return x
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    size = flat.numel()
    pad = (-size) % (n * block)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    nb = flat.numel() // (n * block)
    q, scale = quantize_grad_blocks(flat.reshape(n, nb, block), bits)
    # rank i receives every rank's row i: the world copies of its chunk
    rq = all_to_all(q, 0, 0).reshape(n, nb, block)
    rs = all_to_all(scale, 0, 0).reshape(n, nb, 1)
    partial = dequantize_grad_blocks(rq, rs).sum(dim=0) / n
    q2, scale2 = quantize_grad_blocks(partial, bits)
    gq = _gather_flat(q2)
    gs = _gather_flat(scale2)
    out = dequantize_grad_blocks(gq, gs).reshape(-1)
    if pad:
        out = out[:size]
    return out.reshape(shape).to(dtype)


def quantized_reduce_scatter(x: torch.Tensor, *,
                             block: int = QUANT_BLOCK) -> torch.Tensor:
    """The sum over the ranks on the int8 wire, scattered: ``x`` is a
    flat f32 vector of a multiple of ``world * block`` elements; rank r
    gets chunk r of the sum (``len(x) / world`` elements). One
    quantization step of error per contribution."""
    n = _world()
    if n == 1:
        return x
    size = x.shape[0]
    if size % (n * block):
        raise ValueError(
            f"quantized_reduce_scatter needs len(x) divisible by "
            f"world*block = {n * block}, got {size}")
    nb = size // (n * block)
    q, scale = quantize_grad_blocks(x.to(torch.float32).reshape(n, nb, block))
    rq = all_to_all(q, 0, 0).reshape(n, nb, block)
    rs = all_to_all(scale, 0, 0).reshape(n, nb, 1)
    return dequantize_grad_blocks(rq, rs).sum(dim=0).reshape(-1)


def quantized_all_gather(x: torch.Tensor, *,
                         block: int = QUANT_BLOCK) -> torch.Tensor:
    """Every rank's flat f32 chunk (a multiple of ``block`` elements) on
    the int8 wire, concatenated in rank order: each rank quantizes its
    chunk once and every rank, the owner included, decodes the same
    bytes, so the result is bit-identical everywhere. At world 1 the
    chunk comes back exact, as from the native leg."""
    n = _world()
    if x.shape[0] % block:
        raise ValueError(
            f"quantized_all_gather needs len(x) divisible by block = "
            f"{block}, got {x.shape[0]}")
    if n == 1:
        return x.to(torch.float32)
    q, scale = quantize_grad_blocks(x.to(torch.float32).reshape(-1, block))
    gq = _gather_flat(q)
    gs = _gather_flat(scale)
    return dequantize_grad_blocks(gq, gs).reshape(-1)
