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
:func:`all_gather`, :func:`reduce_scatter`, :func:`all_to_all`; and
:func:`axis_index` / :func:`axis_size`, this rank's place in a group and
its size (the in-step rank and world of JAX's mesh axes). ``psum``,
``pmean``, ``pmax``, ``pmin``, ``all_gather`` and ``reduce_scatter``
take an optional ``group`` (a sub-group, such as one axis of the
mesh: ``get_mesh()["tp"].get_group()``) in place of the default one.

Quantized (the EQuARX recipe on the block codec of ``comm/wire.py``,
``ops/quant.py`` ``quantize_grad_blocks``): :func:`quantized_pmean` (each
rank quantizes its world chunk-rows, an ``all_to_all`` brings every rank
the world copies of its chunk, which it dequantize-sums in f32, divides,
requantizes and all-gathers: both legs move int8 + one f32 scale per
block), :func:`quantized_reduce_scatter` and
:func:`quantized_all_gather` (its two halves, ZeRO-1's legs), and
:func:`quantized_pmean_wire_bytes`.

Point to point (the sequence- and pipeline-parallel transports):
:func:`ppermute` (each rank sends its block to the rank a ``(src, dst)``
pair names; a rank that no pair sends to receives zeros, as from
``collective-permute``), :func:`ring_shift` (every block ``shift`` hops
round the ring: ring attention's k/v) and :func:`line_shift` (``shift``
hops along the line, no wraparound: a pipeline's activations go +1,
its cotangents -1). Each posts all of a step's sends and receives
together (``batch_isend_irecv``), so a ring cannot deadlock, and each is
differentiable: its gradient is the inverse permutation, so autograd
through a ring runs the reverse ring. :func:`all_to_all` is
differentiable too (its gradient is the inverse all-to-all: Ulysses and
the expert dispatch), and it and the point-to-point primitives take a
``group`` as the others do.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from ..ops.quant import dequantize_grad_blocks, quantize_grad_blocks
from ..runtime import context
from .wire import (QUANT_BLOCK, quant_leg_wire_bytes,  # noqa: F401
                   quant_ring_allreduce_wire_bytes, quant_wire_bytes,
                   ring_allreduce_wire_bytes)


def _world(group=None) -> int:
    if group is None:
        return context.get_world_size()
    return tdist.get_world_size(group)


def axis_index(group=None) -> int:
    """This rank's position in ``group`` (default: the whole group);
    0 outside a group."""
    if group is None:
        return context.get_rank()
    return tdist.get_rank(group)


def axis_size(group=None) -> int:
    """The number of ranks in ``group`` (default: the world)."""
    return _world(group)


def _all_reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    out = x.clone()
    tdist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks."""
    return x if _world(group) == 1 else _all_reduce(
        x, tdist.ReduceOp.SUM, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks (DDP's gradient averaging)."""
    world = _world(group)
    return x if world == 1 else _all_reduce(
        x, tdist.ReduceOp.SUM, group) / world


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    return x if _world(group) == 1 else _all_reduce(
        x, tdist.ReduceOp.MAX, group)


def pmin(x: torch.Tensor, group=None) -> torch.Tensor:
    return x if _world(group) == 1 else _all_reduce(
        x, tdist.ReduceOp.MIN, group)


def _gather_flat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, rank order."""
    world = _world(group)
    x = x.contiguous()
    out = torch.empty((world,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    gather_into = getattr(tdist, "all_gather_single", None) \
        or tdist.all_gather_into_tensor
    gather_into(out.reshape(-1), x.reshape(-1), group=group)
    return out


def all_gather(x: torch.Tensor, axis: int = 0,
               tiled: bool = False, group=None) -> torch.Tensor:
    """Every rank's ``x``: stacked on a new axis ``axis``, or with
    ``tiled`` concatenated along ``axis``."""
    stacked = x.unsqueeze(0) if _world(group) == 1 \
        else _gather_flat(x, group)
    if tiled:
        return torch.cat(list(stacked.unbind(0)), dim=axis)
    return stacked.movedim(0, axis)


def reduce_scatter(x: torch.Tensor, scatter_axis: int = 0,
                   group=None) -> torch.Tensor:
    """The sum over the ranks, cut into world chunks along
    ``scatter_axis``; this rank's chunk (rank r gets chunk r)."""
    world = _world(group)
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
    scatter(out, moved, group=group)
    return out.movedim(0, scatter_axis)


def _all_to_all_tiled(x, split_axis: int, concat_axis: int, group):
    world = _world(group)
    send = torch.stack(x.chunk(world, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its gradient is the all-to-all back (split
    along ``concat_axis``, concatenated along ``split_axis``)."""

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all_tiled(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all_tiled(g, concat_axis, split_axis, ctx.group),
                None, None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               tiled: bool = True, group=None) -> torch.Tensor:
    """``x`` cut into world chunks along ``split_axis``, chunk i sent to
    rank i; the chunks received, in rank order, concatenated along
    ``concat_axis`` (``tiled``) or stacked on a new axis there.
    Differentiable: the gradient goes back by the inverse all-to-all."""
    world = _world(group)
    if x.shape[split_axis] % world:
        raise ValueError(f"all_to_all needs axis {split_axis} "
                         f"({x.shape[split_axis]}) divisible by the world "
                         f"({world})")
    if world == 1:
        return x if tiled else x.unsqueeze(concat_axis)
    out = _AllToAll.apply(x, split_axis, concat_axis, group)
    if tiled:
        return out
    # the world chunks side by side on concat_axis -> a new axis there
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 1] = [world, shape[concat_axis] // world]
    return out.reshape(shape)


def _peer(group, r: int) -> int:
    """The global rank of ``group``'s rank ``r``."""
    return r if group is None else tdist.get_global_rank(group, r)


def _permute(x: torch.Tensor, pairs, group) -> torch.Tensor:
    """``x`` sent along every ``(src, dst)`` pair of group ranks; what
    this rank receives, zeros where no pair sends to it. All of this
    rank's sends and receives are posted together."""
    me = axis_index(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(tdist.P2POp(tdist.isend, x, _peer(group, dst), group))
        elif dst == me:
            ops.append(tdist.P2POp(tdist.irecv, out, _peer(group, src),
                                   group))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    """:func:`_permute`, whose gradient is the inverse permutation."""

    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _permute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.pairs)
        return _permute(g, inverse, ctx.group), None, None


def ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """Point to point: every ``(src, dst)`` pair of ``perm`` (ranks of
    ``group``) sends rank src's ``x`` to rank dst; a rank no pair sends
    to gets zeros (``collective-permute``). No rank may receive twice.
    Differentiable: the gradient goes back along the inverted pairs."""
    pairs = tuple((int(s), int(d)) for s, d in perm)
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a rank receives twice in {pairs}")
    return _Permute.apply(x, pairs, group)


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Every rank's block ``shift`` hops round the ring of ``group``: rank
    i's lands on rank ``(i + shift) % n`` (ring attention's k/v
    transport). At one rank, ``x`` itself."""
    n = _world(group)
    if n == 1:
        return x
    return ppermute(x, [(i, (i + shift) % n) for i in range(n)], group)


def line_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Every rank's block ``shift`` hops along the line of ``group``, with
    no wraparound: a rank with no sender gets zeros (a pipeline's
    transport: activations +1, cotangents -1)."""
    n = _world(group)
    if shift >= 0:
        perm = [(i, i + shift) for i in range(n - shift)]
    else:
        perm = [(i, i + shift) for i in range(-shift, n)]
    if n == 1:
        return x.clone() if perm else torch.zeros_like(x)
    return ppermute(x, perm, group)


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
