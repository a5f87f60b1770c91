"""The step whose layout is carried by its inputs, batch placement, and
the sequence-parallel attention island.

Counterpart of ``distributed_pytorch_tpu/parallel/spmd.py``
(``SpmdStepOutput``, ``make_spmd_train_step``, ``shard_batch_spec``,
``make_gspmd_ring_attn_fn``, ``make_gspmd_striped_ring_attn_fn``).
On the TPU the partitioner propagates the inputs' shardings through
global-view model code; here the parameters are DTensors the caller
placed (``tensor.shard_params``) and the batch is a DTensor placed by
:func:`shard_batch_spec` (``P("dp", "sp")`` shards the sequence too),
and DTensor propagation derives the collectives (the front door's
``FROM_INPUTS`` engine).

The one part propagation would get wrong by itself, attention over a
sequence sharded on ``sp`` (it would gather k/v), is an island, as the
JAX ``shard_map`` is: :func:`make_gspmd_ring_attn_fn`'s ``attn_fn``
lays q, k and v out as ``(dp, tp, sp, None)`` over the dimensions of
their own mesh, runs ``parallel.sequence`` on the local (B, H/tp,
S/sp, Dh) shards over the ``sp`` axis's group, and hands the output
back as a DTensor of that layout.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..optim import Optimizer
from .sequence import (ring_attention, ring_flash_attention,
                       striped_ring_flash_attention, ulysses_attention)


class SpmdStepOutput(NamedTuple):
    params: Any           # the model, its parameters updated in place
    opt_state: Any
    loss: torch.Tensor    # scalar global-mean loss
    metrics: Any


SP_CORES = ("dense", "flash", "striped", "ulysses")


def _axis_group(mesh, name: str):
    """The process group of ``mesh``'s axis ``name``; ``None`` (the
    one-rank world) outside a process group."""
    from ..runtime import context
    if not context.is_initialized():
        return None
    if tuple(mesh.mesh_dim_names) == (name,):
        return mesh.get_group()
    return mesh[name].get_group()


def _axis_size(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


def make_gspmd_ring_attn_fn(mesh, *, dp: str = "dp", tp: str = "tp",
                            sp: str = "sp", core: str = "dense",
                            block_q=None, block_k=None,
                            window: Optional[int] = None) -> Callable:
    """An ``attn_fn`` for a model trained on a sequence-sharded batch:
    attention over the ``sp`` axis by ``core``: ``dense`` (the dense
    ring), ``flash`` (the flash kernel per hop), ``striped`` (the
    load-balanced causal ring; tokens, targets and position ids in
    ``sequence.stripe_tokens`` layout) or ``ulysses`` (all-to-all around
    a full-sequence flash kernel; heads must divide sp). ``window``
    (sliding-window attention) is taken by ``flash`` and ``ulysses``.

    DTensor q, k, v run on their local ``(dp, tp, sp, None)`` shards
    over the group of their mesh's ``sp`` axis; plain tensors are a
    whole sequence, taken only where ``mesh`` has one ``sp`` rank.
    ``block_q`` / ``block_k`` are the JAX package's tile sizes, which
    the CUDA kernels fix themselves: accepted and unused."""
    del block_q, block_k
    if core not in SP_CORES:
        raise ValueError(f"unknown ring attention core {core!r}")
    if window is not None and core not in ("flash", "ulysses"):
        raise ValueError(f"window is supported by core='flash' and "
                         f"core='ulysses', not {core!r}")

    def run(q, k, v, group, causal, scale):
        if core == "ulysses":
            return ulysses_attention(q, k, v, group=group, causal=causal,
                                     scale=scale, window=window)
        if core == "striped":
            return striped_ring_flash_attention(q, k, v, group=group,
                                                scale=scale)
        if core == "flash":
            return ring_flash_attention(q, k, v, group=group, causal=causal,
                                        scale=scale, window=window)
        return ring_attention(q, k, v, group=group, causal=causal,
                              scale=scale)

    def sp_group(qmesh):
        """The ring's group: the sp axis of q's mesh, or of ``mesh`` when
        q's mesh has none (a one-rank axis the step left out)."""
        for m in (qmesh, mesh):
            if m is not None and sp in (m.mesh_dim_names or ()):
                return _axis_group(m, sp)
        from ..runtime import context
        if context.get_world_size() > 1:
            raise ValueError(f"no {sp!r} axis in the mesh {mesh}")
        return None

    def attn_fn(q, k, v, *, causal: bool = False, scale=None):
        if core == "striped" and not causal:
            raise ValueError(
                "striped ring attention is causal-only (striping exists "
                "to balance the causal frontier); use core='flash' for "
                "non-causal attention")
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(q, DTensor):
            if _axis_size(mesh, sp) > 1:
                raise ValueError(
                    f"a ring over {_axis_size(mesh, sp)} sp ranks takes "
                    "q, k and v as DTensors (a batch placed by "
                    "shard_batch_spec)")
            return run(q, k, v, sp_group(None), causal, scale)
        qmesh = q.device_mesh
        names = tuple(qmesh.mesh_dim_names)
        dims = {dp: Shard(0), tp: Shard(1), sp: Shard(2)}
        layout = tuple(dims.get(name, Replicate()) for name in names)
        local = []
        for t in (q, k, v):
            if not isinstance(t, DTensor) or t.device_mesh != qmesh:
                raise ValueError("the sp island takes q, k and v as "
                                 "DTensors of one mesh")
            if tuple(t.placements) != layout:
                t = t.redistribute(qmesh, layout)
            local.append(t.to_local())
        o = run(*local, sp_group(qmesh), causal, scale)
        return DTensor.from_local(o, qmesh, layout, run_check=False,
                                  shape=q.shape,
                                  stride=torch.empty(q.shape,
                                                     device="meta").stride())
    return attn_fn


def make_gspmd_striped_ring_attn_fn(mesh, *, dp: str = "dp", tp: str = "tp",
                                    sp: str = "sp", block_q=None,
                                    block_k=None) -> Callable:
    """:func:`make_gspmd_ring_attn_fn` with ``core='striped'``."""
    return make_gspmd_ring_attn_fn(mesh, dp=dp, tp=tp, sp=sp,
                                   core="striped", block_q=block_q,
                                   block_k=block_k)


def make_spmd_train_step(loss_fn: Callable, optimizer: Optimizer,
                         mesh=None, param_specs: Optional[Any] = None,
                         batch_spec: Any = None,
                         donate: Optional[bool] = None) -> Callable:
    """``step(model, opt_state, batch) -> SpmdStepOutput`` where the
    layout is carried by the inputs: place the parameters with
    ``tensor.shard_params`` and the batch with :func:`shard_batch_spec`
    first. ``loss_fn(model, batch) -> (loss, metrics)`` computes the
    global mean loss on global shapes, written as single-device code.

    A shim over the front door (``front_door.make_step`` with
    ``specs=FROM_INPUTS``): the builder cache, the build counts and
    ``donate`` come from there."""
    del mesh, param_specs, batch_spec  # carried by the inputs
    from .front_door import FROM_INPUTS, make_step
    return make_step(loss_fn, optimizer, specs=FROM_INPUTS, donate=donate)


def shard_batch_spec(batch, mesh, spec):
    """Each tensor of ``batch`` (the global batch, equal on every rank)
    as a DTensor laid out by ``spec`` (a ``P`` over the tensor's
    dimensions, e.g. ``P("dp")`` for a (B, S) token batch) on the
    sub-mesh of ``mesh`` where ``tensor.shard_params`` puts parameters
    (``tensor.layout_mesh``): this rank keeps its own chunk, nothing is
    sent."""
    from torch.distributed.tensor import DTensor
    from ..convert import ParamSlot
    from .fsdp import _local_chunk
    from .tensor import layout_mesh, layout_placements
    full, mesh = mesh, layout_mesh(mesh)
    placements = layout_placements(spec, ParamSlot(0, False, None), full,
                                   mesh)

    def place(t):
        local = _local_chunk(t, mesh, placements).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    from ..runtime.context import map_tensors
    return map_tensors(place, batch)


__all__ = ["SP_CORES", "SpmdStepOutput", "make_gspmd_ring_attn_fn",
           "make_gspmd_striped_ring_attn_fn", "make_spmd_train_step",
           "shard_batch_spec"]
