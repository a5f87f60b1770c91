"""The step whose layout is carried by its inputs, and batch placement.

Counterpart of ``distributed_pytorch_tpu/parallel/spmd.py``
(``SpmdStepOutput``, ``make_spmd_train_step``, ``shard_batch_spec``).
On the TPU the partitioner propagates the inputs' shardings through
global-view model code; here the parameters are DTensors the caller
placed (``tensor.shard_params``) and the batch is a DTensor placed by
:func:`shard_batch_spec`, and DTensor propagation derives the
collectives (the front door's ``FROM_INPUTS`` engine). The ring
attention builders of the JAX module (``make_gspmd_ring_attn_fn``,
``make_gspmd_striped_ring_attn_fn``) are sequence parallelism: ROADMAP.md
Queue A item 5.5.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..optim import Optimizer


class SpmdStepOutput(NamedTuple):
    params: Any           # the model, its parameters updated in place
    opt_state: Any
    loss: torch.Tensor    # scalar global-mean loss
    metrics: Any


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
    sub-mesh of ``mesh`` over the axes it names
    (``tensor.layout_mesh``, where ``tensor.shard_params`` puts
    parameters): this rank keeps its own chunk, nothing is sent."""
    from torch.distributed.tensor import DTensor
    from ..convert import ParamSlot, spec_placements
    from .fsdp import _local_chunk
    from .tensor import layout_mesh, spec_axes
    mesh = layout_mesh(mesh, spec_axes([spec]))
    names = tuple(mesh.mesh_dim_names)
    placements = spec_placements(spec, ParamSlot(0, False, None), names)

    def place(t):
        local = _local_chunk(t, mesh, placements).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    from ..runtime.context import map_tensors
    return map_tensors(place, batch)


__all__ = ["SpmdStepOutput", "make_spmd_train_step", "shard_batch_spec"]
