"""ZeRO-1 on torch.distributed: the sharded step of the NCCL / gloo door.

Counterpart of the JAX package's single-controller sharded engine
(``optim/sharded/spmd.py``, built in ``parallel/front_door.py``): rank r
owns segment r of the flat bucket (``reduce_scatter_tensor``'s order),
its state lives on the parameters' device, and the legs are
``reduce_scatter_tensor`` / ``all_gather_into_tensor``, or under
``grad_reduce="quant"`` the int8 primitives
``comm.primitives.quantized_reduce_scatter`` /
``quantized_all_gather``. At world 1 the step is the plain update of
the one segment. The engine is built by the front door
(``parallel.front_door.make_step(weight_update="sharded")``);
:func:`make_spmd_sharded_train_step` keeps the JAX package's builder
name and signature as a shim over it.
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import Optimizer
from .layout import build_layout
from .optimizer import shard_optimizer


def make_spmd_sharded_train_step(loss_fn: Callable, optimizer: Optimizer,
                                 donate: Optional[bool] = None,
                                 grad_reduce: str = "mean",
                                 pad_multiple: Optional[int] = None
                                 ) -> Callable:
    """The sharded-update DP step, ``step(model, opt_state, batch) ->
    StepOutput`` with ``opt_state`` from the step's
    ``init_opt_state(params)`` and its spec tree from
    ``step.state_specs(opt_state)`` (the sharded checkpoint's
    ``opt_specs``). A shim over the front door
    (``front_door.make_step(weight_update="sharded")``)."""
    from ...parallel.front_door import make_step
    return make_step(loss_fn, optimizer, weight_update="sharded",
                     wire=grad_reduce, donate=donate,
                     pad_multiple=pad_multiple)


def make_dist_sharded_train_step(fb: Callable, optimizer: Optimizer,
                                 grad_reduce: str = "mean",
                                 pad_multiple: Optional[int] = None
                                 ) -> Callable:
    """The sharded step over the default torch.distributed group."""
    from ...comm import primitives as prim
    from ...parallel.data_parallel import step_output, trainable
    from ...runtime import context

    world, rank = context.get_world_size(), context.get_rank()
    quant = grad_reduce in ("quant", "int8")
    holder = {}

    def ensure(ps):
        if "layout" not in holder:
            holder["layout"] = build_layout(ps, world,
                                            pad_multiple=pad_multiple)
            holder["sharded"] = shard_optimizer(optimizer,
                                                holder["layout"])
        return holder["layout"], holder["sharded"]

    def init_opt_state(params):
        ps = trainable(params)
        _, sharded = ensure(ps)
        return sharded.init_slice(ps, rank)

    def step(model, opt_state, batch):
        params, grads, loss, metrics = fb(model, batch)
        ps = [p for p, g in zip(params, grads) if g is not None]
        gs = [g for g in grads if g is not None]
        layout, sharded = ensure(ps)
        lo, _ = layout.span(rank)
        flat = layout.flatten(gs)
        if world > 1:
            g_slice = (prim.quantized_reduce_scatter(flat) if quant
                       else prim.reduce_scatter(flat)) / world
        else:
            g_slice = flat
        layout.round_(g_slice, lo)
        master, new_state = sharded.update_flat(g_slice, opt_state)
        layout.round_(master, lo)
        if world > 1:
            full = (prim.quantized_all_gather(master) if quant
                    else prim.all_gather(master, tiled=True))
        else:
            full = master
        layout.unflatten_into(full, ps)
        return step_output(model, new_state, loss, metrics)

    step.init_opt_state = init_opt_state
    return step
