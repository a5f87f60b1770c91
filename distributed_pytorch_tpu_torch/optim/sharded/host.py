"""ZeRO-1 on the native host group: the host door's sharded step.

Counterpart of ``distributed_pytorch_tpu/optim/sharded/host.py``::

    reduce_scatter_q8(grad bucket)          # half the all-reduce's bytes
    the step on the owned 1/world slice     # on the parameters' device
    allgather_q8(updated params)            # the other half

Error feedback rides the scatter leg (an ``ErrorFeedback`` residual
carries each step's rounding of the gradient bucket into the next); at
world 1 both legs are no-ops and nothing is quantized, as in the JAX
package. The
exact master of the owned slice lives in the sharded state; the working
parameters are the grid every rank decoded from the gather leg,
bit-identical across ranks.

``grad_reduce="mean"`` keeps both legs exact: the bucket rides the exact
f32 ring all-reduce (reduce-scatter and all-gather in one) and the
updated slices the exact hub all-gather. With an elementwise optimizer
the parameters then equal the replicated host step's bit for bit: the
gradients and the master are rounded through each parameter's dtype as
the replicated step's are.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ...obs import metrics as _dpxmon
from .. import Optimizer
from .layout import build_layout
from .optimizer import shard_optimizer


def make_host_sharded_train_step(fb: Callable, optimizer: Optimizer,
                                 grad_reduce: str = "mean") -> Callable:
    """The sharded step over the live host comm; ``fb`` is
    ``parallel.data_parallel.forward_backward``'s runner."""
    from ...ops.quant import ErrorFeedback
    from ...parallel.data_parallel import step_output, trainable
    from ...runtime import context

    comm = context.get_host_comm()
    world, rank = comm.world, comm.rank
    ef = ErrorFeedback() if grad_reduce in ("quant", "int8") else None
    holder = {}
    times = {"d2h_s": 0.0, "codec_s": 0.0, "ring_s": 0.0, "h2d_s": 0.0}

    def ensure(ps):
        if "layout" not in holder:
            holder["layout"] = build_layout(ps, world)
            holder["sharded"] = shard_optimizer(optimizer,
                                                holder["layout"])
        return holder["layout"], holder["sharded"]

    def init_opt_state(params):
        ps = trainable(params)
        layout, sharded = ensure(ps)
        return sharded.init_slice(ps, layout.ring_segment(rank))

    def step(model, opt_state, batch):
        params, grads, loss, metrics = fb(model, batch)
        ps = [p for p, g in zip(params, grads) if g is not None]
        gs = [g for g in grads if g is not None]
        layout, sharded = ensure(ps)
        device = ps[0].device
        if device.type == "cuda":   # the copies alone, not the backward
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        flat = layout.flatten_np(gs)
        t1 = time.perf_counter()
        lo, hi = layout.span(layout.ring_segment(rank))
        if ef is not None and world > 1:
            flat = ef.compensate(flat)
        t2 = time.perf_counter()
        if world > 1:
            if ef is not None:
                comm.reduce_scatter_q8(flat)
            else:
                # the exact ring all-reduce IS reduce-scatter +
                # all-gather: its owned span is the reduced sum, bit for
                # bit, at the all-reduce's bytes
                comm.allreduce(flat)
        t3 = time.perf_counter()
        g_slice = layout.round_(torch.from_numpy(flat[lo:hi] / world)
                                .to(device), lo)
        master, new_state = sharded.update_flat(g_slice, opt_state)
        layout.round_(master, lo)
        t4 = time.perf_counter()
        flat[lo:hi] = master.cpu().numpy()    # the bucket gathers params
        t5 = time.perf_counter()
        if world > 1:
            if ef is not None:
                comm.allgather_q8(flat)
            else:
                stacked = comm.all_gather(flat[lo:hi])
                for r in range(world):
                    rlo, rhi = layout.span(layout.ring_segment(r))
                    flat[rlo:rhi] = stacked[r]
        t6 = time.perf_counter()
        layout.unflatten_into(torch.from_numpy(flat).to(device), ps)
        t7 = time.perf_counter()
        times["d2h_s"] += (t1 - t0) + (t5 - t4)
        times["codec_s"] += t2 - t1
        times["ring_s"] += (t3 - t2) + (t6 - t5)
        times["h2d_s"] += (t4 - t3) + (t7 - t6)
        # dpxmon step hook (obs/metrics.py; one global read when off)
        _dpxmon.on_train_step("host_step_sharded")
        return step_output(model, new_state, loss, metrics)

    step.init_opt_state = init_opt_state
    step.host_times = times
    return step
