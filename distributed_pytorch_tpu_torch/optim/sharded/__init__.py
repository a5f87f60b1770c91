"""optim/sharded: the cross-replica sharded weight update (ZeRO-1, arXiv
2004.13336).

Counterpart of ``distributed_pytorch_tpu/optim/sharded/``. The
data-parallel update ``all-reduce(grads) -> every rank's full step``
becomes::

    reduce-scatter(grads) -> the step on the owned 1/world slice
                          -> all-gather(updated params)

the same wire bytes as the all-reduce it replaces, and 1/world of the
optimizer state and update work per rank. On the native host group both
legs ride the block-int8 ring (``dpx_reduce_scatter_q8`` /
``dpx_allgather_q8``, ``host.py``); on torch.distributed they are
``reduce_scatter_tensor`` / ``all_gather_into_tensor`` or their quantized
primitives (``spmd.py``).

* :func:`build_layout` / :class:`FlatLayout`: the flat bucket;
* :func:`shard_optimizer` / :class:`ShardedOptimizer` /
  :class:`ShardedOptState`: an elementwise optimizer over a slice;
* :func:`make_sharded_train_step`, reached from
  ``parallel.make_train_step(..., weight_update="sharded")``.
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import Optimizer
from .layout import FlatLayout, build_layout, lcm_pad_multiple
from .optimizer import ShardedOptimizer, ShardedOptState, shard_optimizer

__all__ = [
    "FlatLayout", "build_layout", "lcm_pad_multiple",
    "ShardedOptimizer", "ShardedOptState", "shard_optimizer",
    "make_sharded_train_step",
]


def make_sharded_train_step(loss_fn: Callable, optimizer: Optimizer,
                            donate: Optional[bool] = None,
                            grad_reduce: str = "mean",
                            mixed_precision: str = "off") -> Callable:
    """The ``weight_update="sharded"`` step: ``step(model, opt_state,
    batch) -> StepOutput`` with ``opt_state`` from the returned step's
    ``init_opt_state(params)`` (this rank's :class:`ShardedOptState`).
    On the native host group when one is live, else on torch.distributed
    (which also covers world 1 without a group). ``grad_reduce``:
    ``mean`` or ``quant`` / ``int8``. ``donate`` changes nothing (the
    update works in place)."""
    from ...parallel.data_parallel import forward_backward
    from ...optim.schedules import reduces_across_leaves
    from ...runtime import context

    del donate
    if grad_reduce not in ("mean", "quant", "int8"):
        raise ValueError(
            f"the sharded update speaks grad_reduce mean|quant|int8, got "
            f"{grad_reduce!r}")
    if reduces_across_leaves(optimizer):
        raise ValueError(
            "the sharded update steps one flat slice per rank: an "
            "optimizer that reads all the gradients together (global-norm "
            "clipping) cannot run that way; keep "
            "weight_update='replicated'")
    fb = forward_backward(loss_fn, mixed_precision)
    if context.get_host_comm() is not None:
        from .host import make_host_sharded_train_step
        return make_host_sharded_train_step(fb, optimizer,
                                            grad_reduce=grad_reduce)
    from .spmd import make_dist_sharded_train_step
    return make_dist_sharded_train_step(fb, optimizer,
                                        grad_reduce=grad_reduce)
