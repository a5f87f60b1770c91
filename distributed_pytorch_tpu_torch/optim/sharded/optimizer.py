"""``shard_optimizer``: an elementwise port optimizer over 1/world of the
flat bucket.

Counterpart of ``distributed_pytorch_tpu/optim/sharded/optimizer.py``.
The wrapped ``(init, update)`` pair runs unchanged on one flat float32
slice instead of the parameter list. Every supported optimizer is
elementwise (``sgd``, ``adamw``, ``adamw_8bit``): updating a slice gives
the same numbers as updating everything and slicing. ``adafactor``'s
factored moments couple rows and columns, so it is refused at init.

:class:`ShardedOptState`: ``inner``, the wrapped optimizer's state over
the slice, and ``master``, the owned parameters as a flat float32 tensor
(exact for float32 parameters; a bf16 parameter's elements hold its bf16
value, as in the replicated step). The working parameters every rank
holds come from the gather leg, the quantized grid under a quantized
wire; the master stays exact, so the gap never compounds.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import torch

from .. import AdafactorState, Optimizer
from . import layout as _layout


class ShardedOptState(NamedTuple):
    inner: Any      # the wrapped optimizer's state over the owned slice
    master: Any     # the owned parameters, a flat float32 tensor


def _reject_non_elementwise(inner_state) -> None:
    if isinstance(inner_state, AdafactorState):
        raise TypeError(
            "shard_optimizer requires an ELEMENTWISE optimizer "
            "(sgd/adamw/adamw_8bit): adafactor's factored second "
            "moments couple rows and columns and cannot be updated on "
            "a flat 1/world slice — keep weight_update='replicated'")


class ShardedOptimizer(NamedTuple):
    """The sharded face of an ``optim.Optimizer``: the same math over a
    flat float32 slice. The engines (``host.py``, ``spmd.py``) move the
    bytes."""

    inner: Optimizer
    layout: _layout.FlatLayout

    def init_flat(self, flat_params: torch.Tensor) -> ShardedOptState:
        """State over a flat float32 slice (copied as the master)."""
        master = flat_params.detach().to(torch.float32).clone()
        inner_state = self.inner.init([master])
        _reject_non_elementwise(inner_state)
        return ShardedOptState(inner=inner_state, master=master)

    def init_slice(self, params: Sequence[torch.Tensor],
                   seg_index: int) -> ShardedOptState:
        """State over segment ``seg_index`` of ``params``' bucket, on
        their device."""
        flat = self.layout.flatten(list(params))
        lo, hi = self.layout.span(seg_index)
        return self.init_flat(flat[lo:hi])

    def update_flat(self, g_flat: torch.Tensor, state: ShardedOptState
                    ) -> Tuple[torch.Tensor, ShardedOptState]:
        """One step on the slice: ``g_flat`` is the mean gradient of the
        owned elements; the master is updated in place and returned with
        the new state."""
        new_inner = self.inner.update([g_flat], state.inner, [state.master])
        return state.master, ShardedOptState(inner=new_inner,
                                             master=state.master)


def shard_optimizer(opt: Optimizer,
                    layout: _layout.FlatLayout) -> ShardedOptimizer:
    """Wrap ``opt`` (an elementwise ``Optimizer``) for the sharded
    weight update over ``layout``."""
    if not isinstance(opt, Optimizer):
        raise TypeError(
            f"shard_optimizer wraps an optim.Optimizer NamedTuple, got "
            f"{type(opt).__name__}")
    return ShardedOptimizer(inner=opt, layout=layout)
