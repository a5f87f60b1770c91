"""The data-parallel train step, at world 1 on one card.

Counterpart of ``distributed_pytorch_tpu/parallel/data_parallel.py``
(``StepOutput``, ``make_train_step``). The step has the JAX package's
shape: ``step(params, opt_state, batch) -> StepOutput``, where the
params are the ``nn.Module`` (updated in place) and ``opt_state`` is
what ``optimizer.init(model.parameters())`` returned; the loss comes
back as the per-rank stack of shape ``(world,)``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): world > 1 and the DDP helper API, the quantized ``grad_reduce``
modes, ``weight_update="sharded"`` (ZeRO-1) and the ``bf16``
mixed-precision policy.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..optim import Optimizer

#: grad_reduce spellings of the JAX package; only "mean" is ported.
GRAD_REDUCE_MODES = ("mean", "int8", "quant", "q4", "adaptive")

#: mixed_precision policies of the JAX package; only "off" is ported.
MP_POLICIES = ("off", "bf16")


class StepOutput(NamedTuple):
    params: Any              # the model, its parameters updated in place
    opt_state: Any
    loss: torch.Tensor       # (world,) per-rank mean losses
    metrics: Any             # loss_fn's metrics, detached


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    donate: Optional[bool] = None,
                    grad_reduce: str = "mean",
                    weight_update: Optional[str] = None,
                    mixed_precision: Optional[str] = None) -> Callable:
    """A training step ``step(model, opt_state, batch) -> StepOutput``.

    ``loss_fn(model, batch) -> (loss, metrics)`` with ``loss`` the batch
    mean. Each call clears the gradients, runs the forward and backward,
    applies ``optimizer.update`` to the parameters in place and returns
    the loss as a ``(1,)`` stack (world 1).

    ``donate`` is accepted for the JAX signature and changes nothing:
    the update already writes the parameters and the optimizer state in
    place, which is what donation buys XLA. ``mixed_precision=None``
    means ``"off"`` (the port registers no ``DPX_MP_POLICY`` until the
    ``bf16`` policy is ported)."""
    if grad_reduce not in GRAD_REDUCE_MODES:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCE_MODES}, "
                         f"got {grad_reduce!r}")
    if grad_reduce != "mean":
        raise NotImplementedError(
            f"grad_reduce={grad_reduce!r} is not ported yet (the quantized "
            f"gradient wire: ROADMAP.md Queue A item 2)")
    if weight_update not in (None, "replicated", "sharded"):
        raise ValueError(f"weight_update must be replicated|sharded, got "
                         f"{weight_update!r}")
    if weight_update == "sharded":
        raise NotImplementedError(
            "weight_update='sharded' (ZeRO-1) is not ported yet "
            "(ROADMAP.md Queue A item 2)")
    mp = "off" if mixed_precision is None else mixed_precision
    if mp not in MP_POLICIES:
        raise ValueError(f"mixed_precision must be one of {MP_POLICIES}, "
                         f"got {mixed_precision!r}")
    if mp == "bf16":
        raise NotImplementedError(
            "mixed_precision='bf16' (f32 master, bf16 compute) is not "
            "ported yet (ROADMAP.md Queue A item 1)")
    del donate

    def step(model, opt_state, batch) -> StepOutput:
        if _world_size() > 1:
            raise NotImplementedError(
                "make_train_step runs at world 1 in this port: the DDP "
                "helper API and the gradient all-reduce are ROADMAP.md "
                "Queue A item 1")
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        opt_state = optimizer.update(grads, opt_state, params)
        return StepOutput(model, opt_state, loss.detach().reshape(1),
                          _detach(metrics))

    return step
