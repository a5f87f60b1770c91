"""Optimizers as functions on tensors.

Counterpart of ``distributed_pytorch_tpu/optim/__init__.py`` (``sgd``,
``adamw``). An optimizer is an ``(init, update)`` pair as in the JAX
package, over a sequence of parameter tensors: ``init(params)`` returns
the state, ``update(grads, state, params)`` writes the new parameters
into ``params`` in place (PyTorch's habit; the JAX package returns a new
tree) and returns the new state. A parameter whose gradient is ``None``
(a frozen one) is left as it is, and so is its state. The multi-tensor ``torch._foreach_*``
ops keep the update to a few launches per step on the card.

``torch.optim.AdamW`` is not used: with bfloat16 parameters it keeps
bfloat16 moments and computes another update. Here the moments are
float32 whatever the parameter dtype, and the update is computed in
float32 and cast back, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, NamedTuple, Sequence

import numpy as np
import torch

Tensors = Sequence[torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Iterable[torch.Tensor]], Any]
    update: Callable[[Tensors, Any, Tensors], Any]
    """update(grads, state, params) -> new_state; params updated in place"""


def _with_grads(grads, *lists):
    """``grads`` and each of ``lists`` restricted to the entries whose
    gradient is not ``None``."""
    keep = [i for i, g in enumerate(grads) if g is not None]
    return [[seq[i] for i in keep] for seq in (grads,) + lists]


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """``p - lr * g``, or with momentum ``v = momentum * v + g`` and
    ``p - lr * v`` (velocity in the parameter dtype)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(grads, state, params):
        grads = list(grads)
        if all(g is None for g in grads):
            return state
        if momentum == 0.0:
            grads, params = _with_grads(grads, list(params))
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
            return state
        grads, params, vel = _with_grads(grads, list(params), state)
        torch._foreach_mul_(vel, momentum)
        torch._foreach_add_(vel, grads)
        torch._foreach_sub_(params, torch._foreach_mul(vel, lr))
        return state

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    step: int
    mu: List[torch.Tensor]     # float32 first moments
    nu: List[torch.Tensor]     # float32 second moments


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """AdamW with torch's default hyperparameters: bias-corrected
    moments kept in float32, decoupled weight decay
    ``p * (1 - lr * wd)`` before the Adam step, the step computed in
    float32 and cast back to each parameter's dtype."""

    def init(params):
        params = list(params)

        def zeros():
            return [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params]
        return AdamWState(step=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads, state, params):
        grads, params, mu, nu = _with_grads(list(grads), list(params),
                                            state.mu, state.nu)
        if not grads:
            return state
        step = state.step + 1
        # bias corrections in float32, as the JAX package computes them
        t = np.float32(step)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        gf = [g.to(torch.float32) for g in grads]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(gf, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(gf, gf), 1 - b2))
        pf = torch._foreach_mul([p.to(torch.float32) for p in params],
                                1.0 - lr * weight_decay)
        upd = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(pf, upd)
        torch._foreach_copy_(params, pf)
        return AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init, update)


__all__ = ["AdamWState", "Optimizer", "adamw", "sgd"]
