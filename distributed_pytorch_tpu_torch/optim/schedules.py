"""Learning-rate schedules and optimizer wrappers.

Counterpart of ``distributed_pytorch_tpu/optim/schedules.py``. A
schedule is ``f(step) -> lr``, a Python float computed in float32 as the
JAX package computes it, so the host never waits for the device to learn
the lr. The wrappers keep the port's in-place ``(init, update)``
contract (``optim/__init__.py``): ``update(grads, state, params)``
writes the parameters and returns the new state, and a ``None``
gradient (a frozen parameter) leaves its parameter as it is.

Copies the state keeps (the EMA, the float32 master) are ``clone()``s:
``p.float()`` of a float32 parameter is the parameter itself, and the
in-place update would move an alias with it (the JAX package copies for
the same reason, there to keep a donated buffer from appearing twice).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from . import Optimizer, _foreach_copy, _with_grads, _zeros_f32

Schedule = Callable[[int], float]

_F32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(_F32(lr))


def linear_warmup(base: Schedule, warmup_steps: int) -> Schedule:
    def f(step):
        w = min(_F32(1.0), (_F32(step) + _F32(1.0))
                / _F32(max(warmup_steps, 1)))
        return float(_F32(base(step)) * w)
    return f


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0
                 ) -> Schedule:
    """``lr * (alpha + (1 - alpha) * 0.5 * (1 + cos(pi * t)))``, t =
    step / decay_steps clipped to [0, 1]."""
    if decay_steps < 1:
        raise ValueError(f"decay_steps must be >= 1, got {decay_steps} "
                         "(0 would make the lr 0/0 = NaN)")

    def f(step):
        t = np.clip(_F32(step) / _F32(decay_steps), _F32(0.0), _F32(1.0))
        cos = _F32(0.5) * (_F32(1.0) + np.cos(_F32(math.pi) * t))
        return float(_F32(lr) * (_F32(alpha) + _F32(1.0 - alpha) * cos))
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  alpha: float = 0.0) -> Schedule:
    """Linear warmup into cosine decay (the standard LM schedule)."""
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1), alpha)

    def f(step):
        if step < warmup_steps:
            return float(_F32(lr) * (_F32(step) + _F32(1.0))
                         / _F32(max(warmup_steps, 1)))
        return decay(step - warmup_steps)
    return f


def _find(state, cls):
    """The first ``cls`` in a nest of state NamedTuples, or None."""
    if isinstance(state, cls):
        return state
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        for f in state._fields:
            found = _find(getattr(state, f), cls)
            if found is not None:
                return found
    return None


class ScheduledState(NamedTuple):
    step: int
    inner: Any


def with_schedule(opt_factory: Callable[[float], Optimizer],
                  schedule: Schedule) -> Optimizer:
    """Optimizer whose lr follows ``schedule``. ``opt_factory(lr)`` must
    use lr only as a scalar multiplier of the update (true of ``sgd`` and
    ``adamw``): it is built once at lr = 1, and the scheduled lr scales
    that update's delta, ``p + lr * (p_unit - p)``, computed in float32
    from the delta in the parameter's dtype, as the JAX package computes
    it. Rebuilding the optimizer at each step's lr would round otherwise
    at bfloat16.

    A :func:`with_master_f32` inside the factory would keep the whole
    lr = 1 update in its master copy and ignore the schedule: ``init``
    rejects it; compose ``with_master_f32(with_schedule(...))``."""
    unit = opt_factory(1.0)

    def init(params):
        inner = unit.init(params)
        if _find(inner, MasterState) is not None:
            raise ValueError(
                "with_schedule(factory) cannot wrap with_master_f32: the "
                "master copy would absorb the unscaled lr=1 update and "
                "the schedule would be ignored. Compose as "
                "with_master_f32(with_schedule(adamw, schedule)) instead.")
        return ScheduledState(step=0, inner=inner)

    @torch.no_grad()
    def update(grads, state, params):
        grads, params = list(grads), list(params)
        lr = schedule(state.step)
        _, moved = _with_grads(grads, params)
        before = [p.clone() for p in moved]
        inner = unit.update(grads, state.inner, params)
        if not moved:
            return ScheduledState(step=state.step + 1, inner=inner)
        delta = torch._foreach_sub(moved, before)    # in the params' dtype
        delta = [d.to(torch.float32) for d in delta]
        torch._foreach_mul_(delta, lr)
        new = torch._foreach_add([b.to(torch.float32) for b in before],
                                 delta)
        _foreach_copy(moved, new)
        return ScheduledState(step=state.step + 1, inner=inner)

    return Optimizer(init, _inherit(update, unit))


def global_norm(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """The L2 norm of all the tensors together, in float32 (a 0-d tensor
    on their device); ``None`` entries are skipped. A DTensor counts
    whole: its norm is taken over every shard."""
    ts = [t for t in tensors if t is not None]
    norms = torch._foreach_norm(ts, 2, dtype=torch.float32)
    if any(isinstance(n, DTensor) for n in norms):
        norms = [n.full_tensor() if isinstance(n, DTensor) else n
                 for n in norms]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float) -> List:
    """``grads`` scaled so their global L2 norm is at most ``max_norm``:
    new tensors in each gradient's dtype, each the float32 product
    rounded once; ``None`` stays ``None``."""
    grads = list(grads)
    kept = [g for g in grads if g is not None]
    scale = torch.clamp(max_norm / torch.clamp(global_norm(kept), min=1e-12),
                        max=1.0)
    scaled = iter(torch._foreach_mul(kept, scale))
    return [None if g is None else next(scaled) for g in grads]


def reduces_across_leaves(opt: Optimizer) -> bool:
    """Whether ``opt``'s update reads all the gradients together (global
    norm clipping, inside any wrapper): such an update cannot run on one
    bucket or one flat slice at a time (the overlapped and the sharded
    train steps refuse it)."""
    return bool(getattr(opt.update, "reduces_across_leaves", False))


def _inherit(update, *inner: Optimizer):
    """Mark a wrapper's ``update`` as its inner optimizer is marked."""
    update.reduces_across_leaves = any(reduces_across_leaves(o)
                                       for o in inner)
    return update


def with_clipping(opt: Optimizer, max_norm: float) -> Optimizer:
    """Clip the gradients by global norm before the inner update."""
    def update(grads, state, params):
        return opt.update(clip_by_global_norm(list(grads), max_norm), state,
                          params)
    update.reduces_across_leaves = True
    return Optimizer(opt.init, update)


class AccumState(NamedTuple):
    count: int                 # micro-steps since the last apply
    acc: List[torch.Tensor]    # float32 running gradient sums
    inner: Any


def accumulate(opt: Optimizer, every: int) -> Optimizer:
    """Apply the inner optimizer every ``every`` micro-steps with the mean
    of the accumulated gradients; in between the parameters stay as they
    are. Numerically one step on the ``every`` times larger batch (mean
    of means over equal micro-batches)."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")

    def init(params):
        params = list(params)
        return AccumState(count=0, acc=[_zeros_f32(p) for p in params],
                          inner=opt.init(params))

    @torch.no_grad()
    def update(grads, state, params):
        grads = list(grads)
        for x, a in zip(*_with_grads(grads, state.acc)):
            a += x
        count = state.count + 1
        if count < every:
            return AccumState(count, state.acc, state.inner)
        mean = [None if x is None else (a / every).to(x.dtype)
                for x, a in zip(grads, state.acc)]
        inner = opt.update(mean, state.inner, params)
        torch._foreach_zero_(state.acc)
        return AccumState(0, state.acc, inner)

    return Optimizer(init, _inherit(update, opt))


class EmaState(NamedTuple):
    ema: List[torch.Tensor]    # float32 moving average of the parameters
    inner: Any


def with_ema(opt: Optimizer, decay: float = 0.999) -> Optimizer:
    """Track an exponential moving average of the parameters in the
    optimizer state: after each inner update ``ema = decay * ema + (1 -
    decay) * p`` in float32. It starts at the initial parameters (a
    convex combination thereafter, so no bias correction). For a
    BatchNorm model the running stats come from the raw trajectory, so
    the EMA weights evaluate low until the stats are re-estimated
    (torch's ``swa_utils.update_bn``). With :func:`accumulate`, compose
    ``accumulate(with_ema(opt), every=k)``: the average then moves only
    on the steps that apply."""
    if not 0.0 <= decay < 1.0:
        raise ValueError(f"decay must be in [0, 1), got {decay} "
                         "(1.0 would freeze the average at init forever)")

    def init(params):
        params = list(params)
        return EmaState(ema=[p.detach().to(torch.float32, copy=True)
                             for p in params], inner=opt.init(params))

    @torch.no_grad()
    def update(grads, state, params):
        params = list(params)
        inner = opt.update(grads, state.inner, params)
        torch._foreach_mul_(state.ema, decay)
        torch._foreach_add_(state.ema, torch._foreach_mul(
            [p.to(torch.float32) for p in params], 1.0 - decay))
        return EmaState(ema=state.ema, inner=inner)

    return Optimizer(init, _inherit(update, opt))


def ema_params(state, like: Optional[Sequence[torch.Tensor]] = None):
    """The EMA weights of a :func:`with_ema` state, searched for through
    nested wrapper states. With ``like`` (the parameters), each is cast
    to its parameter's dtype (new tensors either way)."""
    found = _find(state, EmaState)
    if found is None:
        raise ValueError("no EmaState found in this optimizer state — "
                         "was the optimizer built with with_ema()?")
    if like is None:
        return [e.clone() for e in found.ema]
    return [e.to(p.dtype, copy=True) for e, p in zip(found.ema, like)]


class MasterState(NamedTuple):
    master: List[torch.Tensor]  # float32 copies of the parameters
    inner: Any


def with_master_f32(opt: Optimizer) -> Optimizer:
    """Float32 master weights for low-precision parameters: the inner
    optimizer updates the float32 masters, and each parameter becomes
    its master cast to the parameter's dtype. bfloat16 parameters alone
    lose every update below ~2^-8 of the weight to rounding."""

    def init(params):
        master = [p.detach().to(torch.float32, copy=True) for p in params]
        return MasterState(master=master, inner=opt.init(master))

    @torch.no_grad()
    def update(grads, state, params):
        grads32 = [None if g is None else g.to(torch.float32) for g in grads]
        inner = opt.update(grads32, state.inner, state.master)
        _foreach_copy(list(params), state.master)
        return MasterState(master=state.master, inner=inner)

    return Optimizer(init, _inherit(update, opt))
