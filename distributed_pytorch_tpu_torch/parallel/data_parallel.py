"""Data parallelism: the train steps, the eval steps, the bf16 policy and
the DDP wrapper.

Counterpart of ``distributed_pytorch_tpu/parallel/data_parallel.py``
(``StepOutput``, ``make_train_step``, ``StatefulStepOutput``,
``make_stateful_train_step``, ``make_eval_step``,
``make_stateful_eval_step``, ``stack_state``, ``make_scan_train_steps``,
``mp_cast_params``, ``DataParallel``, ``prepare_ddp_model``), in the
per-rank form of its host front door (``_make_host_train_step``): every
rank process runs ``step(model, opt_state, batch) -> StepOutput`` on its
own local batch.
The params are the ``nn.Module`` (updated in place), ``opt_state`` is
what ``optimizer.init(model.parameters())`` returned, and the loss comes
back as this rank's ``(1,)`` mean. At world > 1 the gradients are
averaged over the ranks once per step, between backward and the
optimizer update, so every rank applies the same update.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the quantized ``grad_reduce`` modes and ``weight_update=
"sharded"`` (ZeRO-1), both ROADMAP.md Queue A item 5.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch
from torch import nn

from ..comm.collectives import all_gather, sync_params
from ..optim import Optimizer
from ..runtime import context
from ..runtime import env as _env

#: grad_reduce spellings of the JAX package; only "mean" is ported.
GRAD_REDUCE_MODES = ("mean", "int8", "quant", "q4", "adaptive")

#: mixed_precision policies accepted by :func:`make_train_step`.
MP_POLICIES = ("off", "bf16")


class StepOutput(NamedTuple):
    params: Any              # the model, its parameters updated in place
    opt_state: Any
    loss: torch.Tensor       # (1,) this rank's mean loss
    metrics: Any             # loss_fn's metrics, detached


class StatefulStepOutput(NamedTuple):
    params: Any              # the model, its parameters updated in place
    state: Any               # the model's buffers (BatchNorm running stats)
    opt_state: Any
    loss: torch.Tensor       # (1,) this rank's mean loss
    metrics: Any


@contextlib.contextmanager
def mp_cast_params(model: nn.Module) -> Iterator[nn.Module]:
    """Inside the block, every float32 parameter of ``model`` reads as
    its bfloat16 cast; other parameters and all buffers are untouched.

    The cast is a differentiable op of the float32 master parameter, so
    a backward run inside the block (where a remat policy recomputes
    the forward from the same casts) leaves float32 gradients on the
    masters, which stay what the optimizer updates. A parameter shared
    by several modules is cast once."""
    casts, swapped = {}, []
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None and p.dtype == torch.float32:
                if id(p) not in casts:
                    casts[id(p)] = p.to(torch.bfloat16)
                swapped.append((mod, name, p))
    try:
        for mod, name, p in swapped:
            mod._parameters[name] = casts[id(p)]
        yield model
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def _average_grads(grads, world: int) -> None:
    """Average ``grads`` over the ranks in place: one float32 flat
    bucket, one ``all_reduce`` (sum), divided by ``world``."""
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    torch.distributed.all_reduce(flat)
    flat /= world
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    donate: Optional[bool] = None,
                    grad_reduce: str = "mean",
                    weight_update: Optional[str] = None,
                    mixed_precision: Optional[str] = None) -> Callable:
    """A training step ``step(model, opt_state, batch) -> StepOutput``.

    ``loss_fn(model, batch) -> (loss, metrics)`` with ``loss`` the
    local batch mean. Each call clears the gradients, runs the forward
    and backward, averages the gradients of the parameters that require
    them over the ranks (world > 1), applies ``optimizer.update`` in
    place and returns the loss as a ``(1,)`` tensor. A trainable
    parameter that the loss does not reach gets a zero gradient, as in
    the JAX package; a frozen one (``requires_grad=False``) gets
    ``None``, which the optimizer skips, so neither weight decay nor the
    all-reduce touches it. Buffers are left alone.

    ``mixed_precision``: ``"off"`` or ``"bf16"`` (``None`` reads
    ``DPX_MP_POLICY``). Under ``bf16`` the forward and backward run on
    the bf16 cast of the float32 parameters (:func:`mp_cast_params`)
    and the float32 gradients update the float32 masters.

    ``donate`` is accepted for the JAX signature and changes nothing:
    the update already writes the parameters and the optimizer state in
    place, which is what donation buys XLA."""
    if grad_reduce not in GRAD_REDUCE_MODES:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCE_MODES}, "
                         f"got {grad_reduce!r}")
    if grad_reduce != "mean":
        raise NotImplementedError(
            f"grad_reduce={grad_reduce!r} is not ported yet (the quantized "
            f"gradient wire: ROADMAP.md Queue A item 5)")
    if weight_update not in (None, "replicated", "sharded"):
        raise ValueError(f"weight_update must be replicated|sharded, got "
                         f"{weight_update!r}")
    if weight_update == "sharded":
        raise NotImplementedError(
            "weight_update='sharded' (ZeRO-1) is not ported yet "
            "(ROADMAP.md Queue A item 5)")
    mp = (_env.get("DPX_MP_POLICY") if mixed_precision is None
          else mixed_precision)
    if mp not in MP_POLICIES:
        raise ValueError(f"mixed_precision must be one of {MP_POLICIES}, "
                         f"got {mp!r}")
    del donate
    cast = mp_cast_params if mp == "bf16" else contextlib.nullcontext

    def step(model, opt_state, batch) -> StepOutput:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        with cast(model):
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 if p.requires_grad else None for p in params]
        world = context.get_world_size()
        if world > 1:
            _average_grads([g for g in grads if g is not None], world)
        opt_state = optimizer.update(grads, opt_state, params)
        return StepOutput(model, opt_state, loss.detach().reshape(1),
                          context.map_tensors(torch.Tensor.detach, metrics))

    return step


@contextlib.contextmanager
def _mode(model: nn.Module, train: bool) -> Iterator[None]:
    """``model`` in training (``train``) or eval mode inside the block,
    its previous mode restored after."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def make_stateful_train_step(loss_fn: Callable, optimizer: Optimizer,
                             donate: Optional[bool] = None,
                             **kw) -> Callable:
    """:func:`make_train_step` for a model with state that is not trained
    (BatchNorm running stats): ``step(model, opt_state, batch) ->
    StatefulStepOutput``, the model in training mode for the step (its
    previous mode restored after), ``state`` its buffers by name after
    the step (BatchNorm ``mean``, ``var`` and ``count``: the tensors
    themselves).

    ``loss_fn(model, batch) -> (loss, metrics)``: the forward updates the
    running stats in place from this rank's local batch. Nothing syncs
    them across the ranks, as in torch DDP and the JAX package's
    per-device state; the gradients are averaged once per step, as in
    :func:`make_train_step`, whose step this one runs."""
    inner = make_train_step(loss_fn, optimizer, donate=donate, **kw)

    def step(model, opt_state, batch) -> StatefulStepOutput:
        with _mode(model, True):
            out = inner(model, opt_state, batch)
        return StatefulStepOutput(out.params, dict(model.named_buffers()),
                                  out.opt_state, out.loss, out.metrics)

    return step


def _gather_ranks(metrics):
    """Every rank's ``metrics`` concatenated along axis 0 in rank order,
    on every rank: one ``all_gather`` of all the leaves packed into one
    float64 buffer (exact for the bool, int32 and float32 leaves an eval
    step returns), cast back to each leaf's dtype."""
    leaves = []
    context.map_tensors(leaves.append, metrics)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    rows = all_gather(flat)                      # (world, n)
    out, off = [], 0
    for t in leaves:
        n = t.numel()
        out.append(rows[:, off:off + n].reshape((-1,) + tuple(t.shape[1:]))
                   .to(t.dtype))
        off += n
    it = iter(out)
    return context.map_tensors(lambda _: next(it), metrics)


def make_eval_step(eval_fn: Callable) -> Callable:
    """An evaluation step ``step(model, batch) -> metrics``: no
    gradients, no update, the model in eval mode (its previous mode
    restored after). ``eval_fn(model, batch)`` returns per-example
    tensors (leading axis the local batch); at world > 1 the step returns
    every rank's in rank order, concatenated along axis 0, on every rank
    (the JAX step's global layout)."""

    def step(model, batch):
        with torch.no_grad(), _mode(model, False):
            metrics = eval_fn(model, batch)
        if context.get_world_size() > 1:
            metrics = _gather_ranks(metrics)
        return metrics

    return step


def make_stateful_eval_step(eval_fn: Callable) -> Callable:
    """:func:`make_eval_step` for a model with state: in eval mode the
    BatchNorm layers normalize with this rank's running stats (the
    model's buffers) and leave them unchanged."""
    return make_eval_step(eval_fn)


def stack_state(state, world: Optional[int] = None):
    """Each tensor of ``state`` repeated along a new leading axis of
    size ``world`` (default: the group's): every rank's state in one
    place, each starting from the same values."""
    w = world or context.get_world_size()
    return context.map_tensors(
        lambda t: t.unsqueeze(0).expand((w,) + tuple(t.shape)).clone(),
        state)


def make_scan_train_steps(loss_fn: Callable, optimizer: Optimizer,
                          n_steps: int, donate: Optional[bool] = None,
                          **kw) -> Callable:
    """``n_steps`` training steps in one call: ``run(model, opt_state,
    batches) -> (model, opt_state, losses)``, where every tensor of
    ``batches`` holds the steps' local batches stacked on a leading
    ``n_steps`` axis and ``losses`` is ``(n_steps, 1)``, this rank's
    loss per step. Each step is :func:`make_train_step`'s."""
    step = make_train_step(loss_fn, optimizer, donate=donate, **kw)

    def run(model, opt_state, batches):
        losses = []
        for t in range(n_steps):
            out = step(model, opt_state,
                       context.map_tensors(lambda b: b[t], batches))
            opt_state = out.opt_state
            losses.append(out.loss)
        return model, opt_state, torch.stack(losses)

    return run


class DataParallel(nn.Module):
    """``module`` prepared for data-parallel training: the result of
    :func:`prepare_ddp_model` at world > 1.

    Construction broadcasts rank 0's parameters and buffers to every
    rank (DDP's constructor contract); ``forward`` is the module's.
    Gradients are averaged by :func:`make_train_step`, once per step,
    so no autograd hook is installed (wrapping in torch's
    ``DistributedDataParallel`` as well would average them twice)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        sync_params(list(module.parameters()) + list(module.buffers()))

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def make_train_step(self, loss_fn: Callable, optimizer: Optimizer,
                        **kw) -> Callable:
        return make_train_step(loss_fn, optimizer, **kw)


def prepare_ddp_model(model: nn.Module, device_ids=None, *args, **kwargs):
    """``DataParallel(model)`` iff the world is larger than 1, else
    ``model`` itself (reference ``distributed.py:112-115``).
    ``device_ids`` and the rest are accepted for the reference's
    signature: rank r's model already lives on ``cuda:r``."""
    del device_ids, args, kwargs
    if context.get_world_size() > 1:
        return DataParallel(model)
    return model
