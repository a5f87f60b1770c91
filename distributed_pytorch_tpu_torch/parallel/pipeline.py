"""Pipeline parallelism over the ``pp`` mesh axis: the GPipe schedule
(autograd through it) and the memory-bounded 1F1B training schedule.

Counterpart of ``distributed_pytorch_tpu/parallel/pipeline.py``. Stage s
(rank s of the ``pp`` axis) holds its slice of a homogeneous layer stack
(:func:`stack_layer_params`: every parameter of identical blocks stacked
on a leading layer axis); the embedding and head stay outside, as
there. Stage parameters come as a dict of tensors: plain tensors are
this stage's slice (at one stage, the whole stack), DTensors the whole
stack sharded ``Shard(0)`` over ``pp`` (their local slice is the
stage's). ``stage_fn(stage_params, x_mb) -> y_mb`` maps one microbatch
through one stage (:func:`make_stage_fn` builds it from a block).

Activations move between stages with ``comm.primitives.line_shift(+1)``
and cotangents with ``line_shift(-1)``, once per tick on every rank (a
rank with nothing to send sends zeros), so every rank runs the same
sequence of point-to-point steps.

- **GPipe** (:func:`pipeline_apply`, :func:`make_gspmd_pipeline_fn`):
  T + S - 1 ticks; autograd runs through the whole schedule, the reverse
  pipeline coming from ``line_shift``'s gradient. Each tick's stage
  input reads the transport (stage 0 adds its microbatch to the zeros
  it receives) and the first input is a leaf that takes a gradient, so
  on every rank the ticks form one chain that ``backward()`` runs whole,
  meeting the transports in the same order as the peers. Activation
  memory grows with T.
- **1F1B** (:func:`make_pipeline_train_fn`, ``schedule="1f1b"``): the
  host-side tables of :func:`_build_1f1b_schedule` run tick by tick; a
  forward sub-slot runs without autograd and keeps its stage input in a
  ring of ``depth`` slots, a backward sub-slot recomputes that
  microbatch's forward from it and takes the gradient there
  (``torch.autograd.grad``: the loss's on the last stage, the received
  cotangent's elsewhere), so no autograd graph spans ticks and
  activation memory is O(S), not O(T).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from ..comm import primitives as prim


def _stage_axis(mesh, axis_name: str):
    """(group, n_stages, this stage's index) of ``mesh``'s axis."""
    from .spmd import _axis_group, _axis_size
    n = _axis_size(mesh, axis_name)
    if n == 1:
        return None, 1, 0
    group = _axis_group(mesh, axis_name)
    return group, n, prim.axis_index(group)


class _ReduceFromStages(torch.autograd.Function):
    """The sum over the stages forward (the last stage's outputs, the
    others' masked to zero, replicated); identity backward (every stage
    computes the same loss from them)."""

    @staticmethod
    def forward(ctx, x, group):
        return prim.psum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return {k: (v.to_local() if isinstance(v, DTensor) else v)
            for k, v in tree.items()}


def pipeline_apply(stage_params, microbatches, stage_fn, *, group=None,
                   n_stages: int = None, stage: int = None):
    """Run the GPipe schedule on this stage. ``microbatches`` (T, mb,
    ...) are the same on every stage (only stage 0 reads them). Returns
    the (T, mb, ...) outputs: the last stage's, zeros elsewhere (the
    caller reduces them over the stages)."""
    n_stages = prim.axis_size(group) if n_stages is None else n_stages
    my = prim.axis_index(group) if stage is None else stage
    n_micro = microbatches.shape[0]
    zeros = torch.zeros_like(microbatches[0])
    # the first input is a leaf that takes a gradient, so that on every
    # rank every transport lies on a path to a leaf and backward runs
    # every one of them (a peer waits for each)
    recv = zeros.clone().requires_grad_(torch.is_grad_enabled()
                                        and n_stages > 1)
    outs = []
    for t in range(n_micro + n_stages - 1):
        x = recv + microbatches[min(t, n_micro - 1)] if my == 0 else recv
        m = t - my
        # a stage with no microbatch this tick passes its input on (the
        # receiver idles too; nothing of it reaches an output)
        y = stage_fn(stage_params, x) if 0 <= m < n_micro else x
        if t >= n_stages - 1:
            outs.append(y if my == n_stages - 1 else y * 0.0)
        if t < n_micro + n_stages - 2:
            recv = prim.line_shift(y, group, 1) if n_stages > 1 else zeros
    return torch.stack(outs)


def _pad_batch(x, total: int):
    """``x`` padded with zero rows on axis 0 up to ``total`` rows (the
    padded rows carry weight 0)."""
    pad = total - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def make_gspmd_pipeline_fn(mesh, stage_fn: Callable, n_microbatches: int,
                           *, axis_name: str = "pp") -> Callable:
    """``fn(stage_params, x) -> y``: x (B, ...) padded to a multiple of
    ``n_microbatches`` rows, through every stage of the ``axis_name``
    axis of ``mesh``, the padding cut off; y on every stage
    (differentiable)."""
    def fn(stage_params, x):
        group, n_stages, my = _stage_axis(mesh, axis_name)
        b = x.shape[0]
        mb = -(-b // n_microbatches)
        micro = _pad_batch(x, mb * n_microbatches).reshape(
            n_microbatches, mb, *x.shape[1:])
        outs = pipeline_apply(_local(stage_params), micro, stage_fn,
                              group=group, n_stages=n_stages, stage=my)
        if n_stages > 1:
            outs = _ReduceFromStages.apply(outs, group)
        return outs.reshape(mb * n_microbatches, *outs.shape[2:])[:b]
    return fn


def _build_1f1b_schedule(n_stages: int, n_micro: int):
    """The host-side 1F1B tables: ``(fwd, bwd, depth)``, int32 (n_ticks,
    n_stages) tables of the microbatch each stage runs in the forward /
    backward sub-slot of each tick (-1 idle), and the ring depth a stage
    needs for the stage inputs it keeps. Microbatch m enters stage 0 at
    ``inject[m]`` and moves one stage a tick; the last stage runs its
    backward in the tick of its forward and the cotangent walks back one
    stage a tick; injection waits so that stage 0 never holds more than
    ``n_stages`` microbatches, which bounds every stage's ring."""
    S, T = n_stages, n_micro
    inject = []
    for m in range(T):
        if m < S:
            inject.append(m)
        else:
            inject.append(max(inject[m - 1] + 1,
                              inject[m - S] + 2 * (S - 1) + 1))
    n_ticks = inject[-1] + 2 * (S - 1) + 1
    fwd = -np.ones((n_ticks, S), np.int32)
    bwd = -np.ones((n_ticks, S), np.int32)
    for m, t0 in enumerate(inject):
        for s in range(S):
            fwd[t0 + s, s] = m
            bwd[t0 + (S - 1) + (S - 1 - s), s] = m
    depth = 1
    for s in range(S):
        live = 0
        for t in range(n_ticks):
            if fwd[t, s] >= 0:
                live += 1
                depth = max(depth, live)
            if bwd[t, s] >= 0:
                live -= 1
    return fwd, bwd, depth


def make_pipeline_train_fn(mesh, stage_fn: Callable, loss_fn: Callable,
                           n_microbatches: int, *, axis_name: str = "pp",
                           schedule: str = "1f1b") -> Callable:
    """A pipelined training step: ``fn(stage_params, x, targets) ->
    (loss, grads)``, ``grads`` a dict like ``stage_params`` (this stage's
    gradients of the mean loss; DTensors where the parameters are).
    ``loss_fn(y_mb, target_mb) -> (mb,)`` per-example losses: the batch
    is padded to a multiple of the microbatch count with weight-0 rows,
    and ``loss`` is the mean over the real rows, on every stage.
    ``schedule="1f1b"`` is the memory-bounded in-schedule backward,
    ``"gpipe"`` autograd through :func:`make_gspmd_pipeline_fn` (the
    same numbers, activation memory growing with T)."""
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")

    def split(x, targets):
        b = x.shape[0]
        mb = -(-b // n_microbatches)
        total = mb * n_microbatches
        w = (torch.arange(total, device=x.device) < b).to(torch.float32)
        return b, mb, total, w

    def wrap(stage_params, grads):
        from torch.distributed.tensor import DTensor
        out = {}
        for k, p in stage_params.items():
            g = grads[k]
            if isinstance(p, DTensor):
                g = DTensor.from_local(g, p.device_mesh, p.placements,
                                       run_check=False, shape=p.shape,
                                       stride=p.stride())
            out[k] = g
        return out

    if schedule == "gpipe":
        def fn(stage_params, x, targets):
            b, _, total, w = split(x, targets)
            params = _local(stage_params)
            dtypes = {k: v.dtype for k, v in params.items()}

            def cast_stage_fn(ps, xx):
                return stage_fn({k: v.to(dtypes[k]) for k, v in ps.items()},
                                xx)
            # float32 leaves, cast in every tick: the ticks' gradients
            # add up in float32
            local = {k: v.detach().to(torch.float32).requires_grad_(True)
                     for k, v in params.items()}
            pipe = make_gspmd_pipeline_fn(mesh, cast_stage_fn,
                                          n_microbatches,
                                          axis_name=axis_name)
            y = pipe(local, _pad_batch(x, total))
            loss = torch.sum(loss_fn(y, _pad_batch(targets, total)) * w) / b
            # backward() (not autograd.grad of the parameters alone, which
            # would prune a rank's transports that reach no parameter)
            loss.backward()
            grads = {k: (torch.zeros_like(params[k]) if p.grad is None
                         else p.grad.to(dtypes[k]))
                     for k, p in local.items()}
            return loss.detach(), wrap(stage_params, grads)
        return fn

    def fn(stage_params, x, targets):
        group, n_stages, my = _stage_axis(mesh, axis_name)
        fwd_tab, bwd_tab, depth = _build_1f1b_schedule(n_stages,
                                                       n_microbatches)
        b, mb, total, w = split(x, targets)
        micro_x = _pad_batch(x, total).reshape(n_microbatches, mb,
                                               *x.shape[1:])
        micro_t = _pad_batch(targets, total).reshape(
            n_microbatches, mb, *targets.shape[1:])
        micro_w = w.reshape(n_microbatches, mb)
        params = _local(stage_params)
        names = list(params)
        leaves = [params[k].detach() for k in names]
        # the microbatches' gradients add up in float32
        gacc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        ring = [None] * depth
        zeros = torch.zeros_like(micro_x[0])
        f_recv, b_recv = zeros, zeros
        is_first, is_last = my == 0, my == n_stages - 1
        for t in range(fwd_tab.shape[0]):
            # forward sub-slot: no autograd, the stage input kept
            fm = int(fwd_tab[t, my])
            y = zeros
            if fm >= 0:
                x_in = micro_x[fm] if is_first else f_recv
                with torch.no_grad():
                    y = stage_fn(dict(zip(names, leaves)), x_in)
                ring[fm % depth] = x_in
            # backward sub-slot: recompute from the kept input, then the
            # gradient of the loss (last stage) or of the cotangent
            bm = int(bwd_tab[t, my])
            dx = zeros
            if bm >= 0:
                with torch.enable_grad():
                    ps = [p.requires_grad_(True) for p in
                          (q.detach() for q in leaves)]
                    x_res = ring[bm % depth].detach().requires_grad_(True)
                    y_b = stage_fn(dict(zip(names, ps)), x_res)
                    if is_last:
                        lval = torch.sum(loss_fn(y_b, micro_t[bm])
                                         * micro_w[bm])
                        out = torch.autograd.grad(lval, ps + [x_res],
                                                  allow_unused=True)
                        loss_acc = loss_acc + lval.detach()
                    else:
                        out = torch.autograd.grad(y_b, ps + [x_res],
                                                  grad_outputs=b_recv,
                                                  allow_unused=True)
                for a, g in zip(gacc, out[:-1]):
                    if g is not None:
                        a += g
                if out[-1] is not None:
                    dx = out[-1]
            if n_stages > 1:
                f_recv = prim.line_shift(y.detach(), group, 1)
                b_recv = prim.line_shift(dx.detach(), group, -1)
        if n_stages > 1:
            loss_acc = prim.psum(loss_acc, group)
        grads = {k: (g / b).to(p.dtype) for k, g, p in
                 zip(names, gacc, leaves)}
        return loss_acc / b, wrap(stage_params, grads)

    return fn


def stack_layer_params(blocks) -> nn.Module:
    """Identical blocks as one module of their structure whose every
    parameter is the blocks' stacked on a new leading axis (the layout
    a pipeline shards over ``pp``); ``.n_stacked`` is the block count.
    The stack is a copy: the blocks are left as they are."""
    blocks = list(blocks)
    stack = copy.deepcopy(blocks[0])
    per_block = [dict(b.named_parameters()) for b in blocks]
    for mod_name, mod in stack.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{name}" if mod_name else name
            mod._parameters[name] = nn.Parameter(
                torch.stack([pb[full].detach() for pb in per_block]),
                requires_grad=p.requires_grad)
    stack.n_stacked = len(blocks)
    return stack


def make_stage_fn(block: nn.Module, **kwargs) -> Callable:
    """``stage_fn(stage_params, x)``: x through every layer of the stage,
    layer i being ``block`` run with the i-th slice of each stacked
    parameter (``torch.func.functional_call``; ``kwargs`` go to every
    call)."""
    from torch.func import functional_call

    def stage_fn(stage_params, x):
        n_layers = next(iter(stage_params.values())).shape[0]
        for i in range(n_layers):
            x = functional_call(block, {k: v[i] for k, v in
                                        stage_params.items()}, (x,), kwargs)
        return x
    return stage_fn


__all__ = ["make_gspmd_pipeline_fn", "make_pipeline_train_fn",
           "make_stage_fn", "pipeline_apply", "stack_layer_params"]
