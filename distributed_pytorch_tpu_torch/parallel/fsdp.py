"""FSDP / ZeRO: the sharded layout of parameters, gradients and optimizer
state over the ``dp`` axis of the mesh, and the ZeRO-1/2/3 train steps.

Counterpart of ``distributed_pytorch_tpu/parallel/fsdp.py``
(``fsdp_param_specs``, ``opt_state_specs``, ``shard_model_and_opt``,
``shard_layouts``, ``make_fsdp_train_step``, ``make_zero1_train_step``,
``make_zero2_train_step``). The spec trees are the JAX package's (the
JAX params tree's shape, a ``parallel.tensor.P`` at each leaf over the
JAX layout's dimensions); ``convert.spec_placements`` maps each onto its
port parameter's placement. On the TPU XLA derives the schedule from
the layout; here each rung is built from torch.distributed:

========  ==============================  ===============  ============
stage     parameters                      gradients        state
========  ==============================  ===============  ============
ZeRO-3    FSDP2 ``fully_shard``: gathered all-reduced      DTensor on
          per block for forward and       over dp and      the params'
          backward, 1/N between           scattered 1/N    placement
ZeRO-2    replicated                      reduce-scatter   1/N DTensor
ZeRO-1    replicated                      all-reduce       1/N DTensor
========  ==============================  ===============  ============

A parameter the spec leaves replicated (under ``min_size`` elements, or
with no divisible dimension) is left out of ``fully_shard``
(``ignored_params``); its gradient is still averaged over ``dp``. Under
ZeRO-1/2 each rank updates its 1/N slice of every sharded parameter in
place, and the slices are all-gathered back once per step. The
optimizer runs on DTensors in every rung, its state laid out as the
parameters' (``optim/__init__.py``; ``adamw_8bit``'s int8 codes as
the parameters, its block scales replicated).

Composes with tensor parallelism: ``parallel.tensor.tensor_parallel_lm``
first, then the step with ``fsdp_param_specs(model, n, base_specs=
transformer_lm_param_specs(model))`` on a dp x tp mesh.

The flat-bucket ``weight_update="sharded"`` of ``optim/sharded/`` is a
different layout and stays as it is. As in the JAX package, the ladder's
builders are shims over the front door (``front_door.make_step`` with
``specs=StepSpecs(...)``), whose constraint-ladder engine is
:func:`_ladder_step` here.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..comm import primitives as prim
from ..convert import spec_placements
from ..optim import Optimizer, Q8LogMoment, Q8Moment, q8_base
from ..runtime import env as _env
from ..runtime.context import DATA_AXIS
from .data_parallel import (MP_POLICIES, _average_grads, forward_backward,
                            mp_cast_params, step_output)
from .tensor import (P, jax_layout, replicated_specs, spec_axes,
                     specs_by_param, sub_mesh, tree_leaves, tree_map)


def fsdp_param_specs(params, n_shards: int, *, axis: str = "dp",
                     min_size: int = 1024, base_specs: Optional[Any] = None):
    """A spec tree sharding each leaf along ``axis``: per leaf (of the
    JAX layout of ``params``, a module or a tree of arrays), the largest
    dimension divisible by ``n_shards`` and not already taken by
    ``base_specs``; leaves smaller than ``min_size`` elements stay at
    their base spec (gathering tiny tensors costs more latency than
    their memory is worth)."""

    def pick(x, base):
        base_parts = tuple(base) if base is not None else ()
        shape = x.shape
        if not shape or x.size < min_size:
            return base if base is not None else P()
        parts = list(base_parts) + [None] * (len(shape) - len(base_parts))
        order = sorted(range(len(shape)), key=lambda i: shape[i],
                       reverse=True)
        for i in order:
            if parts[i] is None and shape[i] % n_shards == 0:
                parts[i] = axis
                return P(*parts)
        return base if base is not None else P()

    shapes = jax_layout(params)
    if base_specs is None:
        return tree_map(lambda x: pick(x, None), shapes)
    return tree_map(pick, shapes, base_specs)


def _per_param_list(node, n: int) -> bool:
    return (isinstance(node, list) and len(node) == n and n > 0
            and all(isinstance(x, (torch.Tensor, Q8Moment, Q8LogMoment))
                    for x in node))


def opt_state_specs(opt_state, param_specs, params):
    """The spec tree of a port optimizer state: ``opt_state`` (what
    ``optimizer.init(params.parameters())`` returned) with each
    per-parameter list of param-shaped tensors (moments, velocities,
    accumulators, float32 masters) replaced by the list of its
    parameters' specs, each int8 moment node (``adamw_8bit``) by one
    whose codes take the spec and whose block scales replicate, and
    everything else (step counts, adafactor's factored statistics) by
    ``P()``. ``params`` is the model: it maps each list entry to its JAX
    path (``convert.jax_param_slots``), and a list is param-shaped only
    where every shape matches (JAX ``opt_state_specs`` with ``params``).
    Read leaf by leaf through the same slots, it equals the JAX
    package's tree."""
    ps = list(params.parameters())
    specs = [spec for _, spec in specs_by_param(params, param_specs)]
    n = len(ps)

    def shaped(xs, attr=None):
        return all(tuple((getattr(x, attr) if attr else x).shape)
                   == tuple(p.shape) for x, p in zip(xs, ps))

    def conv(node):
        if _per_param_list(node, n):
            if all(isinstance(x, (Q8Moment, Q8LogMoment)) for x in node) \
                    and shaped(node, "q"):
                return [q8_base(x)(specs[i], *[P()] * (len(x) - 1))
                        for i, x in enumerate(node)]
            if all(isinstance(x, torch.Tensor) for x in node) \
                    and shaped(node):
                return list(specs)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(conv(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return P()

    return conv(opt_state)


def shard_layouts(params, opt_state=None, *, n_shards: int,
                  axis: str = "dp", min_size: int = 1024,
                  base_specs: Optional[Any] = None
                  ) -> Tuple[Any, Optional[Any], dict]:
    """The checkpoint-facing sharding contract ``(param_specs,
    opt_specs, axis_sizes)``: the specs of :func:`fsdp_param_specs` and
    :func:`opt_state_specs` (``None`` without ``opt_state``; then
    ``params`` may be a JAX-layout tree), and ``{axis: n_shards}``."""
    p_specs = fsdp_param_specs(params, n_shards, axis=axis,
                               min_size=min_size, base_specs=base_specs)
    o_specs = (opt_state_specs(opt_state, p_specs, params)
               if opt_state is not None else None)
    return p_specs, o_specs, {axis: int(n_shards)}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` under ``placements``
    (torch.chunk per sharded mesh dimension, DTensor's rule): a view."""
    for mdim, pl in enumerate(placements):
        if pl.is_shard():
            t = t.chunk(mesh.size(mdim), dim=pl.dim)[
                mesh.get_local_rank(mdim)]
    return t


def _wrap(local: torch.Tensor, mesh, placements, shape):
    """``local`` (kept, not copied) as the DTensor of global ``shape``."""
    DTensor = _dtensor()
    full = torch.empty(shape, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _layout_state(state, views):
    """A replicated optimizer state (from ``optimizer.init`` of the whole
    parameters, or restored) laid out as ``views`` (the optimizer's
    DTensor parameters): each param-shaped tensor becomes a DTensor in
    its parameter's placement holding its local piece, every other
    tensor (a statistic) a replicated DTensor on the same mesh. A
    DTensor state is already laid out and is returned as it is."""
    DTensor = _dtensor()
    from torch.distributed.tensor import Replicate
    n = len(views)

    def like(t, v, replicate=False):
        if not isinstance(v, DTensor):
            return t
        if isinstance(t, DTensor):
            if t.device_mesh == v.device_mesh and (
                    tuple(t.shape) != tuple(v.shape)
                    or tuple(t.placements) == tuple(v.placements)):
                return t
            # made on another layout (a tensor-parallel parameter's,
            # before the FSDP one): whole again, then laid out anew
            t = t.full_tensor()
        mesh = v.device_mesh
        if tuple(t.shape) == tuple(v.shape) and not replicate:
            out = torch.zeros_like(v, dtype=t.dtype)
            out.to_local().copy_(_local_chunk(t, mesh, v.placements))
            return out
        return DTensor.from_local(t.to(v.device_mesh.device_type).clone(),
                                  mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    def conv(node):
        if isinstance(node, list) and len(node) == n and n > 0 and all(
                isinstance(x, (Q8Moment, Q8LogMoment)) for x in node):
            # adamw_8bit: the codes as the parameter, the block scales
            # (and midpoints) replicated, as opt_state_specs places them
            return [type(x)(like(x.q, v), *(like(s, v, replicate=True)
                                            for s in x[1:]))
                    for x, v in zip(node, views)]
        if isinstance(node, list) and len(node) == n and n > 0 and all(
                isinstance(x, torch.Tensor) for x in node):
            return [like(t, v) for t, v in zip(node, views)]
        if isinstance(node, torch.Tensor):
            return like(node, views[0])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(conv(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node

    return conv(state)


def _is_dtensor(p) -> bool:
    return isinstance(p, _dtensor())


class _Layout(NamedTuple):
    """What a model laid out by :func:`shard_model_and_opt` keeps."""
    mesh: Any                 # the optimizer's mesh (dp, or dp x tp)
    placements: list          # per parameter, over ``mesh``
    ignored: frozenset        # ids of the parameters left replicated
    mixed_precision: str


def _step_mesh(mesh, param_specs, axis):
    axes = [axis] + [a for a in spec_axes(param_specs) if a != axis]
    return sub_mesh(mesh, axes)


def shard_model_and_opt(model: nn.Module, opt_state, mesh, param_specs, *,
                        axis: str = "dp",
                        mixed_precision: Optional[str] = None):
    """Lay ``model`` and its optimizer state out by the spec tree (the
    ZeRO-3 layout); returns ``(model, opt_state)``.

    Every block, then the model, goes through FSDP2 ``fully_shard`` on
    ``mesh[axis]``, each parameter sharded on the dimension its spec
    gives ``axis`` (through ``convert.spec_placements``: a Linear W's
    dimensions swap); a parameter whose spec does not name ``axis``
    stays as it is (``ignored_params``). Under ``mixed_precision="bf16"``
    (``None`` reads ``DPX_MP_POLICY``) the blocks compute in bfloat16
    from float32 masters and reduce gradients in float32
    (``MixedPrecisionPolicy``). ``opt_state``, built from the whole
    parameters (or restored into them), comes back laid out as the
    parameters. A model already laid out is not laid out again."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    mp = _resolve_mp(mixed_precision)
    layout = getattr(model, "_dpx_fsdp", None)
    if layout is None:
        step_mesh = _step_mesh(mesh, param_specs, axis)
        names = tuple(step_mesh.mesh_dim_names)
        slots = specs_by_param(model, param_specs)
        params = list(model.parameters())
        placements = [spec_placements(spec, slot, names)
                      for slot, spec in slots]
        k = names.index(axis)
        fsdp_dim = {id(p): pl[k] for p, pl in zip(params, placements)
                    if pl[k].is_shard()}
        ignored = {p for p in params if id(p) not in fsdp_dim}
        mp_policy = (MixedPrecisionPolicy(param_dtype=torch.bfloat16,
                                          reduce_dtype=torch.float32)
                     if mp == "bf16" else MixedPrecisionPolicy())

        def placement_fn(p):
            return fsdp_dim[id(p)]

        for unit in list(getattr(model, "blocks", ())) + [model]:
            fully_shard(unit, mesh=mesh[axis] if mesh.ndim > 1 else mesh,
                        shard_placement_fn=placement_fn,
                        ignored_params=ignored, mp_policy=mp_policy)
        layout = _Layout(step_mesh, placements,
                         frozenset(id(p) for p in ignored), mp)
        model._dpx_fsdp = layout
    elif layout.mixed_precision != mp:
        raise ValueError(
            f"the model was laid out with mixed_precision="
            f"{layout.mixed_precision!r}, not {mp!r}")
    if opt_state is not None:
        opt_state = _layout_state(opt_state, _zero3_views(model, layout))
    return model, opt_state


def _zero3_views(model, layout: _Layout, grads=None):
    """The optimizer's tensors of a ZeRO-3 model: its FSDP2 parameters
    (DTensors), and each parameter left replicated wrapped as a DTensor
    of its storage on the optimizer's mesh; with ``grads``, the same of
    the gradients instead."""
    params = list(model.parameters())
    src = params if grads is None else grads
    out = []
    for p, t, pl in zip(params, src, layout.placements):
        if t is None or id(p) not in layout.ignored:
            out.append(t)
            continue
        local = t.to_local() if _is_dtensor(t) else t
        out.append(_wrap(local.detach(), layout.mesh, pl, p.shape))
    return out


def _resolve_mp(mixed_precision: Optional[str]) -> str:
    mp = (_env.get("DPX_MP_POLICY") if mixed_precision is None
          else mixed_precision)
    if mp not in MP_POLICIES:
        raise ValueError(f"mixed_precision must be one of {MP_POLICIES}, "
                         f"got {mp!r}")
    return mp


def _same(a, b) -> bool:
    return tree_leaves(a) == tree_leaves(b)


def _sharded(specs, axis: str) -> bool:
    return axis in spec_axes(specs)


def make_fsdp_train_step(loss_fn: Callable, optimizer: Optimizer, mesh,
                         param_specs, state_specs: Optional[Any] = None,
                         grad_specs: Optional[Any] = None,
                         donate: Optional[bool] = None, *, axis: str = "dp",
                         mixed_precision: Optional[str] = None) -> Callable:
    """``step(model, opt_state, batch) -> StepOutput`` with the ZeRO
    layout of the three spec trees (each ``None`` defaults as the JAX
    package's: state to params, grads to state):

    ========  ============  ===========  ===========
    stage     param_specs   grad_specs   state_specs
    ========  ============  ===========  ===========
    ZeRO-3    sharded       sharded      sharded
    ZeRO-2    replicated    sharded      sharded
    ZeRO-1    replicated    replicated   sharded
    ========  ============  ===========  ===========

    ``loss_fn(model, batch) -> (loss, metrics)`` is the loss of this
    rank's local batch, as for ``make_train_step``. ZeRO-3 lays the
    model out at its first call (:func:`shard_model_and_opt`, unless
    done before) and every rung lays out an ``opt_state`` built from the
    whole parameters (``optimizer.init(model.parameters())``, or
    restored) as its state specs say; the laid-out state comes back in
    ``StepOutput.opt_state``. With all three replicated it is
    ``make_train_step``'s step. ``mixed_precision`` as in
    ``make_train_step``. The ZeRO-1 and ZeRO-2 rungs take a model whose
    parameters are replicated (not tensor-parallel).

    A shim over the front door (``front_door.make_step`` with
    ``specs=StepSpecs(params, opt, grads)``): the builder cache, the
    build counts, ``donate`` (keyed; the update is in place either way)
    and ``step.out_shardings`` for the reshard-free handoff come from
    there. The ladder shards over ``dp`` (``axis``)."""
    from .front_door import StepSpecs, make_step
    if axis != DATA_AXIS:
        raise ValueError(f"the front door's ladder shards over "
                         f"{DATA_AXIS!r}, not {axis!r}")
    return make_step(loss_fn, optimizer, mesh=mesh,
                     specs=StepSpecs(params=param_specs, opt=state_specs,
                                     grads=grad_specs),
                     donate=donate, mixed_precision=mixed_precision)


def _ladder_step(loss_fn, optimizer, mesh, param_specs, state_specs,
                 grad_specs, mp, axis: str = DATA_AXIS):
    """The constraint-ladder engine of the front door: the rung the spec
    trees name (``None`` defaults: state to params, grads to state)."""
    state_specs = param_specs if state_specs is None else state_specs
    grad_specs = state_specs if grad_specs is None else grad_specs
    if _sharded(param_specs, axis):
        if not (_same(grad_specs, param_specs)
                and _same(state_specs, param_specs)):
            raise ValueError("sharded parameters (ZeRO-3) take their "
                             "gradient and state specs from param_specs")
        return _make_zero3_step(loss_fn, optimizer, mesh, param_specs,
                                axis, mp)
    if not _sharded(state_specs, axis):
        from .data_parallel import _make_dist_train_step
        return _make_dist_train_step(forward_backward(loss_fn, mp),
                                     optimizer, "mean")
    if _same(grad_specs, state_specs):
        stage = 2
    elif _same(grad_specs, param_specs):
        stage = 1
    else:
        raise ValueError("grad_specs must be param_specs (ZeRO-1) or "
                         "state_specs (ZeRO-2)")
    return _make_zero12_step(loss_fn, optimizer, mesh, state_specs, axis,
                             mp, stage)


def _make_zero3_step(loss_fn, optimizer, mesh, param_specs, axis, mp):
    def cast_ignored(model):
        """FSDP2's policy casts the parameters it manages; the ignored
        ones read as their bf16 cast, as make_train_step's do."""
        return mp_cast_params(model, only=[
            p for p in model.parameters()
            if id(p) in model._dpx_fsdp.ignored])

    fb = forward_backward(loss_fn, mp, cast=cast_ignored)

    def step(model, opt_state, batch):
        model, opt_state = shard_model_and_opt(
            model, opt_state, mesh, param_specs, axis=axis,
            mixed_precision=mp)
        layout = model._dpx_fsdp
        dp = layout.mesh[axis] if layout.mesh.ndim > 1 else layout.mesh
        params, grads, loss, metrics = fb(model, batch)
        world = dp.size()
        small = [g for p, g in zip(params, grads)
                 if g is not None and id(p) in layout.ignored]
        if world > 1 and small:
            _average_grads([g.to_local() if _is_dtensor(g) else g
                            for g in small], world, dp.get_group())
        opt_state = optimizer.update(_zero3_views(model, layout, grads),
                                     opt_state,
                                     _zero3_views(model, layout))
        return step_output(model, opt_state, loss, metrics)

    return step


def _make_zero12_step(loss_fn, optimizer, mesh, state_specs, axis, mp,
                      stage):
    step_mesh = _step_mesh(mesh, state_specs, axis)
    if tuple(step_mesh.mesh_dim_names) != (axis,):
        raise ValueError(f"ZeRO-{stage} shards over {axis!r} alone; its "
                         f"state specs name {step_mesh.mesh_dim_names}")
    world = step_mesh.size()
    group = step_mesh.get_group() if world > 1 else None

    def layout_of(model):
        params = list(model.parameters())
        if any(_is_dtensor(p) for p in params):
            raise ValueError(
                f"ZeRO-{stage} takes a model with replicated parameters; "
                "compose tensor parallelism with make_fsdp_train_step")
        return [spec_placements(spec, slot, (axis,))
                for slot, spec in specs_by_param(model, state_specs)]

    def views(placements, tensors):
        return [None if t is None else
                _wrap(_local_chunk(t.detach(), step_mesh, pl), step_mesh, pl,
                      t.shape)
                for t, pl in zip(tensors, placements)]

    def reduce_grads(params, grads, placements):
        """ZeRO-1: the mean of every gradient (DDP's flat all-reduce);
        ZeRO-2: the mean of each sharded one reduce-scattered to this
        rank's slice (one flat reduce-scatter), the replicated ones
        all-reduced. Returns the optimizer's gradients."""
        live = [g for g in grads if g is not None]
        if world == 1 or not live:
            return views(placements, grads)
        if stage == 1:
            _average_grads(live, world, group)
            return views(placements, grads)
        shard = [i for i, (g, pl) in enumerate(zip(grads, placements))
                 if g is not None and pl[0].is_shard()]
        rep = [g for g, pl in zip(grads, placements)
               if g is not None and not pl[0].is_shard()]
        if rep:
            _average_grads(rep, world, group)
        out = views(placements, grads)
        if shard:
            rows = [torch.cat([grads[i].chunk(world, placements[i][0].dim)[r]
                               .reshape(-1).to(torch.float32)
                               for i in shard]) for r in range(world)]
            mine = prim.reduce_scatter(torch.cat(rows), group=group)
            mine /= world
            off = 0
            for i in shard:
                pl = placements[i]
                local = grads[i].chunk(world, pl[0].dim)[
                    step_mesh.get_local_rank()].contiguous()
                n = local.numel()
                local.copy_(mine[off:off + n].view_as(local))
                off += n
                out[i] = _wrap(local, step_mesh, pl, grads[i].shape)
        return out

    def gather_params(params, placements):
        """Every rank's updated slices back into the whole parameters:
        one flat all-gather."""
        shard = [(p, pl) for p, pl in zip(params, placements)
                 if pl[0].is_shard()]
        if world == 1 or not shard:
            return
        mine = torch.cat([_local_chunk(p.detach(), step_mesh, pl)
                          .reshape(-1) for p, pl in shard])
        rows = prim.all_gather(mine, group=group)
        with torch.no_grad():
            for r in range(world):
                off = 0
                for p, pl in shard:
                    piece = p.detach().chunk(world, pl[0].dim)[r]
                    n = piece.numel()
                    piece.copy_(rows[r, off:off + n].view_as(piece))
                    off += n

    fb = forward_backward(loss_fn, mp)

    def step(model, opt_state, batch):
        placements = layout_of(model)
        params, grads, loss, metrics = fb(model, batch)
        pviews = views(placements, params)
        opt_state = _layout_state(opt_state, pviews)
        opt_state = optimizer.update(reduce_grads(params, grads,
                                                  placements),
                                     opt_state, pviews)
        gather_params(params, placements)
        return step_output(model, opt_state, loss, metrics)

    return step


def make_zero1_train_step(loss_fn: Callable, optimizer: Optimizer, mesh,
                          params, *, axis: str = "dp", min_size: int = 1024,
                          donate: Optional[bool] = None,
                          mixed_precision: Optional[str] = None
                          ) -> Tuple[Callable, Any]:
    """ZeRO-1: replicated parameters and gradients (all-reduced, as DDP
    and torch's ZeroRedundancyOptimizer keep them), optimizer state
    sharded over ``axis`` (:func:`fsdp_param_specs` of ``params``, the
    model). Each rank updates its 1/N slice of every sharded parameter
    and the slices are all-gathered back once per step. Returns
    ``(step, state_specs)``; the step is the front door's
    (:func:`make_fsdp_train_step`)."""
    p_specs = replicated_specs(params)
    s_specs = fsdp_param_specs(params, _axis_size(mesh, axis), axis=axis,
                               min_size=min_size)
    step = make_fsdp_train_step(loss_fn, optimizer, mesh, p_specs,
                                state_specs=s_specs, grad_specs=p_specs,
                                donate=donate, axis=axis,
                                mixed_precision=mixed_precision)
    return step, s_specs


def make_zero2_train_step(loss_fn: Callable, optimizer: Optimizer, mesh,
                          params, *, axis: str = "dp", min_size: int = 1024,
                          donate: Optional[bool] = None,
                          mixed_precision: Optional[str] = None
                          ) -> Tuple[Callable, Any]:
    """ZeRO-2: replicated parameters, gradients reduce-scattered to each
    rank's 1/N slice (one flat reduce-scatter) beside its 1/N optimizer
    state over ``axis``; the updated slices all-gather back once per
    step. The same trajectory as ZeRO-1 and replicated DP. Returns
    ``(step, state_specs)``; the step is the front door's
    (:func:`make_fsdp_train_step`)."""
    p_specs = replicated_specs(params)
    s_specs = fsdp_param_specs(params, _axis_size(mesh, axis), axis=axis,
                               min_size=min_size)
    step = make_fsdp_train_step(loss_fn, optimizer, mesh, p_specs,
                                state_specs=s_specs, grad_specs=s_specs,
                                donate=donate, axis=axis,
                                mixed_precision=mixed_precision)
    return step, s_specs


def _axis_size(mesh, axis: str) -> int:
    return mesh[axis].size() if mesh.ndim > 1 else mesh.size()


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Inside the block every parameter of a ZeRO-3 model is whole (FSDP2
    ``unshard`` of each unit, ``reshard`` after), for code that reads
    them outside a forward, such as ``models/generate.py``'s decode.
    Collective: every rank enters it. A model not laid out by
    :func:`shard_model_and_opt` passes through."""
    from torch.distributed.fsdp import FSDPModule
    units = [m for m in model.modules() if isinstance(m, FSDPModule)]
    for unit in units:
        unit.unshard()
    try:
        yield model
    finally:
        for unit in units:
            unit.reshard()


def gather_state(model: nn.Module, opt_state=None):
    """``(params, opt_state)`` of a laid-out model and state as the JAX
    layout's trees of whole CPU tensors (``utils/checkpoint.py``'s
    ``jax_params`` / ``jax_opt_state``; a DTensor gathered with
    ``full_tensor``): what a format-1 checkpoint writes. Collective:
    every rank calls it, in the same order."""
    from ..utils.checkpoint import _host_copy, jax_opt_state, jax_params
    DTensor = _dtensor()

    def leaf(t):
        return _host_copy(t.full_tensor() if isinstance(t, DTensor) else t)

    p_tree = jax_params(model, leaf)
    o_tree = (jax_opt_state(opt_state, model, leaf)
              if opt_state is not None else None)
    return p_tree, o_tree


__all__ = ["fsdp_param_specs", "gather_state", "gathered",
           "make_fsdp_train_step", "make_zero1_train_step",
           "make_zero2_train_step", "opt_state_specs", "shard_layouts",
           "shard_model_and_opt"]
