"""Optimizers as functions on tensors.

Counterpart of ``distributed_pytorch_tpu/optim/__init__.py`` (``sgd``,
``adamw``, ``adafactor``, ``adamw_8bit``; the schedules and wrappers
are in ``schedules.py``). An optimizer is an ``(init, update)`` pair as
in the JAX package, over a sequence of parameter tensors:
``init(params)`` returns the state, ``update(grads, state, params)``
writes the new parameters into ``params`` in place (PyTorch's habit;
the JAX package returns a new tree) and returns the new state. A
parameter whose gradient is ``None`` (a frozen one) is left as it is,
and so is its state. The multi-tensor ``torch._foreach_*`` ops keep the
update to a few launches per step on the card; ``adamw`` runs every
CUDA tensor (a DTensor's local shard) through one hand-written kernel
instead (``ops/adamw_fused.py``), one pass over memory with the same
float32 arithmetic.

``torch.optim.AdamW`` is not used: with bfloat16 parameters it keeps
bfloat16 moments and computes another update. Here the moments are
float32 whatever the parameter dtype, and the update is computed in
float32 and cast back, as the JAX package does.

Every state follows its parameter's placement: on a DTensor parameter
(the sharded layouts of ``parallel/fsdp.py``) a param-shaped state is a
DTensor on the same mesh with the same placements, so the update runs
on the local shard alone, and a statistic over the whole parameter
(adafactor's factored means and RMS, the global norm of
``with_clipping``) is the global one, as the JAX package's global-view
math gives. ``adamw_8bit``'s int8 codes follow the parameter's
placement and its per-block scales are replicated, each block's the
one of the whole parameter flattened in its JAX layout.
"""

from __future__ import annotations

from typing import (Any, Callable, Iterable, List, NamedTuple, Optional,
                    Sequence)

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor import zeros as _dtensor_zeros

from ..ops import adamw_fused as _adamw_fused

Tensors = Sequence[torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Iterable[torch.Tensor]], Any]
    update: Callable[[Tensors, Any, Tensors], Any]
    """update(grads, state, params) -> new_state; params updated in place"""


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros laid out like ``p``: on its device, and for a
    DTensor on its mesh with its placements."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def _replicated_zeros_f32(p: torch.Tensor, shape) -> torch.Tensor:
    """float32 zeros of ``shape`` on ``p``'s device; for a DTensor ``p``
    a DTensor replicated over its mesh (a statistic reduced over a
    dimension that may be sharded)."""
    if isinstance(p, DTensor):
        mesh = p.device_mesh
        return _dtensor_zeros(shape, dtype=torch.float32, device_mesh=mesh,
                              placements=[Replicate()] * mesh.ndim)
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _placed_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s placement (a DTensor redistributed; a plain
    tensor as it is): a reduction over a sharded dimension comes back
    partial, and the state it updates is not."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(
            like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _foreach_copy(dst, src) -> None:
    """``torch._foreach_copy_``; one ``copy_`` per tensor where the list
    holds DTensors, which have no multi-tensor copy."""
    dst, src = list(dst), list(src)
    if any(isinstance(d, DTensor) for d in dst):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        torch._foreach_copy_(dst, src)


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


def _adamw_foreach(grads, params, mu, nu, *, lr, b1, b2, eps, weight_decay,
                   c1, c2) -> None:
    """One AdamW step over the lists in place by ``torch._foreach_*``
    ops, sixteen passes over memory: the path of CPU tensors, and the
    fused kernel's yardstick on the card."""
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
    _foreach_copy(params, pf)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """AdamW with torch's default hyperparameters: bias-corrected
    moments kept in float32, decoupled weight decay
    ``p * (1 - lr * wd)`` before the Adam step, the step computed in
    float32 and cast back to each parameter's dtype. A parameter on a
    CUDA device (float32 or bfloat16, as its gradient; a DTensor's local
    shard) is updated by the fused kernel of ``ops/adamw_fused.py``,
    which repeats the ``_foreach`` chain's roundings on the card; a CPU
    one by the chain."""

    def init(params):
        params = list(params)
        return AdamWState(step=0, mu=[_zeros_f32(p) for p in params],
                          nu=[_zeros_f32(p) for p in params])

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
        hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay, c1=c1, c2=c2)
        fused, back, rest = _adamw_fused.split(grads, params, mu, nu)
        _adamw_fused.launch(fused, back, **hyper)
        if rest[0]:
            _adamw_fused.count_foreach(rest[1])
            _adamw_foreach(*rest, **hyper)
        return AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init, update)


class AdafactorState(NamedTuple):
    step: int
    vr: List[torch.Tensor]   # factored row second moments (ndim >= 2)
    vc: List[torch.Tensor]   # factored column second moments (ndim >= 2)
    v: List[torch.Tensor]    # full second moments (ndim < 2)


def adafactor(lr: Optional[float] = None, *, decay_pow: float = 0.8,
              clip_threshold: float = 1.0, eps1: float = 1e-30,
              eps2: float = 1e-3, weight_decay: float = 0.0,
              scale_by_param: Optional[bool] = None) -> Optimizer:
    """Adafactor (Shazeer & Stern), as the JAX package computes it: no
    first moment; for a parameter with ndim >= 2 the second moment is
    stored factored, a row vector and a column vector over the last two
    axes (O(rows + cols) state); smaller parameters keep a full one.
    beta2 = 1 - t^-decay_pow; updates are RMS-clipped to
    ``clip_threshold``; with ``lr=None`` the step is the relative
    min(1e-2, 1/sqrt(t)) * max(eps2, RMS(param)) (``scale_by_param``
    defaults to True exactly then). Decoupled weight decay as in
    :func:`adamw`; state in float32. An empty (0,) tensor stands where a
    parameter has no entry of that kind. On a DTensor parameter the
    factored moments are replicated over its mesh (the JAX package's
    ``opt_state_specs`` replicates them too) and hold the global
    means; a full moment follows the parameter's placement."""
    if scale_by_param is None:
        scale_by_param = lr is None

    def init(params):
        vr, vc, v = [], [], []
        for p in params:
            empty = _replicated_zeros_f32(p, (0,))
            if p.dim() >= 2:
                vr.append(_replicated_zeros_f32(p, p.shape[:-1]))
                vc.append(_replicated_zeros_f32(p, p.shape[:-2]
                                                + p.shape[-1:]))
                v.append(empty)
            else:
                vr.append(empty)
                vc.append(empty.clone())
                v.append(_zeros_f32(p))
        return AdafactorState(step=0, vr=vr, vc=vc, v=v)

    def rms(x):
        return torch.sqrt(torch.mean(x * x) + 1e-30)

    @torch.no_grad()
    def update(grads, state, params):
        grads, params = list(grads), list(params)
        if all(g is None for g in grads):
            return state
        step = state.step + 1
        t = np.float32(step)
        beta2 = float(np.float32(1.0) - t ** np.float32(-decay_pow))
        base = (float(np.float32(lr)) if lr is not None else
                float(min(np.float32(1e-2), np.float32(1.0) / np.sqrt(t))))
        for p, g, vr, vc, v in zip(params, grads, state.vr, state.vc,
                                   state.v):
            if g is None:
                continue
            gf = g.to(torch.float32)
            g2 = gf * gf + eps1
            if p.dim() >= 2:
                vr.mul_(beta2).add_(_placed_like(
                    (1 - beta2) * g2.mean(dim=-1), vr))
                vc.mul_(beta2).add_(_placed_like(
                    (1 - beta2) * g2.mean(dim=-2), vc))
                r = vr / vr.mean(dim=-1, keepdim=True)
                u = gf * torch.rsqrt(r)[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
            else:
                v.mul_(beta2).add_((1 - beta2) * g2)
                u = gf * torch.rsqrt(v)
            u = u / torch.clamp(rms(u) / clip_threshold, min=1.0)
            pf = p.to(torch.float32)
            alpha = base * (torch.clamp(rms(pf), min=eps2)
                            if scale_by_param else 1.0)
            p.copy_(pf * (1.0 - alpha * weight_decay) - alpha * u)
        return AdafactorState(step=step, vr=state.vr, vc=state.vc,
                              v=state.v)

    return Optimizer(init, update)


_Q8_BLOCK = 256      # elements per int8 block, one float32 scale each
_Q8_VFLOOR = 1e-12   # log-domain floor of the second moment


JAX_PERM = "_dpx_jax_perm"   # a parameter's permutation to its JAX layout


class Q8Moment(NamedTuple):
    q: torch.Tensor      # param-shaped int8 codes
    scale: torch.Tensor  # (ceil(size / block),) float32 block scales
    perm = None          # the blocks' order: see _q8_type


class Q8LogMoment(NamedTuple):
    q: torch.Tensor      # param-shaped int8 codes, affine in log(v)
    scale: torch.Tensor  # per-block float32 code width
    mid: torch.Tensor    # per-block float32 midpoint
    perm = None


_Q8_TYPES = {}


def _q8_type(base, perm):
    """``base`` (``Q8Moment`` or ``Q8LogMoment``) whose blocks run over
    the parameter permuted by ``perm`` (its JAX layout: a Linear W's
    (in, out), a conv kernel's HWIO), so that codes and scales mean what
    the JAX package's do. The codes stay param-shaped; the fields are
    ``base``'s, and ``perm`` rides on the type through every
    ``type(node)(...)`` that lays out, restores or updates the state.
    ``None`` is ``base``: the parameter's own order."""
    if perm is None:
        return base
    key = (base, tuple(perm))
    if key not in _Q8_TYPES:
        name = f"{base.__name__}_{'_'.join(map(str, perm))}"
        _Q8_TYPES[key] = type(name, (base,), {
            "__slots__": (), "perm": key[1], "__module__": __name__,
            "__reduce__": lambda self: (_q8_node, (base, key[1],
                                                   tuple(self)))})
    return _Q8_TYPES[key]


def _q8_node(base, perm, fields):
    """Unpickle a node of :func:`_q8_type` (its type is made anew)."""
    return _q8_type(base, perm)(*fields)


def q8_base(node):
    """The plain node type (``Q8Moment`` or ``Q8LogMoment``, the JAX
    package's fields) of an ``adamw_8bit`` moment node of any order."""
    return Q8LogMoment if isinstance(node, Q8LogMoment) else Q8Moment


def jax_perm(p: torch.Tensor):
    """The permutation that takes parameter ``p`` to its JAX layout
    (``None``: the same layout), as its module marked it."""
    return getattr(p, JAX_PERM, None)


def mark_jax_perm(t: torch.Tensor, perm) -> torch.Tensor:
    """Mark ``t`` as a parameter whose JAX layout is ``t.permute(perm)``
    (nothing for ``None``); returns ``t``. The mark is a Python
    attribute: a tensor made anew from a parameter (a copy, a DTensor, a
    stack) takes it over with this call."""
    if perm is not None:
        setattr(t, JAX_PERM, tuple(perm))
    return t


def _inverse(perm):
    return tuple(int(i) for i in np.argsort(perm))


def _to_order(x: torch.Tensor, perm):
    return x if perm is None else x.permute(perm)


def _from_order(x: torch.Tensor, perm):
    return x if perm is None else x.permute(_inverse(perm)).contiguous()


class AdamW8bitState(NamedTuple):
    step: int
    mu: List[Q8Moment]
    nu: List[Q8LogMoment]


def _blocks(flat: torch.Tensor, block: int, mode: str = "constant"):
    """``flat`` padded to whole blocks (zeros, or its last value with
    ``mode="replicate"``), as (n_blocks, block)."""
    pad = (-flat.numel()) % block
    if pad:
        if mode == "replicate":
            flat = torch.cat([flat, flat[-1:].expand(pad)])
        else:
            flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def _q8_quant(x: torch.Tensor, block: int = _Q8_BLOCK,
              perm=None) -> Q8Moment:
    """Blockwise symmetric int8 codes of a float32 tensor: per-block
    amax / 127 scales, round half to even; the blocks run over ``x``
    permuted by ``perm``."""
    xj = _to_order(x, perm)
    blocks = _blocks(xj.reshape(-1), block)
    amax = blocks.abs().amax(dim=1)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.round(blocks / scale[:, None]).to(torch.int8)
    q = q.reshape(-1)[:x.numel()].reshape(xj.shape)
    return _q8_type(Q8Moment, perm)(q=_from_order(q, perm), scale=scale)


def _q8_dequant(qm: Q8Moment, shape, block: int = _Q8_BLOCK):
    qj = _to_order(qm.q, qm.perm)
    blocks = _blocks(qj.reshape(-1).to(torch.float32), block)
    n = qm.q.numel()
    y = (blocks * qm.scale[:, None]).reshape(-1)[:n].reshape(qj.shape)
    return _from_order(y, qm.perm).reshape(shape)


def _q8_quant_log(v: torch.Tensor, block: int = _Q8_BLOCK,
                  perm=None) -> Q8LogMoment:
    """Blockwise affine int8 codes of a non-negative tensor in the log
    domain: a code error is a relative error of v, and small entries
    keep a floor (``_Q8_VFLOOR``) instead of rounding to zero, which
    would blow up Adam's sqrt(v) + eps step. The last block is padded
    with its last value: a pad of 0 (v = 1) would widen its range. The
    blocks run over ``v`` permuted by ``perm``."""
    vj = _to_order(v, perm)
    blocks = _blocks(torch.log(vj.reshape(-1) + _Q8_VFLOOR), block,
                     mode="replicate")
    lo, hi = blocks.amin(dim=1), blocks.amax(dim=1)
    scale = torch.where(hi > lo, (hi - lo) / 254.0, torch.ones_like(hi))
    mid = (hi + lo) / 2.0
    q = torch.round((blocks - mid[:, None]) / scale[:, None]).to(torch.int8)
    q = q.reshape(-1)[:v.numel()].reshape(vj.shape)
    return _q8_type(Q8LogMoment, perm)(q=_from_order(q, perm), scale=scale,
                                       mid=mid)


def _q8_dequant_log(qm: Q8LogMoment, shape, block: int = _Q8_BLOCK):
    qj = _to_order(qm.q, qm.perm)
    blocks = _blocks(qj.reshape(-1).to(torch.float32), block)
    y = torch.exp(blocks * qm.scale[:, None] + qm.mid[:, None])
    n = qm.q.numel()
    y = (y.reshape(-1)[:n] - _Q8_VFLOOR).clamp(min=0.0).reshape(qj.shape)
    return _from_order(y, qm.perm).reshape(shape)


class _ShardBlocks:
    """Where the elements of a DTensor's local shard fall among the
    ``block``-element blocks of the whole tensor flattened in the order
    ``perm`` gives (its JAX layout; ``None``: its own).

    A shard whose elements are one contiguous run of that flat order
    (in the tensor's own order, every ``Shard(0)`` layout and any layout
    over one rank) is kept as ``(start, n)``: its blocks are a
    contiguous range, reduced and expanded by a reshape, as the
    replicated quantizer does. Any other layout (a ``Shard(1)`` column
    shard, FSDP2's ``_StridedShard`` over a tensor-parallel dimension, a
    permuted order) keeps each local element's block id, from the
    shard's offset in every dimension or, for a strided layout, from the
    whole index tensor laid out as ``x``."""

    def __init__(self, x: DTensor, block: int, perm=None):
        from torch.distributed.tensor import Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        self.x, self.block, self.perm = x, block, perm
        self.n_blocks = -(-x.numel() // block)
        local = x.to_local()
        self.span = self.ids = None
        mesh, pls = x.device_mesh, tuple(x.placements)
        # each element's flat index in that order: strides of x's
        # dimensions in a contiguous tensor of the permuted shape
        meta = torch.empty(x.shape, device="meta")
        strides = (meta.stride() if perm is None else
                   torch.empty(meta.permute(perm).shape, device="meta")
                   .permute(_inverse(perm)).stride())
        if not all(type(pl) in (Shard, Replicate) for pl in pls):
            whole = torch.as_strided(
                torch.arange(x.numel(), device=local.device), x.shape,
                strides).contiguous()
            self.ids = DTensor.from_local(
                whole, mesh, [Replicate()] * mesh.ndim,
                run_check=False).redistribute(mesh, pls).to_local() \
                .reshape(-1) // block
            return
        shape, offset = compute_local_shape_and_global_offset(
            x.shape, mesh, pls)
        part = [d for d in range(x.dim()) if shape[d] != x.shape[d]]
        if perm is None and (
                not part or all(shape[d] == 1 for d in range(part[-1]))):
            self.span = (sum(o * st for o, st in zip(offset, strides)),
                         local.numel())
            return
        idx = torch.zeros([1] * x.dim(), dtype=torch.int64,
                          device=local.device)
        for d in range(x.dim()):
            view = [1] * x.dim()
            view[d] = -1
            idx = idx + ((torch.arange(shape[d], device=local.device)
                          + offset[d]) * strides[d]).view(view)
        self.ids = idx.expand(shape).reshape(-1) // block

    def _padded(self, vals: torch.Tensor) -> torch.Tensor:
        """Rows of a contiguous shard's values as (rows, blocks, block),
        each edge padded with the row's own edge value (a value of that
        block: no block's max moves)."""
        start, n = self.span
        front = start % self.block
        back = (-(front + n)) % self.block
        vals = torch.cat([vals[:, :1].expand(-1, front), vals,
                          vals[:, -1:].expand(-1, back)], dim=1)
        return vals.reshape(vals.shape[0], -1, self.block)

    def block_max(self, vals: torch.Tensor, init: float) -> torch.Tensor:
        """Per block of the whole tensor, the max of each row of ``vals``
        (rows of local values) over every shard: this shard's, then an
        all-reduce MAX over each mesh dimension that shards ``x``. Exact,
        so the result is the whole tensor's."""
        from ..comm import primitives as prim
        out = torch.full((vals.shape[0], self.n_blocks), init,
                         dtype=vals.dtype, device=vals.device)
        if self.span is not None:
            start, n = self.span
            if n:
                b0 = start // self.block
                m = self._padded(vals).amax(dim=2)
                out[:, b0:b0 + m.shape[1]] = m
        else:
            out.scatter_reduce_(1, self.ids.expand(vals.shape[0], -1), vals,
                                "amax", include_self=True)
        mesh = self.x.device_mesh
        for mdim, pl in enumerate(self.x.placements):
            # every sharding placement (a _StridedShard is no Shard)
            if not pl.is_replicate() and mesh.size(mdim) > 1:
                out = prim.pmax(out, group=mesh.get_group(mdim))
        return out

    def take(self, per_block: torch.Tensor) -> torch.Tensor:
        """A per-block vector's value at each local element (flat)."""
        if self.ids is not None:
            return per_block[self.ids]
        start, n = self.span
        b0 = start // self.block
        b1 = (start + n - 1) // self.block + 1 if n else b0
        front = start % self.block
        return per_block[b0:b1].repeat_interleave(self.block)[front:front + n]


def _local_like(t: torch.Tensor, x: DTensor) -> DTensor:
    """A local shard of ``x``'s shape as the DTensor laid out as ``x``."""
    return DTensor.from_local(t.reshape(x.to_local().shape), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _replicated(t: torch.Tensor, x: DTensor) -> DTensor:
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _q8_quant_sharded(x: DTensor, blocks: _ShardBlocks) -> Q8Moment:
    """:func:`_q8_quant` of a float32 DTensor from its local shard: the
    codes laid out as ``x``, the block scales replicated, both equal to
    those of the whole tensor bit for bit (a zero pad changes no block's
    amax, so none is needed)."""
    flat = x.to_local().reshape(-1)
    amax = blocks.block_max(flat.abs()[None], 0.0)[0]
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.round(flat / blocks.take(scale)).to(torch.int8)
    return _q8_type(Q8Moment, blocks.perm)(q=_local_like(q, x),
                                           scale=_replicated(scale, x))


def _q8_quant_log_sharded(v: DTensor, blocks: _ShardBlocks) -> Q8LogMoment:
    """:func:`_q8_quant_log` of a float32 DTensor from its local shard;
    the block min travels as the max of its negation (the last block's
    edge pad repeats a value of the block, so it changes neither)."""
    logv = torch.log(v.to_local().reshape(-1) + _Q8_VFLOOR)
    ext = blocks.block_max(torch.stack([logv, -logv]), float("-inf"))
    hi, lo = ext[0], -ext[1]
    scale = torch.where(hi > lo, (hi - lo) / 254.0, torch.ones_like(hi))
    mid = (hi + lo) / 2.0
    q = torch.round((logv - blocks.take(mid))
                    / blocks.take(scale)).to(torch.int8)
    return _q8_type(Q8LogMoment, blocks.perm)(
        q=_local_like(q, v), scale=_replicated(scale, v),
        mid=_replicated(mid, v))


def _q8_dequant_sharded(qm: Q8Moment, blocks: _ShardBlocks) -> torch.Tensor:
    """The local shard of :func:`_q8_dequant` (flat)."""
    return (qm.q.to_local().reshape(-1).to(torch.float32)
            * blocks.take(qm.scale.to_local()))


def _q8_dequant_log_sharded(qm: Q8LogMoment,
                            blocks: _ShardBlocks) -> torch.Tensor:
    y = torch.exp(qm.q.to_local().reshape(-1).to(torch.float32)
                  * blocks.take(qm.scale.to_local())
                  + blocks.take(qm.mid.to_local()))
    return (y - _Q8_VFLOOR).clamp(min=0.0)


def adamw_8bit(lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """AdamW whose moments are stored as blockwise int8 codes (256
    elements per block): the first moment linear (``_q8_quant``), the
    second in the log domain (``_q8_quant_log``), ~1/4 of
    :func:`adamw`'s state bytes. Each step dequantizes, applies the
    float32 AdamW arithmetic and requantizes, so the trajectory tracks
    :func:`adamw` closely but not exactly.

    The blocks run over each parameter in its JAX layout (a Linear W's
    (in, out), a conv kernel's HWIO: the permutation its module marks,
    :func:`jax_perm`), so that codes and scales mean what the JAX
    package's do and a checkpoint moves between the packages; the
    codes stay param-shaped, and the state's node types carry the
    order (``_q8_type``) from ``init`` on.

    On a DTensor (sharded) parameter the codes are a DTensor laid out as
    the parameter and the scales (and the log moment's midpoints) a
    replicated one, as the JAX package's ``opt_state_specs`` places
    them; the blocks stay those of the whole parameter. Each rank
    quantizes its own elements, with each block's amax (min and max)
    reduced over the shards, so codes, scales and the update equal the
    replicated step's bit for bit on the same gradients."""

    def init(params):
        mu, nu = [], []
        for p in params:
            z, perm = _zeros_f32(p), jax_perm(p)
            if isinstance(p, DTensor):
                blocks = _ShardBlocks(p, _Q8_BLOCK, perm)
                mu.append(_q8_quant_sharded(z, blocks))
                nu.append(_q8_quant_log_sharded(z, blocks))
            else:
                mu.append(_q8_quant(z, perm=perm))
                nu.append(_q8_quant_log(z, perm=perm))
        return AdamW8bitState(step=0, mu=mu, nu=nu)

    @torch.no_grad()
    def update(grads, state, params):
        grads, params = list(grads), list(params)
        if all(g is None for g in grads):
            return state
        step = state.step + 1
        t = np.float32(step)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        mu, nu = list(state.mu), list(state.nu)
        for i, (p, g) in enumerate(zip(params, grads)):
            if g is None:
                continue
            if isinstance(p, DTensor):
                blocks = _ShardBlocks(p, _Q8_BLOCK, mu[i].perm)
                pl = p.to_local()
                gf = _placed_like(g, p).to_local().reshape(-1).to(
                    torch.float32)
                m = b1 * _q8_dequant_sharded(mu[i], blocks) + (1 - b1) * gf
                v = (b2 * _q8_dequant_log_sharded(nu[i], blocks)
                     + (1 - b2) * gf * gf)
                pf = pl.reshape(-1).to(torch.float32) * (
                    1.0 - lr * weight_decay)
                pl.copy_((pf - lr * (m / c1) / (torch.sqrt(v / c2) + eps))
                         .view(pl.shape))
                mu[i] = _q8_quant_sharded(_local_like(m, p), blocks)
                nu[i] = _q8_quant_log_sharded(_local_like(v, p), blocks)
                continue
            gf = g.to(torch.float32)
            m = b1 * _q8_dequant(mu[i], p.shape) + (1 - b1) * gf
            v = b2 * _q8_dequant_log(nu[i], p.shape) + (1 - b2) * gf * gf
            pf = p.to(torch.float32) * (1.0 - lr * weight_decay)
            p.copy_(pf - lr * (m / c1) / (torch.sqrt(v / c2) + eps))
            mu[i] = _q8_quant(m, perm=mu[i].perm)
            nu[i] = _q8_quant_log(v, perm=nu[i].perm)
        return AdamW8bitState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


# the schedules and wrappers build on Optimizer: loaded after it
from . import schedules  # noqa: E402
from .schedules import (AccumState, EmaState, MasterState,  # noqa: E402
                        ScheduledState, accumulate, clip_by_global_norm,
                        constant, cosine_decay, ema_params, global_norm,
                        linear_warmup, warmup_cosine, with_clipping,
                        with_ema, with_master_f32, with_schedule)

# The sharded weight update (ZeRO-1), as the JAX package's ``optim``
# exports it: imported on first use (it builds on ``Optimizer`` above).
from .._lazy import lazy_exports  # noqa: E402

_SHARDED = ("FlatLayout", "ShardedOptimizer", "ShardedOptState",
            "build_layout", "shard_optimizer")
__getattr__, __dir__ = lazy_exports(__name__, {
    "sharded": (".sharded", None),
    **{name: (".sharded", name) for name in _SHARDED}})

__all__ = ["AccumState", "AdafactorState", "AdamW8bitState", "AdamWState",
           "EmaState", "MasterState", "Optimizer", "Q8LogMoment", "Q8Moment",
           "ScheduledState", "accumulate", "adafactor", "adamw",
           "adamw_8bit", "clip_by_global_norm", "constant", "cosine_decay",
           "ema_params", "global_norm", "jax_perm", "linear_warmup",
           "mark_jax_perm", "q8_base", "schedules", "sgd", "sharded",
           "warmup_cosine", "with_clipping", "with_ema", "with_master_f32",
           "with_schedule", *_SHARDED]
