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
update to a few launches per step on the card.

``torch.optim.AdamW`` is not used: with bfloat16 parameters it keeps
bfloat16 moments and computes another update. Here the moments are
float32 whatever the parameter dtype, and the update is computed in
float32 and cast back, as the JAX package does.
"""

from __future__ import annotations

from typing import (Any, Callable, Iterable, List, NamedTuple, Optional,
                    Sequence)

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
    parameter has no entry of that kind."""
    if scale_by_param is None:
        scale_by_param = lr is None

    def init(params):
        vr, vc, v = [], [], []
        for p in params:
            empty = torch.zeros((0,), dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                vr.append(torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device))
                vc.append(torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device))
                v.append(empty)
            else:
                vr.append(empty)
                vc.append(empty.clone())
                v.append(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
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
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
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


class Q8Moment(NamedTuple):
    q: torch.Tensor      # param-shaped int8 codes
    scale: torch.Tensor  # (ceil(size / block),) float32 block scales


class Q8LogMoment(NamedTuple):
    q: torch.Tensor      # param-shaped int8 codes, affine in log(v)
    scale: torch.Tensor  # per-block float32 code width
    mid: torch.Tensor    # per-block float32 midpoint


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


def _q8_quant(x: torch.Tensor, block: int = _Q8_BLOCK) -> Q8Moment:
    """Blockwise symmetric int8 codes of a float32 tensor: per-block
    amax / 127 scales, round half to even."""
    blocks = _blocks(x.reshape(-1), block)
    amax = blocks.abs().amax(dim=1)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.round(blocks / scale[:, None]).to(torch.int8)
    return Q8Moment(q=q.reshape(-1)[:x.numel()].reshape(x.shape),
                    scale=scale)


def _q8_dequant(qm: Q8Moment, shape, block: int = _Q8_BLOCK):
    blocks = _blocks(qm.q.reshape(-1).to(torch.float32), block)
    n = qm.q.numel()
    return (blocks * qm.scale[:, None]).reshape(-1)[:n].reshape(shape)


def _q8_quant_log(v: torch.Tensor, block: int = _Q8_BLOCK) -> Q8LogMoment:
    """Blockwise affine int8 codes of a non-negative tensor in the log
    domain: a code error is a relative error of v, and small entries
    keep a floor (``_Q8_VFLOOR``) instead of rounding to zero, which
    would blow up Adam's sqrt(v) + eps step. The last block is padded
    with its last value: a pad of 0 (v = 1) would widen its range."""
    blocks = _blocks(torch.log(v.reshape(-1) + _Q8_VFLOOR), block,
                     mode="replicate")
    lo, hi = blocks.amin(dim=1), blocks.amax(dim=1)
    scale = torch.where(hi > lo, (hi - lo) / 254.0, torch.ones_like(hi))
    mid = (hi + lo) / 2.0
    q = torch.round((blocks - mid[:, None]) / scale[:, None]).to(torch.int8)
    return Q8LogMoment(q=q.reshape(-1)[:v.numel()].reshape(v.shape),
                       scale=scale, mid=mid)


def _q8_dequant_log(qm: Q8LogMoment, shape, block: int = _Q8_BLOCK):
    blocks = _blocks(qm.q.reshape(-1).to(torch.float32), block)
    y = torch.exp(blocks * qm.scale[:, None] + qm.mid[:, None])
    n = qm.q.numel()
    return (y.reshape(-1)[:n] - _Q8_VFLOOR).clamp(min=0.0).reshape(shape)


def adamw_8bit(lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """AdamW whose moments are stored as blockwise int8 codes (256
    elements per block): the first moment linear (``_q8_quant``), the
    second in the log domain (``_q8_quant_log``), ~1/4 of
    :func:`adamw`'s state bytes. Each step dequantizes, applies the
    float32 AdamW arithmetic and requantizes, so the trajectory tracks
    :func:`adamw` closely but not exactly."""

    def init(params):
        mu, nu = [], []
        for p in params:
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            mu.append(_q8_quant(z))
            nu.append(_q8_quant_log(z))
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
            gf = g.to(torch.float32)
            m = b1 * _q8_dequant(mu[i], p.shape) + (1 - b1) * gf
            v = b2 * _q8_dequant_log(nu[i], p.shape) + (1 - b2) * gf * gf
            pf = p.to(torch.float32) * (1.0 - lr * weight_decay)
            p.copy_(pf - lr * (m / c1) / (torch.sqrt(v / c2) + eps))
            mu[i], nu[i] = _q8_quant(m), _q8_quant_log(v)
        return AdamW8bitState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


# the schedules and wrappers build on Optimizer: loaded after it
from . import schedules  # noqa: E402
from .schedules import (AccumState, EmaState, MasterState,  # noqa: E402
                        ScheduledState, accumulate, clip_by_global_norm,
                        constant, cosine_decay, ema_params, global_norm,
                        linear_warmup, warmup_cosine, with_clipping,
                        with_ema, with_master_f32, with_schedule)

__all__ = ["AccumState", "AdafactorState", "AdamW8bitState", "AdamWState",
           "EmaState", "MasterState", "Optimizer", "Q8LogMoment", "Q8Moment",
           "ScheduledState", "accumulate", "adafactor", "adamw",
           "adamw_8bit", "clip_by_global_norm", "constant", "cosine_decay",
           "ema_params", "global_norm", "linear_warmup", "schedules", "sgd",
           "warmup_cosine", "with_clipping", "with_ema", "with_master_f32",
           "with_schedule"]
