"""Flash attention: the hand-written CUDA kernels (forward, dK/dV, dQ),
their plain PyTorch versions and the ``autograd.Function`` around them.

Counterpart of ``distributed_pytorch_tpu/ops/flash_attention.py``.
Layout as in the JAX package: q (B, H, Sq, D), k/v (B, Hkv, Sk, D) with
Hkv dividing H; outputs O (B, H, Sq, D) in the input dtype and lse
(B, H, Sq) float32.

- :func:`flash_attention_fwd_reference` / :func:`flash_attention_bwd_reference`
  are the plain blockwise versions. The CPU path and the tests use them;
  ``chip_smoke.py`` holds the kernels to them on the card.
- :func:`flash_attention_fwd_cuda` launches ``csrc/flash_attention_fwd.cu``,
  :func:`flash_attention_bwd_cuda` the two kernels of
  ``csrc/flash_attention_bwd.cu`` (built at first use); each wrapper
  counts its launches in ``LAUNCHES``. The C entries pick the design by
  dtype (:data:`DESIGNS`): bfloat16 runs the wgmma + TMA kernels,
  float32 the scalar-FMA ones.
- :func:`flash_attention_with_lse` / :func:`flash_attention` validate
  the arguments as the JAX package does and go through one
  ``autograd.Function`` (the JAX ``_flash_lse`` and its ``defvjp``) that
  returns a differentiable (O, lse) and dispatches on the tensor's
  device: CPU tensors take the plain versions, CUDA tensors the kernels,
  with no fallback between them.
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import Optional

import torch

from ..runtime import env as _env
from . import _build

# Large-negative mask value instead of -inf: -inf - (-inf) = NaN would
# poison the online-softmax rescaling of a fully masked tile.
_MASK = -0.7 * float(torch.finfo(torch.float32).max)

KERNEL_SOURCE = "flash_attention_fwd.cu"
BWD_KERNEL_SOURCE = "flash_attention_bwd.cu"
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: Compile-time tile overrides (``NAME=VALUE``) each source is built
#: with; empty means the defaults written in the sources. Only the tile
#: sweep (``ops/flash_tile_sweep.py``) sets them.
BUILD_DEFINES = {KERNEL_SOURCE: (), BWD_KERNEL_SOURCE: ()}

#: The kernel design each C entry runs, by kernel and dtype.
DESIGNS = {
    "flash_attention_fwd": {torch.bfloat16: "wgmma+tma",
                            torch.float32: "scalar_fma"},
    "flash_attention_bwd_dkv": {torch.bfloat16: "wgmma+tma",
                                torch.float32: "scalar_fma"},
    "flash_attention_bwd_dq": {torch.bfloat16: "wgmma+tma",
                               torch.float32: "scalar_fma"},
}

#: Launches of each kernel wrapper of this module; a wrapper adds one
#: where it launches its kernel and nowhere else.
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kv_head_group(h: int, h_kv: int) -> int:
    if h % h_kv:
        raise ValueError(f"n_heads {h} not divisible by kv heads {h_kv}")
    return h // h_kv


def _tile_range(q0: int, q1: int, *, block_k: int, n_k: int, off: int,
                causal: bool, window: Optional[int]):
    """k-tiles intersecting the visible band of query rows [q0, q1):
    the JAX package's ``_frontier_ok`` solved for the tile index."""
    lo, hi = 0, n_k - 1
    if causal:
        hi = min(hi, (q1 - 1 + off) // block_k)
        if window is not None:
            lo = max(0, (q0 + off - window + 1) // block_k)
    return lo, hi


def _tile_mask(rows, cols, *, off: int, causal: bool,
               window: Optional[int], causal_offset: int):
    """Logits to suppress in a tile of query ``rows`` (n, 1) by key
    ``cols`` (1, m), both inside the sequences (the JAX package's
    ``_tile_mask``; padded rows and keys never reach the plain versions,
    which slice instead of padding)."""
    masked = torch.zeros(rows.shape[0], cols.shape[1], dtype=torch.bool,
                         device=rows.device)
    if causal:
        masked |= cols > rows + off - causal_offset
    if window is not None:
        masked |= cols <= rows + off - window
    return masked


def flash_attention_fwd_reference(q, k, v, *, causal: bool = False,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  causal_offset: int = 0,
                                  diag_offset: int = 0,
                                  block_q: int = 64, block_k: int = 64):
    """Plain blockwise online-softmax forward; returns (O, lse).

    The same function as the kernel: f32 logits and statistics, p
    rounded to the input dtype for p@v, the finite ``_MASK`` sentinel,
    tiles outside the causal/window frontier skipped, NaN output for a
    row with no visible key (its lse is ``_MASK``)."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    g = _kv_head_group(h, h_kv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    off = s_k - s_q + diag_offset
    qg = q.reshape(b, h_kv, g, s_q, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    n_k = -(-s_k // block_k)
    outs, lses = [], []
    for q0 in range(0, s_q, block_q):
        q1 = min(q0 + block_q, s_q)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((b, h_kv, g, q1 - q0), _MASK, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (d,), dtype=torch.float32,
                          device=q.device)
        lo, hi = _tile_range(q0, q1, block_k=block_k, n_k=n_k, off=off,
                             causal=causal, window=window)
        for t in range(lo, hi + 1):
            k0, k1 = t * block_k, min((t + 1) * block_k, s_k)
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            s = torch.einsum("bngqd,bnkd->bngqk", qg[..., q0:q1, :],
                             kf[:, :, k0:k1]) * scale
            masked = _tile_mask(rows, cols, off=off, causal=causal,
                                window=window, causal_offset=causal_offset)
            s = s.masked_fill(masked, _MASK)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            pv = torch.einsum("bngqk,bnkd->bngqd",
                              p.to(v.dtype).to(torch.float32),
                              vf[:, :, k0:k1])
            acc = alpha[..., None] * acc + pv
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out = acc / l_safe[..., None]
        out = out.masked_fill((m == _MASK)[..., None], float("nan"))
        outs.append(out.to(q.dtype))
        lses.append(m + torch.log(l_safe))
    o = torch.cat(outs, dim=3).reshape(b, h, s_q, d)
    lse = torch.cat(lses, dim=3).reshape(b, h, s_q)
    return o, lse


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
             + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def _error(rc: int) -> str:
    """A C entry's nonzero return code in words."""
    return {-1: "unsupported dtype or head size",
            -2: "no TMA descriptor encoder in libcuda",
            -3: "a TMA descriptor the encoder refused"}.get(
                rc, f"CUDA error {rc}")


def _kernel_fn():
    fn = _build.load(KERNEL_SOURCE,
                     BUILD_DEFINES[KERNEL_SOURCE]).dpx_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(name: str, q, k, v, *more):
    """What the kernels take, checked before any pointer is passed:
    CUDA tensors on one device, one dtype of ``DTYPES``, q (B,H,Sq,D),
    k = v (B,Hkv,Sk,D), D in ``HEAD_DIMS``, last axis contiguous.
    ``more`` are further (B,H,Sq,D) tensors of q's dtype (O, dO).
    Returns (b, h, h_kv, s_q, s_k, d)."""
    tensors = (q, k, v) + more
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got "
                         f"{'/'.join(str(t.dtype) for t in tensors)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,Sq,D) and k=v (B,Hkv,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: O and dO must have q's shape "
                         f"{tuple(q.shape)}")
    _kv_head_group(h, h_kv)
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head size {HEAD_DIMS}, got {d}")
    if s_q < 1 or s_k < 1:
        raise ValueError(f"empty sequence: s_q={s_q}, s_k={s_k}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last axis of q, k and v must be contiguous")
    return b, h, h_kv, s_q, s_k, d


def _strides(t):
    """The element strides of a (B, heads, S, D) tensor's first three
    axes, with the stride of a size-1 axis (which torch leaves arbitrary
    and no load ever uses) replaced by its contiguous value."""
    (sb, sh, ss, _), (b, h, s, d) = t.stride(), t.shape
    return (sb if b > 1 else h * s * d, sh if h > 1 else s * d,
            ss if s > 1 else d)


def _tma_view(t):
    """``t`` itself when TMA can read it in place (16-byte aligned base,
    every stride but the last a multiple of 8 bf16 elements, as the
    model's fused-projection views are), else a contiguous copy: the
    bf16 kernels load their tiles through TMA descriptors built on the
    tensor's own strides."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in _strides(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _rows(t, ld: int):
    """A (B, H, S) float32 row term (lse, delta) with row stride ``ld``
    (S rounded up to a multiple of 4, so TMA's 16-byte stride rule
    holds) and a 16-byte aligned base: ``t`` itself when it already is,
    else a zero-padded copy."""
    if t.is_contiguous() and t.shape[-1] == ld and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(t.shape[:-1] + (ld,))
    out[..., :t.shape[-1]] = t
    return out


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None,
                             window: Optional[int] = None,
                             causal_offset: int = 0, diag_offset: int = 0):
    """Launch the CUDA forward kernel on ``torch.cuda.current_stream()``;
    returns (O, lse). Takes CUDA tensors only, bf16 or f32, head size 64
    or 128, last axis contiguous; anything else raises."""
    b, h, h_kv, s_q, s_k, d = _check_cuda_inputs(
        "flash_attention_fwd_cuda", q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_view(t) for t in (q, k, v))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(),
                *_strides(q), *_strides(k), *_strides(v),
                b, h, h_kv, s_q, s_k, d,
                DTYPES.index(q.dtype), float(scale), int(causal),
                int(window) if window is not None else 0,
                int(causal_offset), int(diag_offset), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward launch failed with "
                           f"{_error(rc)}")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def _delta(o, do, g_lse=None):
    """Row term of ``ds = p * (dp - delta)``: ``sum_d dO * O`` in float32
    (the JAX package's ``_flash_bwd`` host glue). A zero cotangent
    element contributes exactly zero even where O is NaN (rows with no
    visible key, which callers weight to zero), so such rows cannot
    poison the other rows of their tiles; an lse cotangent folds in as
    ``delta - g_lse`` (d lse / d s_j = p_j)."""
    gf, of = do.to(torch.float32), o.to(torch.float32)
    delta = torch.where(gf == 0.0, 0.0, gf * of).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.to(torch.float32)
    return delta


def flash_attention_bwd_reference(q, k, v, o, lse, do, g_lse=None, *,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  causal_offset: int = 0,
                                  diag_offset: int = 0,
                                  block_q: int = 64, block_k: int = 64):
    """Plain blockwise backward; returns (dQ, dK, dV).

    The same function as the two kernels: per visited tile,
    ``p = exp(s - lse)`` forced to exact zeros where masked, then
    ``dV += p^T dO``, ``dp = dO v^T``, ``ds = p (dp - delta) scale``,
    ``dK += ds^T q``, ``dQ += ds k``, every accumulator float32, with p
    and ds rounded to the input dtype before their products. dK/dV are
    summed over the GQA group in float32 and rounded once (the dK/dV
    kernel does the same in its registers; the TPU kernel rounds each
    q-head's part first). Tiles outside the causal/window frontier are
    skipped, as in the forward."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    g = _kv_head_group(h, h_kv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    off = s_k - s_q + diag_offset
    f32 = torch.float32
    delta = _delta(o, do, g_lse).reshape(b, h_kv, g, s_q)
    lse_g = lse.to(f32).reshape(b, h_kv, g, s_q)
    qg = q.reshape(b, h_kv, g, s_q, d).to(f32)
    dog = do.reshape(b, h_kv, g, s_q, d).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    dq = torch.zeros_like(qg)
    dk = torch.zeros(b, h_kv, s_k, d, dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    n_k = -(-s_k // block_k)
    for q0 in range(0, s_q, block_q):
        q1 = min(q0 + block_q, s_q)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        q_t, do_t = qg[..., q0:q1, :], dog[..., q0:q1, :]
        lo, hi = _tile_range(q0, q1, block_k=block_k, n_k=n_k, off=off,
                             causal=causal, window=window)
        for t in range(lo, hi + 1):
            k0, k1 = t * block_k, min((t + 1) * block_k, s_k)
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            k_t, v_t = kf[:, :, k0:k1], vf[:, :, k0:k1]
            masked = _tile_mask(rows, cols, off=off, causal=causal,
                                window=window, causal_offset=causal_offset)
            s = torch.einsum("bngqd,bnkd->bngqk", q_t, k_t) * scale
            p = torch.exp(s.masked_fill(masked, _MASK)
                          - lse_g[..., q0:q1, None])
            p = p.masked_fill(masked, 0.0)
            dv[:, :, k0:k1] += torch.einsum(
                "bngqk,bngqd->bnkd", p.to(do.dtype).to(f32), do_t)
            dp = torch.einsum("bngqd,bnkd->bngqk", do_t, v_t)
            ds = p * (dp - delta[..., q0:q1, None]) * scale
            ds = ds.to(q.dtype).to(f32)
            dk[:, :, k0:k1] += torch.einsum("bngqk,bngqd->bnkd", ds, q_t)
            dq[..., q0:q1, :] += torch.einsum("bngqk,bnkd->bngqd", ds, k_t)
    return (dq.reshape(b, h, s_q, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# q, k, v, dO, lse, delta, then the outputs, then _BWD_TAIL
_BWD_COMMON = [ctypes.c_void_p] * 6
_BWD_TAIL = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _bwd_kernel_fn(name: str, n_out: int):
    fn = getattr(_build.load(BWD_KERNEL_SOURCE,
                             BUILD_DEFINES[BWD_KERNEL_SOURCE]), name)
    if fn.argtypes is None:
        fn.argtypes = _BWD_COMMON + [ctypes.c_void_p] * n_out + _BWD_TAIL
        fn.restype = ctypes.c_int
    return fn


class FlashBwdLaunch:
    """One backward on the card: the checked inputs, the delta row term
    and the output buffers, shared by the dK/dV launch and the dQ launch.
    :func:`flash_attention_bwd_cuda` runs both; ``chip_smoke.py`` times
    each on its own."""

    def __init__(self, q, k, v, o, lse, do, g_lse=None, *,
                 causal: bool = False, scale: Optional[float] = None,
                 window: Optional[int] = None, causal_offset: int = 0,
                 diag_offset: int = 0):
        b, h, h_kv, s_q, s_k, d = _check_cuda_inputs(
            "flash_attention_bwd_cuda", q, k, v, o, do)
        if lse.shape != (b, h, s_q) or lse.dtype != torch.float32:
            raise ValueError(f"lse must be float32 {(b, h, s_q)}, got "
                             f"{lse.dtype} {tuple(lse.shape)}")
        # dO comes from autograd as a strided view; the kernels take its
        # strides and copy it only where its last axis is not contiguous
        # (or, for the bf16 TMA loads, where a stride is not 16 bytes)
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.dtype == torch.bfloat16:
            q, k, v, do = (_tma_view(t) for t in (q, k, v, do))
        self.q, self.k, self.v, self.do = q, k, v, do
        ld = -(-s_q // 4) * 4
        self.lse = _rows(lse, ld)
        self.delta = _rows(_delta(o, do, g_lse), ld)
        self.dq = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
        self.dk = torch.empty((b, h_kv, s_k, d), dtype=k.dtype,
                              device=k.device)
        self.dv = torch.empty_like(self.dk)
        # the ctypes array must outlive both launches: keep it here
        self.strides = (ctypes.c_longlong * 12)(
            *_strides(q), *_strides(k), *_strides(v), *_strides(do))
        scale = scale if scale is not None else 1.0 / math.sqrt(d)
        self.tail = (b, h, h_kv, s_q, s_k, d, ld, DTYPES.index(q.dtype),
                     float(scale), int(causal),
                     int(window) if window is not None else 0,
                     int(causal_offset), int(diag_offset))

    def _launch(self, name: str, outs, counter: str) -> None:
        fn = _bwd_kernel_fn(name, len(outs))
        q = self.q
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = fn(q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                    self.do.data_ptr(), self.lse.data_ptr(),
                    self.delta.data_ptr(), *(t.data_ptr() for t in outs),
                    self.strides, *self.tail, stream)
        if rc != 0:
            raise RuntimeError(f"flash attention backward launch {name} "
                               f"failed with {_error(rc)}")
        LAUNCHES[counter] += 1

    def launch_dkv(self) -> None:
        self._launch("dpx_flash_attention_bwd_dkv", (self.dk, self.dv),
                     "flash_attention_bwd_dkv")

    def launch_dq(self) -> None:
        self._launch("dpx_flash_attention_bwd_dq", (self.dq,),
                     "flash_attention_bwd_dq")


def flash_attention_bwd_cuda(q, k, v, o, lse, do, g_lse=None, *,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             window: Optional[int] = None,
                             causal_offset: int = 0, diag_offset: int = 0):
    """Launch the dK/dV and the dQ kernel on
    ``torch.cuda.current_stream()``; returns (dQ, dK, dV). The delta row
    term is elementwise torch work on the same stream (the JAX package
    also computes it outside Pallas). Takes CUDA tensors only, as
    :func:`flash_attention_fwd_cuda` does; anything else raises."""
    run = FlashBwdLaunch(q, k, v, o, lse, do, g_lse, causal=causal,
                         scale=scale, window=window,
                         causal_offset=causal_offset,
                         diag_offset=diag_offset)
    run.launch_dkv()
    run.launch_dq()
    return run.dq, run.dk, run.dv


class _FlashAttention(torch.autograd.Function):
    """Differentiable (O, lse): the JAX package's ``_flash_lse`` and its
    ``defvjp``. Forward saves (q, k, v, O, lse); backward takes the
    cotangents of both outputs (either may be ``None``, meaning zeros).
    CUDA tensors run the kernels, CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        fwd = (flash_attention_fwd_cuda if q.device.type == "cuda"
               else flash_attention_fwd_reference)
        o, lse = fwd(q, k, v, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        bwd = (flash_attention_bwd_cuda if q.device.type == "cuda"
               else flash_attention_bwd_reference)
        dq, dk, dv = bwd(q, k, v, o, lse, g_o, g_lse, **ctx.kw)
        return dq, dk, dv, None


def _validate(causal, window, causal_offset, diag_offset):
    """The JAX package's argument contract (flash_attention_with_lse)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is a causal-decoder pattern)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if causal_offset and not causal:
        raise ValueError("causal_offset shifts the causal frontier and "
                         "requires causal=True")
    if causal_offset and window is not None:
        raise ValueError("causal_offset cannot combine with window: the "
                         "window lower edge is anchored to the inclusive "
                         "diagonal, so the combination would silently "
                         "shrink the band to window-1 keys")
    if causal_offset not in (0, 1):
        raise ValueError(f"causal_offset must be 0 (include diagonal) or "
                         f"1 (strict), got {causal_offset}")
    if diag_offset and not causal:
        raise ValueError("diag_offset shifts the causal/window diagonal "
                         "and requires causal=True")


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None,
                             window: Optional[int] = None,
                             causal_offset: int = 0,
                             diag_offset: int = 0):
    """softmax(q k^T * scale) v and its per-row log-sum-exp (B, H, Sq),
    both differentiable (the lse cotangent folds into the backward's
    delta term). CUDA tensors run the kernels, CPU tensors the plain
    versions."""
    _validate(causal, window, causal_offset, diag_offset)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{q.device}")
    kw = dict(causal=causal, scale=scale,
              window=int(window) if window is not None else None,
              causal_offset=int(causal_offset), diag_offset=int(diag_offset))
    return _FlashAttention.apply(q, k, v, kw)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Drop-in for :func:`nn.attention.dense_attention` with O(S) memory."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)
    return o


#: Sentinel default for ``make_flash_attn_fn(min_seq_flash=...)``: read
#: ``DPX_FLASH_MIN_SEQ`` at build time (None/0 mean "always the kernel").
_MIN_SEQ_ENV = object()


def make_flash_attn_fn(window: Optional[int] = None,
                       min_seq_flash=_MIN_SEQ_ENV):
    """An ``attn_fn`` for models: attention through the flash kernel,
    with dense attention below ``min_seq_flash`` keys (default the
    ``DPX_FLASH_MIN_SEQ`` registry value; numerics identical either way).
    ``window`` bakes sliding-window attention into the model."""
    if min_seq_flash is _MIN_SEQ_ENV:
        min_seq_flash = int(_env.get("DPX_FLASH_MIN_SEQ"))
    logged = []

    def attn_fn(q, k, v, *, causal=False, scale=None):
        if min_seq_flash and k.shape[-2] < min_seq_flash:
            if not logged:
                logged.append(True)
                logging.getLogger(__name__).info(
                    "flash attn_fn: %d keys < min_seq_flash=%d, "
                    "dispatching to dense attention (logged once)",
                    k.shape[-2], min_seq_flash)
            from ..nn.attention import dense_attention
            return dense_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)

    # full-window flash computes exactly softmax(qk)v, so cached decode
    # may substitute its own core; a sliding window changes the function
    # and decode reads .window to switch to the rolling cache instead
    attn_fn.dense_equivalent = window is None
    attn_fn.window = window
    return attn_fn
