"""Flash attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``distributed_pytorch_tpu/ops/flash_attention.py``
(forward only; the two backward kernels and the ``autograd.Function``
belong to the training slice). Layout as in the JAX package: q
(B, H, Sq, D), k/v (B, Hkv, Sk, D) with Hkv dividing H; outputs O
(B, H, Sq, D) in the input dtype and lse (B, H, Sq) float32.

- :func:`flash_attention_fwd_reference` is the plain blockwise
  online-softmax version. The CPU path and the tests use it;
  ``chip_smoke.py`` holds the kernel to it on the card.
- :func:`flash_attention_fwd_cuda` launches ``csrc/flash_attention_fwd.cu``
  (built at first use) and counts its launches in ``LAUNCHES``.
- :func:`flash_attention_with_lse` / :func:`flash_attention` validate
  the arguments as the JAX package does and dispatch on the tensor's
  device: CPU tensors take the plain version, CUDA tensors the kernel,
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
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: Launches of each kernel wrapper of this module; a wrapper adds one
#: where it launches its kernel and nowhere else.
LAUNCHES = {"flash_attention_fwd": 0}


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
            masked = torch.zeros(q1 - q0, k1 - k0, dtype=torch.bool,
                                 device=q.device)
            if causal:
                masked |= cols > rows + off - causal_offset
            if window is not None:
                masked |= cols <= rows + off - window
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


def _kernel_fn():
    fn = _build.load(KERNEL_SOURCE).dpx_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None,
                             window: Optional[int] = None,
                             causal_offset: int = 0, diag_offset: int = 0):
    """Launch the CUDA forward kernel on ``torch.cuda.current_stream()``;
    returns (O, lse). Takes CUDA tensors only, bf16 or f32, head size 64
    or 128, last axis contiguous; anything else raises."""
    tensors = (q, k, v)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("flash_attention_fwd_cuda takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,Sq,D) and k=v (B,Hkv,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _kv_head_group(h, h_kv)
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head size {HEAD_DIMS}, got {d}")
    if s_q < 1 or s_k < 1:
        raise ValueError(f"empty sequence: s_q={s_q}, s_k={s_k}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the last axis of q, k and v must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, h, h_kv, s_q, s_k, d,
                DTYPES.index(q.dtype), float(scale), int(causal),
                int(window) if window is not None else 0,
                int(causal_offset), int(diag_offset), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


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
    """softmax(q k^T * scale) v and its per-row log-sum-exp (B, H, Sq).

    CUDA tensors run the kernel, CPU tensors the plain version. Forward
    only: on CUDA an input that requires grad raises (the backward
    kernels come with the training slice)."""
    _validate(causal, window, causal_offset, diag_offset)
    kw = dict(causal=causal, scale=scale,
              window=int(window) if window is not None else None,
              causal_offset=int(causal_offset), diag_offset=int(diag_offset))
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "flash attention on CUDA is forward-only in this port: the "
                "backward kernels (dK/dV, dQ) and the autograd.Function "
                "arrive with the training slice; run under "
                "torch.inference_mode() or use dense_attention")
        return flash_attention_fwd_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, **kw)
    raise ValueError(f"flash attention runs on cuda or cpu, got "
                     f"{q.device}")


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
