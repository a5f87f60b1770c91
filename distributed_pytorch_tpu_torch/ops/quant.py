"""int8 weights for inference, and the block codec of the quantized KV
pages, on tensors.

Counterpart of ``distributed_pytorch_tpu/ops/quant.py`` (the weight side,
the page codecs, and the gradient wire's :class:`ErrorFeedback` and
outlier statistic :func:`block_outlier_frac`).

**Weights**: symmetric per-channel int8, one f32 scale per output
channel, dequantized on the fly into the model dtype. The JAX package
stores a Linear W as (in, out) and scales over the contraction axis -2;
the port's ``Linear.weight`` is (out, in), so its scales run over axis
-1, one per output row: the same numbers, transposed. An ``Embedding``
table (vocab, dim) is laid out alike in both and keeps one scale per dim
column; a tied head reads the transposed table with the same scales.
:func:`quantize_tree` turns a model's eligible ``Linear`` / ``Embedding``
weights into ``weight_q`` (int8) and ``weight_scale`` (f32) buffers in
place; the layers read either form through :func:`resolve_weight`.

**KV pages**: the serving pool's q8/q4 pages are blocked on the grid of
``comm/wire.py`` (``QUANT_BLOCK`` C-order blocks over the flat ``(Hkv,
page_len, Dh)`` page), with its two snaps and its multiply by the f32
inverse, so a page quantized here is bit-identical to the numpy codec.
q4 pages are nibble-packed along the head dim, low nibble first.
"""

from __future__ import annotations

import torch
from torch import nn

import numpy as np

from ..comm import wire as _wire
from ..comm.wire import QUANT_BLOCK, num_blocks, quant_levels

# weight matrices smaller than this stay unquantized (LN scales, biases,
# tiny projections: no bandwidth to win, precision to lose)
DEFAULT_MIN_SIZE = 4096


def quantize_int8(w: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 of ``w``: scales ``max|w| / 127`` over
    ``axis`` (the contraction axis: -1 for a port ``Linear.weight`` (out,
    in), -2 for an ``Embedding`` table (vocab, dim)), floored at 1e-12.
    Returns ``(w_q int8, scale f32)`` with ``w ~= w_q * scale`` and
    ``scale`` of ``w``'s shape without ``axis``."""
    w32 = w.detach().to(torch.float32)
    scale = w32.abs().amax(dim=axis) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize(w_q: torch.Tensor, scale: torch.Tensor, dtype,
               axis: int = -1) -> torch.Tensor:
    """``w_q * scale`` in ``dtype``: both factors cast to ``dtype`` first
    and multiplied there, as the JAX package does (a float32 product
    cast afterwards would round differently at bf16)."""
    return w_q.to(dtype) * scale.unsqueeze(axis).to(dtype)


def is_quantized(mod: nn.Module) -> bool:
    return getattr(mod, "weight", None) is None and hasattr(mod, "weight_q")


def resolve_weight(mod: nn.Module) -> torch.Tensor:
    """The weight of a ``Linear`` / ``Embedding``: its parameter, or the
    dequantized int8 buffers :func:`quantize_tree` left in its place."""
    w = mod.weight
    if w is not None:
        return w
    if not hasattr(mod, "weight_q"):
        raise ValueError(f"{type(mod).__name__} holds neither 'weight' nor "
                         "the quantized pair 'weight_q'/'weight_scale'")
    return dequantize(mod.weight_q, mod.weight_scale, mod.weight_dtype,
                      mod.weight_axis)


def set_quantized(mod: nn.Module, w_q: torch.Tensor, scale: torch.Tensor,
                  dtype, axis: int) -> None:
    """Replace ``mod.weight`` with the int8 pair (buffers on the
    weight's device); it dequantizes into ``dtype``, its scales running
    over ``axis`` (-1 for a ``Linear``, -2 for an ``Embedding``)."""
    device = mod.weight.device if mod.weight is not None \
        else mod.weight_q.device
    mod.register_parameter("weight", None)
    mod.register_buffer("weight_q", w_q.to(device, torch.int8))
    mod.register_buffer("weight_scale", scale.to(device, torch.float32))
    mod.weight_dtype = dtype
    mod.weight_axis = axis


def quantize_tree(model: nn.Module, *,
                  min_size: int = DEFAULT_MIN_SIZE) -> nn.Module:
    """Quantize every eligible weight of ``model`` in place; returns it.

    Eligible: the weight of a ``Linear`` or ``Embedding`` with ndim >= 2
    and >= ``min_size`` elements. Biases, LayerNorm scales and small
    matrices stay as they are. For inference only (training on int8
    weights would quantize the gradient signal away)."""
    from ..nn.core import Embedding, Linear
    with torch.no_grad():
        for mod in model.modules():
            if not isinstance(mod, (Linear, Embedding)):
                continue
            w = mod.weight
            if w is None or w.ndim < 2 or w.numel() < min_size:
                continue
            axis = -2 if isinstance(mod, Embedding) else -1
            q, s = quantize_int8(w, axis)
            set_quantized(mod, q, s, w.dtype, axis)
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Parameter bytes of a (possibly quantized) model: its parameters
    and the int8 weights and scales; what decode streams per token."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    for mod in model.modules():
        if is_quantized(mod):
            total += (mod.weight_q.numel() * mod.weight_q.element_size()
                      + mod.weight_scale.numel()
                      * mod.weight_scale.element_size())
    return total


# ---------------------------------------------------------------------------
# the block codec (the tensor face of comm/wire.py)
# ---------------------------------------------------------------------------


def quantize_grad_blocks(v: torch.Tensor, bits: int = 8):
    """Symmetric per-block quantizer: ``v`` (..., block), the trailing
    axis one block. ``scale = amax / levels`` with the wire's two snaps
    (an all-zero block, or a block of integers with ``amax <= levels``,
    gets scale 1). Returns ``(q int8 (..., block), scale f32 (...,
    1))``; ``q`` stays one int8 per element at q4 (|q| <= 7)."""
    levels = torch.tensor(float(quant_levels(bits)), dtype=torch.float32,
                          device=v.device)
    v = v.to(torch.float32)
    amax = v.abs().amax(dim=-1, keepdim=True)
    int_exact = (amax <= levels) & (v == torch.round(v)).all(
        dim=-1, keepdim=True)
    unit = (amax == 0.0) | int_exact
    one = torch.ones((), dtype=torch.float32, device=v.device)
    scale = torch.where(unit, one, amax / levels)
    # quantize by the f32 inverse (multiply): the grid of comm/wire.py
    inv = torch.where(unit, one, levels / amax)
    q = torch.clamp(torch.round(v * inv), -levels, levels).to(torch.int8)
    return q, scale


def dequantize_grad_blocks(q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_grad_blocks` (f32 output)."""
    return q.to(torch.float32) * scale


def page_block_map(h_kv: int, page_len: int, dh: int,
                   device=None) -> torch.Tensor:
    """``(Hkv, page_len, Dh)`` int64 map of each page element to its
    scale block (flat C-order ``QUANT_BLOCK`` blocking: the wire's
    grid)."""
    e = h_kv * page_len * dh
    return (torch.arange(e, device=device) // QUANT_BLOCK) \
        .reshape(h_kv, page_len, dh)


def quantize_page_blocks(pages: torch.Tensor, bits: int):
    """Quantize whole pages onto the wire's block grid.

    ``pages``: ``(..., Hkv, page_len, Dh)``. Returns ``(q int8 unpacked,
    same shape; scales (..., nb) f32)``, ``nb = num_blocks(Hkv *
    page_len * Dh)``. The flat page is zero-padded to ``nb *
    QUANT_BLOCK`` first, which changes neither a block's amax nor its
    integer snap, so the result equals the numpy codec's on the unpadded
    page."""
    shape = pages.shape
    e = shape[-3] * shape[-2] * shape[-1]
    nb = num_blocks(e)
    lead = tuple(shape[:-3])
    flat = pages.to(torch.float32).reshape(lead + (e,))
    pad = nb * QUANT_BLOCK - e
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, scale = quantize_grad_blocks(
        flat.reshape(lead + (nb, QUANT_BLOCK)), bits=bits)
    q = q.reshape(lead + (nb * QUANT_BLOCK,))[..., :e].reshape(shape)
    return q, scale[..., 0]


def dequantize_page_blocks(q: torch.Tensor, scales: torch.Tensor,
                           block_map: torch.Tensor) -> torch.Tensor:
    """``q`` (..., Hkv, L, Dh) int8, ``scales`` (..., nb) and
    ``block_map`` from :func:`page_block_map` -> f32 pages."""
    return q.to(torch.float32) * scales[..., block_map]


def pack_page_nibbles(q: torch.Tensor) -> torch.Tensor:
    """``(..., Dh)`` int8 (|q| <= 7) -> ``(..., Dh // 2)`` uint8: pairs
    of flat-adjacent elements, low nibble first (``comm/wire.py``'s
    ``pack_nibbles`` byte for byte). Packs through uint8 masks on the
    two's-complement bits."""
    u = q.contiguous().view(torch.uint8)
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (lo & 0x0F) | ((hi & 0x0F) << 4)


def unpack_page_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_page_nibbles`: ``(..., Dh // 2)`` uint8 ->
    ``(..., Dh)`` int8, the nibbles sign-extended by arithmetic shifts
    of the int8 view."""
    b = packed.contiguous().view(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(b, 4), 4)
    hi = torch.bitwise_right_shift(b, 4)
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


# ---------------------------------------------------------------------------
# the gradient wire: the outlier statistic and error feedback
# ---------------------------------------------------------------------------


def block_outlier_frac(flat: torch.Tensor, block: int = QUANT_BLOCK,
                       thresh: float = _wire.DYNRANGE_THRESH
                       ) -> torch.Tensor:
    """The tensor twin of ``comm/wire.py``'s ``block_outlier_frac``: the
    fraction of nonzero blocks of ``flat`` whose ``amax / rms`` exceeds
    ``thresh``, as a 0-d f32 tensor on ``flat``'s device (the adaptive
    chooser's statistic, computed where the reduced bucket lives, so one
    scalar crosses to the host). All-zero blocks are neither counted nor
    hostile; the ragged tail's rms divides by its real element count."""
    flat = flat.to(torch.float32).reshape(-1)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    v = flat.reshape(-1, block)
    amax = v.abs().amax(dim=-1)
    counts = torch.full((v.shape[0],), float(block), dtype=torch.float32,
                        device=v.device)
    if pad:
        counts[-1] = block - pad
    rms = torch.sqrt(v.square().sum(dim=-1) / counts)
    valid = rms > 0.0
    hostile = valid & (amax > thresh * rms)
    return hostile.sum().to(torch.float32) / valid.sum().clamp_min(1)


class ErrorFeedback:
    """Error-feedback residual for repeated lossy gradient reduction
    (EF-SGD): step t's quantization error is added to step t+1's input,
    so what crosses the wire averages to the true gradient over steps.

    ``compensate(flat)`` adds the carried residual, rounds the sum onto
    the wire grid it will travel on (so the first hop is exact), keeps
    the new residual and returns the grid value. Host-resident numpy
    state, width-aware (``bits=4`` rounds onto the q4 grid); the
    residual survives width flips unchanged, being only the part not yet
    sent. The JAX package's ``ops/quant.py`` ``ErrorFeedback``."""

    def __init__(self, block: int = None, bits: int = 8):
        self.block = block or QUANT_BLOCK
        self.bits = bits
        self.residual = None

    def compensate(self, flat, bits: int = None) -> np.ndarray:
        bits = self.bits if bits is None else bits
        flat = np.ascontiguousarray(flat, dtype=np.float32).ravel()
        if self.residual is None or self.residual.size != flat.size:
            self.residual = np.zeros(flat.size, np.float32)
        e = flat + self.residual
        q, s = _wire.quantize_blocks(e, self.block, bits)
        grid = _wire.dequantize_blocks(q, s, self.block)
        self.residual = e - grid
        return grid
