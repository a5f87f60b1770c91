"""The block codec of the quantized wire, in numpy: the port's own copy.

Counterpart of the codec half of ``distributed_pytorch_tpu/comm/wire.py``
(the port imports nothing of the JAX package). The quantized KV pages of
the serving pool (``serve/pages/``) sit on exactly this grid, so the
host-side page codec and the in-program one (``ops/quant.py``) agree bit
for bit with it.

**Block codec**: a flat f32 payload is cut into blocks of
:data:`QUANT_BLOCK` elements (the last one ragged). Per block, with
``levels`` = 127 at 8 bits and 7 at 4 bits: ``amax = max|v|``; ``scale =
1`` if ``amax == 0``; ``scale = 1`` if every value is an integer with
``amax <= levels`` (small integer payloads round-trip exactly); else
``scale = amax / levels``. ``q = clip(rint(v * (levels / amax)), -levels,
levels)``: quantization multiplies by the f32 inverse, the form every
implementation of the grid shares.

**Nibbles**: the 4-bit form packs two two's-complement nibbles per byte,
low nibble first (:func:`pack_nibbles`).

**Byte accounting**: a quantized copy of ``n`` values is its payload
(:func:`payload_bytes`) plus one f32 scale per block
(:func:`quant_wire_bytes`); the disaggregated KV-page handoff frames
every page tensor on its own (:func:`handoff_page_wire_bytes`), which is
what ``serve/disagg/`` books as sent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: Elements per f32 scale.
QUANT_BLOCK = 1024

#: Bytes of one block's scale (one f32).
SCALE_BYTES = 4

#: Widths the codec speaks (bits per element).
WIRE_WIDTHS = (8, 4)


def quant_levels(bits: int) -> int:
    """Symmetric integer levels of a width: |q| <= levels."""
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"wire width must be one of {WIRE_WIDTHS}, got {bits}")


def num_blocks(n: int, block: int = QUANT_BLOCK) -> int:
    return (n + block - 1) // block


def payload_bytes(elems: int, bits: int = 8) -> int:
    """Payload bytes of ``elems`` quantized values, scales excluded: one
    byte each at 8 bits, two packed nibbles per byte at 4 (an odd tail
    pads a zero nibble)."""
    quant_levels(bits)
    return elems if bits == 8 else (elems + 1) // 2


def quant_wire_bytes(n: int, block: int = QUANT_BLOCK,
                     bits: int = 8) -> int:
    """Bytes of one quantized copy of an ``n``-value payload."""
    return payload_bytes(n, bits) + SCALE_BYTES * num_blocks(n, block)


def handoff_page_wire_bytes(page_elems: int, n_tensors: int,
                            block: int = QUANT_BLOCK,
                            bits: Optional[int] = 8) -> int:
    """Bytes of a KV-page handoff's page section: ``n_tensors`` page
    tensors of ``page_elems`` f32 values, each framed on its own (its
    scales are local to it). ``bits=None`` is the exact f32 wire, 4
    bytes per value and no scales."""
    if bits is None:
        return n_tensors * page_elems * 4
    return n_tensors * quant_wire_bytes(page_elems, block, bits)


def _block_codec(x: np.ndarray, block: int = QUANT_BLOCK,
                 bits: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block (dequantization scales, quantization inverses) of a flat
    f32 array (zero-padding the ragged tail changes neither amax nor the
    all-integer test)."""
    levels = np.float32(quant_levels(bits))
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    nb = num_blocks(x.size, block)
    pad = nb * block - x.size
    v = (np.pad(x, (0, pad)) if pad else x).reshape(nb, block)
    amax = np.abs(v).max(axis=1)
    # integer-exact snap: small integer payloads round-trip exactly
    unit = (amax == 0.0) | ((amax <= levels)
                            & (v == np.rint(v)).all(axis=1))
    safe = np.where(unit, np.float32(1.0), amax)  # no 0-div warnings
    one = np.float32(1.0)
    scales = np.where(unit, one, safe / levels)
    invs = np.where(unit, one, levels / safe)
    return scales.astype(np.float32), invs.astype(np.float32)


def quantize_blocks(x: np.ndarray, block: int = QUANT_BLOCK,
                    bits: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Flat f32 -> (int8 q of the same length, f32 scales per block).
    ``q`` is unpacked (one int8 per element, |q| <= levels) at either
    width; :func:`pack_nibbles` makes the 4-bit bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    levels = quant_levels(bits)
    scales, invs = _block_codec(x, block, bits)
    per_elem = np.repeat(invs, block)[:x.size]
    q = np.clip(np.rint(x * per_elem), -levels, levels).astype(np.int8)
    return q, scales


def dequantize_blocks(q: np.ndarray, scales: np.ndarray,
                      block: int = QUANT_BLOCK) -> np.ndarray:
    """(int8 q, f32 scales) -> f32 values (``q * scale`` per block)."""
    per_elem = np.repeat(scales.astype(np.float32), block)[:q.size]
    return q.astype(np.float32) * per_elem


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """int8 values in [-8, 7] -> packed uint8 bytes (two two's-complement
    nibbles per byte, low nibble first; an odd tail leaves the final
    high nibble zero)."""
    q = np.ascontiguousarray(q, dtype=np.int8)
    n = q.size
    u = (q.astype(np.uint8) & 0x0F)
    if n % 2:
        u = np.append(u, np.uint8(0))
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_nibbles`: ``n`` sign-extended int8 values."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lo = packed & 0x0F
    hi = packed >> 4
    u = np.empty(packed.size * 2, np.uint8)
    u[0::2] = lo
    u[1::2] = hi
    return ((u[:n] ^ 8).astype(np.int8) - np.int8(8))
