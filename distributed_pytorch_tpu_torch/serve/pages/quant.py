"""The paged pool's resident-KV widths and its host-side page codec.

Counterpart of ``distributed_pytorch_tpu/serve/pages/quant.py``.
``PagedSlotPool(kv_dtype=...)`` selects the pool's storage:

- ``"f32"`` (default): exact pages in the model dtype;
- ``"q8"`` / ``"q4"``: block-quantized pages, per layer int pages plus
  per-page-per-block f32 scales on the grid of ``comm/wire.py``
  (``QUANT_BLOCK`` C-order blocks over the flat ``(Hkv, page_len, Dh)``
  page). q4 pages are nibble-packed in pool memory (two two's-complement
  nibbles per byte, low nibble first).

Every element is quantized exactly once, from its exact value, when its
page completes: each slot's partial last page lives in a per-slot f32
tail buffer until position ``page_len - 1`` is written, so the codec's
single-rounding bound (per-element error <= scale / 2) holds for every
resident value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...comm import wire

#: Pool storage widths (``kv_dtype`` / DPX_SERVE_KV_DTYPE) -> quant bits
#: (None: exact pages in the model dtype).
KV_WIDTHS = {"f32": None, "q8": 8, "q4": 4}


def resolve_kv_bits(kv_dtype: str) -> Optional[int]:
    """Map a ``kv_dtype`` spelling onto quant bits; an unknown one
    raises (a mistyped width silently serving exact pages would hide
    the capacity it was asked for)."""
    try:
        return KV_WIDTHS[kv_dtype]
    except KeyError:
        raise ValueError(
            f"kv_dtype must be one of {sorted(KV_WIDTHS)}, "
            f"got {kv_dtype!r}") from None


def page_elems(h_kv: int, page_len: int, dh: int) -> int:
    return h_kv * page_len * dh


def num_page_blocks(h_kv: int, page_len: int, dh: int) -> int:
    """Scale blocks per page tensor: ``wire.num_blocks`` over the flat
    page."""
    return wire.num_blocks(page_elems(h_kv, page_len, dh))


def _padded_blocks(pages: np.ndarray) -> Tuple[np.ndarray, int]:
    """``(P, ...)`` pages -> ``(P, nb * QUANT_BLOCK)`` with each page's
    ragged last block zero-padded, and the page's element count."""
    n_pages = pages.shape[0]
    flat = pages.reshape(n_pages, -1)
    elems = flat.shape[1]
    pad = wire.num_blocks(elems) * wire.QUANT_BLOCK - elems
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    return flat, elems


def quantize_pages_np(pages: np.ndarray, bits: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 pages ``(P, Hkv, L, Dh)`` -> ``(q int8 unpacked, same shape;
    scales (P, nb) f32)`` on the wire's block grid, each page on its own
    (its ragged last block zero-padded, which changes neither its amax
    nor the all-integer test)."""
    pages = np.ascontiguousarray(pages, np.float32)
    flat, elems = _padded_blocks(pages)
    q, scales = wire.quantize_blocks(flat.ravel(), bits=bits)
    q = q.reshape(flat.shape)[:, :elems].reshape(pages.shape)
    return q, scales.reshape(pages.shape[0], -1)


def dequantize_pages_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Unpacked int8 pages + per-page-per-block scales -> f32 pages."""
    flat, elems = _padded_blocks(np.ascontiguousarray(q, np.int8))
    out = wire.dequantize_blocks(flat.ravel(), np.ascontiguousarray(
        scales, np.float32).ravel())
    return out.reshape(flat.shape)[:, :elems].reshape(q.shape)


def quantize_page_np(page: np.ndarray, bits: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """One f32 page ``(Hkv, L, Dh)`` -> ``(q int8 unpacked, same shape;
    scales (nb,) f32)`` on the wire's block grid."""
    q, scales = quantize_pages_np(np.asarray(page)[None], bits)
    return q[0], scales[0]


def dequantize_page_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Unpacked int8 page + per-block scales -> f32 page."""
    return dequantize_pages_np(np.asarray(q)[None],
                               np.asarray(scales)[None])[0]


def pack_pages_np(q: np.ndarray) -> np.ndarray:
    """Nibble-pack unpacked q4 pages ``(..., Dh)`` int8 -> ``(..., Dh //
    2)`` uint8 in the wire's byte order; ``Dh`` must be even (the pool
    checks it), so no pair straddles a row."""
    shape = q.shape[:-1] + (q.shape[-1] // 2,)
    return wire.pack_nibbles(np.ascontiguousarray(q, np.int8).ravel()) \
        .reshape(shape)


def unpack_pages_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_pages_np` (sign-extended int8)."""
    shape = packed.shape[:-1] + (packed.shape[-1] * 2,)
    n = int(np.prod(shape))
    return wire.unpack_nibbles(
        np.ascontiguousarray(packed, np.uint8).ravel(), n).reshape(shape)
