"""The KV-page handoff frame: how a finished prompt's cache crosses the
prefill -> decode boundary (``serve/disagg/``).

The port's copy of ``distributed_pytorch_tpu/serve/disagg/frames.py``,
byte for byte the same frames on the same inputs. One frame carries
what the decode engine needs to continue a request as if it had
prefilled the prompt itself:

- the **last-position logits** (vocab f32, always exact: token 0 is
  sampled from them, so they are never quantized), and
- the prompt's **resident KV pages**, per layer K then V, each page
  framed on its own through :mod:`...comm.wire`'s block codec at the
  chosen width: ``f32`` ships raw bytes (exact), ``q8``/``q4`` ship
  ``[per-page scales][payload]`` (~4x / ~7.9x fewer bytes; one page's
  scales never see another page's range).

**Integrity**: a CRC32C per page tensor plus one over the header and
logits (``ckpt.integrity.crc32c``, the host library's). A mismatch
decodes to a typed :class:`~..types.HandoffCorrupt` naming the request
and the first bad page.

**Accounting**: :func:`kv_wire_bytes` (``wire.handoff_page_wire_bytes``)
is what the transport books as sent.

Layout (little-endian)::

    i64[12] header: magic 'DPXH', version, request_id, bits(32|8|4),
                    n_layers, n_pages, h_kv, page_len, dh, length,
                    vocab, kv_bytes
    u32[1 + n_layers*2*n_pages] crc table: header+logits crc, then one
                    crc per page tensor (layer-major, K before V)
    f32[vocab]     last-position logits
    kv section     per layer, K pages then V pages, page-major
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ...ckpt.integrity import crc32c
from ...comm import wire
from ..types import HandoffCorrupt

MAGIC = 0x44505848          # 'DPXH'
VERSION = 1
_N_HDR = 12                 # i64 header words

#: Handoff widths (DPX_HANDOFF_WIDTH) → wire bits (None = exact f32).
HANDOFF_WIDTHS = {"f32": None, "q8": 8, "q4": 4}


def resolve_handoff_bits(width: str) -> Optional[int]:
    """Map a ``DPX_HANDOFF_WIDTH`` spelling onto wire bits; an unknown
    one raises (a mistyped width serving exact would hide the byte cut
    it was asked for)."""
    try:
        return HANDOFF_WIDTHS[width]
    except KeyError:
        raise ValueError(
            f"handoff width must be one of {sorted(HANDOFF_WIDTHS)}, "
            f"got {width!r}") from None


def kv_wire_bytes(n_layers: int, n_pages: int, page_elems: int,
                  bits: Optional[int]) -> int:
    """Bytes of the frame's KV section, the accounting the transport
    books (``wire.handoff_page_wire_bytes`` over the ``n_layers * 2 *
    n_pages`` page tensors)."""
    return wire.handoff_page_wire_bytes(page_elems, n_layers * 2 * n_pages,
                                        bits=bits)


def _encode_page(page: np.ndarray, bits: Optional[int]) -> bytes:
    flat = np.ascontiguousarray(page, np.float32).ravel()
    if bits is None:
        return flat.tobytes()
    q, scales = wire.quantize_blocks(flat, bits=bits)
    payload = wire.pack_nibbles(q) if bits == 4 else q.view(np.uint8)
    return scales.tobytes() + payload.tobytes()


def _encode_page_prequant(q_page: np.ndarray, scales: np.ndarray,
                          bits: int) -> bytes:
    """Frame one ALREADY-quantized page (unpacked int8 + per-block
    scales, the quantized pool's resident format) without touching the
    values: the same q codes :func:`_encode_page` would emit for the
    page's dequantized f32 image (pool and wire share one block codec),
    with the resident scales shipped verbatim — where the requantize
    trip's scales would pay a one-ulp double rounding. This is the
    no-double-hop half of the matched-width handoff pass-through."""
    q = np.ascontiguousarray(q_page, np.int8).ravel()
    payload = wire.pack_nibbles(q) if bits == 4 else q.view(np.uint8)
    return np.ascontiguousarray(scales, np.float32).tobytes() \
        + payload.tobytes()


def _decode_page(buf: memoryview, shape: Tuple[int, ...],
                 bits: Optional[int]) -> np.ndarray:
    n = int(np.prod(shape))
    if bits is None:
        return np.frombuffer(buf, np.float32, n).reshape(shape).copy()
    nb = wire.num_blocks(n)
    scales = np.frombuffer(buf, np.float32, nb)
    raw = np.frombuffer(buf[4 * nb:], np.uint8,
                        wire.payload_bytes(n, bits))
    q = wire.unpack_nibbles(raw, n) if bits == 4 else raw.view(np.int8)
    return wire.dequantize_blocks(q, scales).reshape(shape)


def _decode_page_raw(buf: memoryview, shape: Tuple[int, ...],
                     bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one quantized page WITHOUT dequantizing: ``(q unpacked
    int8 page-shaped, scales (nb,) f32)`` — fed straight into
    ``PagedSlotPool.adopt_quantized`` when the pool's resident width
    matches the wire's."""
    n = int(np.prod(shape))
    nb = wire.num_blocks(n)
    scales = np.frombuffer(buf, np.float32, nb).copy()
    raw = np.frombuffer(buf[4 * nb:], np.uint8,
                        wire.payload_bytes(n, bits))
    q = (wire.unpack_nibbles(raw, n) if bits == 4
         else raw.view(np.int8).copy())
    return q.reshape(shape), scales


@dataclass
class HandoffFrame:
    """A decoded handoff: the decode engine feeds ``ks``/``vs`` straight
    into ``PagedSlotPool.adopt`` and samples token 0 from ``logits``."""

    request_id: int
    length: int                 # prompt length S (pages cover ceil(S/L))
    bits: Optional[int]         # None = exact f32 wire
    logits: np.ndarray          # (vocab,) f32, always exact
    ks: List[np.ndarray]        # per layer (P, Hkv, page_len, Dh) f32;
    vs: List[np.ndarray]        # when quantized: per layer (q, scales)
    kv_bytes: int               # the booked/asserted wire accounting
    #: True when ``decode_frame(..., keep_bits=)`` matched the wire
    #: width and ks/vs carry ``(q unpacked int8, scales)`` tuples for
    #: ``adopt_quantized`` instead of dequantized f32 pages.
    quantized: bool = False


def encode_frame(request_id: int, length: int, logits: np.ndarray,
                 ks: List[np.ndarray], vs: List[np.ndarray],
                 bits: Optional[int]) -> Tuple[bytes, int]:
    """Serialize one handoff. Returns ``(frame bytes, kv_bytes)`` where
    ``kv_bytes`` is exactly :func:`kv_wire_bytes` for this shape — the
    number the transport books into CommStats."""
    if bits is not None:
        wire.quant_levels(bits)
    n_layers = len(ks)
    n_pages, h_kv, page_len, dh = ks[0].shape
    logits = np.ascontiguousarray(logits, np.float32).ravel()
    hdr = np.array([MAGIC, VERSION, request_id,
                    32 if bits is None else bits, n_layers, n_pages,
                    h_kv, page_len, dh, length, logits.size, 0],
                   np.int64)
    pages: List[bytes] = []
    for layer in range(n_layers):
        for tensor in (ks[layer], vs[layer]):
            for p in range(n_pages):
                pages.append(_encode_page(tensor[p], bits))
    kv_bytes = sum(len(p) for p in pages)
    hdr[11] = kv_bytes
    crcs = np.empty(1 + len(pages), np.uint32)
    crcs[0] = crc32c(hdr.tobytes() + logits.tobytes())
    for i, p in enumerate(pages):
        crcs[i + 1] = crc32c(p)
    return (hdr.tobytes() + crcs.tobytes() + logits.tobytes()
            + b"".join(pages)), kv_bytes


def encode_frame_quantized(request_id: int, length: int,
                           logits: np.ndarray, kqs, vqs,
                           bits: int) -> Tuple[bytes, int]:
    """Serialize one handoff from a quantized pool's RESIDENT bits
    (``PagedSlotPool.extract_quantized`` output: per layer ``(q
    unpacked int8 (P, Hkv, page_len, Dh), scales (P, nb))``) — same
    frame layout as :func:`encode_frame` and the same q codes an
    exact-extract + requantize trip would produce (pool and wire share
    one block codec), with the resident scales verbatim where the
    requantize trip would drift them by one ulp of double rounding."""
    wire.quant_levels(bits)
    n_layers = len(kqs)
    n_pages, h_kv, page_len, dh = kqs[0][0].shape
    logits = np.ascontiguousarray(logits, np.float32).ravel()
    hdr = np.array([MAGIC, VERSION, request_id, bits, n_layers, n_pages,
                    h_kv, page_len, dh, length, logits.size, 0],
                   np.int64)
    pages: List[bytes] = []
    for layer in range(n_layers):
        for q, scales in (kqs[layer], vqs[layer]):
            for p in range(n_pages):
                pages.append(_encode_page_prequant(q[p], scales[p], bits))
    kv_bytes = sum(len(p) for p in pages)
    hdr[11] = kv_bytes
    crcs = np.empty(1 + len(pages), np.uint32)
    crcs[0] = crc32c(hdr.tobytes() + logits.tobytes())
    for i, p in enumerate(pages):
        crcs[i + 1] = crc32c(p)
    return (hdr.tobytes() + crcs.tobytes() + logits.tobytes()
            + b"".join(pages)), kv_bytes


def decode_frame(buf, keep_bits: Optional[int] = None) -> HandoffFrame:
    """Parse + integrity-check a frame; raises a typed
    :class:`HandoffCorrupt` (request + first bad page + blamed engine)
    on any damage.

    ``keep_bits``: the receiving pool's resident quant width (or None).
    When it matches a quantized frame's wire width, pages are NOT
    dequantized — ks/vs carry ``(q, scales)`` tuples and ``quantized``
    is True, so the adopting pool installs the sender's exact resident
    bits (the decode half of the matched-width pass-through). Every
    CRC is still checked."""
    buf = memoryview(bytes(buf))
    if len(buf) < _N_HDR * 8:
        raise HandoffCorrupt(
            f"handoff frame truncated at {len(buf)} bytes (header needs "
            f"{_N_HDR * 8})", engine="transport", page=-1)
    hdr = np.frombuffer(buf, np.int64, _N_HDR)
    (magic, version, request_id, bits_w, n_layers, n_pages, h_kv,
     page_len, dh, length, vocab, kv_bytes) = (int(x) for x in hdr)
    if magic != MAGIC or version != VERSION:
        raise HandoffCorrupt(
            f"handoff frame bad magic/version "
            f"({magic:#x}/{version} != {MAGIC:#x}/{VERSION})",
            engine="transport", page=-1)
    # EVERY header field is validated before it sizes an allocation or
    # reaches the codec: a frame whose geometry words were damaged must
    # fail as a typed HandoffCorrupt the decode loop can attribute to
    # ONE request — an untyped ValueError/MemoryError here would escape
    # as a decode-loop crash and take down every resident stream
    if bits_w not in (32, 8, 4):
        raise HandoffCorrupt(
            f"handoff frame for request {request_id}: width word "
            f"{bits_w} is not one of 32|8|4 (header damaged)",
            request_id=request_id, engine="prefill", page=-1)
    geom = (n_layers, n_pages, h_kv, page_len, dh, length, vocab,
            kv_bytes)
    if any(x < 1 for x in geom[:5]) or any(x < 0 for x in geom[5:]) \
            or length > n_pages * page_len \
            or n_layers * 2 * n_pages > len(buf):
        raise HandoffCorrupt(
            f"handoff frame for request {request_id}: implausible "
            f"geometry {geom} for a {len(buf)}-byte frame (header "
            f"damaged)", request_id=request_id, engine="prefill",
            page=-1)
    bits = None if bits_w == 32 else bits_w
    n_tensors = n_layers * 2 * n_pages
    page_elems = h_kv * page_len * dh
    per_page = (page_elems * 4 if bits is None
                else wire.quant_wire_bytes(page_elems, bits=bits))
    off_crc = _N_HDR * 8
    off_logits = off_crc + 4 * (1 + n_tensors)
    off_kv = off_logits + 4 * vocab
    if len(buf) != off_kv + n_tensors * per_page or \
            kv_bytes != n_tensors * per_page:
        raise HandoffCorrupt(
            f"handoff frame for request {request_id} has {len(buf)} "
            f"bytes where the header implies "
            f"{off_kv + n_tensors * per_page}",
            request_id=request_id, engine="prefill", page=-1)
    crcs = np.frombuffer(buf, np.uint32, 1 + n_tensors, offset=off_crc)
    if crc32c(bytes(buf[:off_crc]) + bytes(buf[off_logits:off_kv])) \
            != int(crcs[0]):
        raise HandoffCorrupt(
            f"handoff frame for request {request_id} failed the "
            f"header/logits CRC32C", request_id=request_id,
            engine="prefill", page=-1)
    logits = np.frombuffer(buf, np.float32, vocab,
                           offset=off_logits).copy()
    shape = (h_kv, page_len, dh)
    keep = bits is not None and keep_bits == bits
    if keep:
        nb = wire.num_blocks(page_elems)
        ks = [(np.empty((n_pages,) + shape, np.int8),
               np.empty((n_pages, nb), np.float32))
              for _ in range(n_layers)]
        vs = [(np.empty((n_pages,) + shape, np.int8),
               np.empty((n_pages, nb), np.float32))
              for _ in range(n_layers)]
    else:
        ks = [np.empty((n_pages,) + shape, np.float32)
              for _ in range(n_layers)]
        vs = [np.empty((n_pages,) + shape, np.float32)
              for _ in range(n_layers)]
    idx = 0
    for layer in range(n_layers):
        for tensor in (ks[layer], vs[layer]):
            for p in range(n_pages):
                lo = off_kv + idx * per_page
                chunk = buf[lo:lo + per_page]
                if crc32c(bytes(chunk)) != int(crcs[1 + idx]):
                    raise HandoffCorrupt(
                        f"handoff frame for request {request_id}: page "
                        f"tensor {idx} (layer {layer}) failed CRC32C",
                        request_id=request_id, engine="prefill",
                        page=idx)
                if keep:
                    tensor[0][p], tensor[1][p] = _decode_page_raw(
                        chunk, shape, bits)
                else:
                    tensor[p] = _decode_page(chunk, shape, bits)
                idx += 1
    return HandoffFrame(request_id=request_id, length=length, bits=bits,
                        logits=logits, ks=ks, vs=vs, kv_bytes=kv_bytes,
                        quantized=keep)
