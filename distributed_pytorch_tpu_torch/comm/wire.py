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
what ``serve/disagg/`` books as sent. The rings' bytes are
:func:`ring_allreduce_wire_bytes` (exact f32),
:func:`quant_ring_allreduce_wire_bytes` and :func:`quant_leg_wire_bytes`.

**Ring schedule**: the ring splits ``n`` elements into ``world``
block-aligned segments (:func:`segment_blocks`); after the
reduce-scatter leg rank r owns segment ``(r + 1) % world``
(:func:`ring_owned_span`). Reduce-scatter: each hop quantizes the f32
partial of the outgoing segment and the receiver dequantize-accumulates
in f32. All-gather: each owner quantizes its reduced segment once,
adopts the dequantized value itself, and the bytes are forwarded
unchanged, so the result is bit-identical on every rank.
:func:`simulate_quant_ring` (and its two legs, and
:func:`simulate_hier_ring`) is the executable spec in numpy, bit-exact
against ``native/dpxhost.cpp``.

**Adaptive width**: :class:`WidthChooser` picks 8 or 4 bits per bucket
from the fraction of blocks whose ``amax / rms`` exceeds
:data:`DYNRANGE_THRESH` (:func:`block_outlier_frac`) on the previous
reduced bucket, flipping only after :data:`WIDTH_HYSTERESIS` equal
verdicts.

Everything here is the JAX package's ``comm/wire.py``, bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

#: Elements per f32 scale.
QUANT_BLOCK = 1024

#: Blocks per wire chunk of the native ring (256 KiB of int8 payload at
#: the default block): the native codec quantizes chunk i + 1 while chunk
#: i is on the wire.
QUANT_CHUNK_BLOCKS = 256

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


def block_scales(x: np.ndarray, block: int = QUANT_BLOCK,
                 bits: int = 8) -> np.ndarray:
    """Per-block dequantization scales of a flat f32 array."""
    return _block_codec(x, block, bits)[0]


def segment_blocks(n: int, world: int,
                   block: int = QUANT_BLOCK) -> List[Tuple[int, int]]:
    """Block-aligned ring segments: ``[(start_block, n_blocks)] * world``.

    Blocks are distributed as evenly as possible (first ``rem`` segments
    get one extra); a segment never splits a block, so no quantization
    scale ever spans two ranks' segments.
    """
    nb = num_blocks(n, block)
    base, rem = divmod(nb, world)
    out, start = [], 0
    for s in range(world):
        cnt = base + (1 if s < rem else 0)
        out.append((start, cnt))
        start += cnt
    return out


def block_span_elems(start_block: int, nblocks: int, n: int,
                     block: int = QUANT_BLOCK) -> Tuple[int, int]:
    """(element offset, element count) covered by a run of blocks."""
    lo = start_block * block
    hi = min((start_block + nblocks) * block, n)
    return lo, max(hi - lo, 0)


def span_wire_bytes(start_block: int, nblocks: int, n: int,
                    block: int = QUANT_BLOCK, bits: int = 8) -> int:
    """Wire bytes of a framed run of blocks: scales + quantized payload."""
    _, elems = block_span_elems(start_block, nblocks, n, block)
    return SCALE_BYTES * nblocks + payload_bytes(elems, bits)


def ring_allreduce_wire_bytes(n: int, world: int, elem_size: int = 4) -> int:
    """Total wire bytes (all ranks, both legs) of the full-width ring
    all-reduce (``native/dpxhost.cpp:ring_allreduce``): 2*(world-1) hops
    per segment, segments of ceil(n/world) elements (last ragged)."""
    if world <= 1:
        return 0
    chunk = (n + world - 1) // world
    total_seg_elems = 0
    for s in range(world):
        lo = chunk * s
        total_seg_elems += max(min(lo + chunk, n) - lo, 0)
    return 2 * (world - 1) * total_seg_elems * elem_size


def quant_ring_allreduce_wire_bytes(n: int, world: int,
                                    block: int = QUANT_BLOCK,
                                    bits: int = 8) -> int:
    """Total wire bytes (all ranks, both legs) of the quantized ring
    (``dpx_allreduce_q8`` / ``dpx_allreduce_qn``): each segment travels
    world-1 hops per leg in framed payload+scales form."""
    if world <= 1:
        return 0
    total = 0
    for start, cnt in segment_blocks(n, world, block):
        total += 2 * (world - 1) * span_wire_bytes(start, cnt, n, block,
                                                  bits)
    return total


def quant_leg_wire_bytes(n: int, world: int, block: int = QUANT_BLOCK,
                         bits: int = 8) -> int:
    """Total wire bytes (all ranks) of ONE leg of the quantized ring —
    ``dpx_reduce_scatter_q8`` or ``dpx_allgather_q8`` each move exactly
    half of :func:`quant_ring_allreduce_wire_bytes` (every segment
    travels world-1 hops once per leg)."""
    if world <= 1:
        return 0
    total = 0
    for start, cnt in segment_blocks(n, world, block):
        total += (world - 1) * span_wire_bytes(start, cnt, n, block, bits)
    return total


def ring_owned_span(n: int, world: int, rank: int,
                    block: int = QUANT_BLOCK) -> Tuple[int, int]:
    """(element offset, element count) of the segment rank ``rank`` OWNS
    after the ring reduce-scatter leg — segment ``(rank+1) % world`` of
    the block-aligned grid (the same ownership convention as
    ``native/dpxhost.cpp``'s ring schedule)."""
    seg = (rank + 1) % world
    start, cnt = segment_blocks(n, world, block)[seg]
    return block_span_elems(start, cnt, n, block)


# ---------------------------------------------------------------------------
# executable spec: the quantized ring, simulated in numpy
# ---------------------------------------------------------------------------


def _seg_spans(n: int, w: int, block: int) -> List[slice]:
    """Per-segment element slices, computed ONCE per simulation (the
    hop loops index it O(world^2) times)."""
    out = []
    for start, cnt in segment_blocks(n, w, block):
        lo, elems = block_span_elems(start, cnt, n, block)
        out.append(slice(lo, lo + elems))
    return out


def simulate_quant_reduce_scatter(per_rank: Sequence[np.ndarray],
                                  block: int = QUANT_BLOCK,
                                  bits: int = 8
                                  ) -> Tuple[List[np.ndarray], int]:
    """The reduce-scatter LEG of the quantized ring, simulated.

    ``per_rank``: one equal-shape array per rank. Returns ``(buffers,
    wire_bytes)`` where ``buffers[r]`` is rank r's FLAT working buffer
    after the leg: the span :func:`ring_owned_span` ``(n, w, r)`` holds
    the full (lossily accumulated) SUM of that segment; every other span
    holds a partial accumulation (undefined to callers — exactly the
    ``dpx_reduce_scatter_q8`` contract, bit for bit)."""
    w = len(per_rank)
    data = [np.ascontiguousarray(x, dtype=np.float32).ravel().copy()
            for x in per_rank]
    n = data[0].size
    if w == 1:
        return data, 0
    spans = _seg_spans(n, w, block)
    bytes_moved = 0
    # quantize the outgoing f32 partial each hop, receiver dequantize-
    # accumulates (all sends of a step happen "at once": quantize from
    # the pre-step snapshot, like the real ring)
    for step in range(w - 1):
        sends = {}
        for r in range(w):
            send_seg = (r - step) % w
            q, s = quantize_blocks(data[r][spans[send_seg]], block, bits)
            sends[r] = (q, s)
            bytes_moved += payload_bytes(q.size, bits) \
                + SCALE_BYTES * s.size
        for r in range(w):
            recv_seg = (r - step - 1) % w
            q, s = sends[(r - 1) % w]
            data[r][spans[recv_seg]] += dequantize_blocks(q, s, block)
    return data, bytes_moved


def simulate_quant_allgather(per_rank: Sequence[np.ndarray],
                             block: int = QUANT_BLOCK,
                             bits: int = 8
                             ) -> Tuple[List[np.ndarray], int]:
    """The byte-forwarding all-gather LEG of the quantized ring,
    simulated. Rank r contributes the span :func:`ring_owned_span`
    ``(n, w, r)`` of its flat buffer; afterwards every rank's buffer is
    BIT-IDENTICAL (each span is the dequantized grid of its owner's
    bytes, owner included). Mirrors ``dpx_allgather_q8`` bit for bit."""
    w = len(per_rank)
    data = [np.ascontiguousarray(x, dtype=np.float32).ravel().copy()
            for x in per_rank]
    n = data[0].size
    if w == 1:
        return data, 0
    spans = _seg_spans(n, w, block)
    bytes_moved = 0
    wires = {}
    for r in range(w):
        own = (r + 1) % w
        q, s = quantize_blocks(data[r][spans[own]], block, bits)
        wires[own] = (q, s)
        data[r][spans[own]] = dequantize_blocks(q, s, block)
    for step in range(w - 1):
        for r in range(w):
            recv_seg = (r - step) % w
            q, s = wires[recv_seg]
            data[r][spans[recv_seg]] = dequantize_blocks(q, s, block)
            bytes_moved += payload_bytes(q.size, bits) \
                + SCALE_BYTES * s.size
    return data, bytes_moved


def simulate_quant_ring(per_rank: Sequence[np.ndarray],
                        block: int = QUANT_BLOCK,
                        bits: int = 8
                        ) -> Tuple[List[np.ndarray], int]:
    """Run the quantized ring schedule on in-memory "ranks".

    ``per_rank``: one equal-shape array per rank. Returns ``(results,
    wire_bytes)`` where ``results[r]`` is rank r's reduced SUM (callers
    divide by world for a mean) and ``wire_bytes`` is the total bytes
    that would cross the wire. The arithmetic (op kind and order) is
    bit-identical to ``dpx_allreduce_q8`` (``dpx_allreduce_qn`` at
    ``bits=4``), so this doubles as the parity oracle for the native
    path — and all results are bit-identical across ranks by
    construction of the byte-forwarding all-gather leg. Composed from
    the two standalone leg simulations, exactly like the native op is
    (``dpx_allreduce_q8`` == reduce-scatter + all-gather)."""
    shape = per_rank[0].shape
    if len(per_rank) == 1:
        return [np.ascontiguousarray(per_rank[0], dtype=np.float32)
                .reshape(shape).copy()], 0
    data, rs_bytes = simulate_quant_reduce_scatter(per_rank, block, bits)
    data, ag_bytes = simulate_quant_allgather(data, block, bits)
    return [d.reshape(shape) for d in data], rs_bytes + ag_bytes


def simulate_hier_ring(per_rank: Sequence[np.ndarray],
                       local_world: int,
                       block: int = QUANT_BLOCK,
                       bits: int = 8
                       ) -> Tuple[List[np.ndarray], int]:
    """The two-level hierarchical ring, simulated — the executable spec
    of :class:`..comm.hier.HierRing`.

    Ranks are grouped into hosts of ``local_world`` consecutive ranks.
    Per host the FAST hop runs exact f32: the leader (first rank of the
    host) accumulates its members' buffers in local-rank order — the
    same op order as the native rooted ``dpx_reduce_f32`` hub, so the
    sim stays bit-identical to the real thing. The SLOW hop is the
    quantized ring (:func:`simulate_quant_ring`) over the per-host
    partial sums, one designated leader per host; the result broadcasts
    back exactly. Returns ``(results, slow_hop_bytes)``: results are
    bit-identical on EVERY rank (leader ring bit-identity + exact
    broadcast), and ``slow_hop_bytes`` counts only the inter-host
    (leader-ring) traffic — each gradient byte crosses the slow hop
    exactly once per leg, ``1/local_world`` of a flat all-ranks ring's
    slow-hop bytes."""
    w = len(per_rank)
    if local_world < 1 or w % local_world:
        raise ValueError(
            f"local_world {local_world} must divide world {w}")
    shape = per_rank[0].shape
    nh = w // local_world
    leaders = []
    for h in range(nh):
        acc = np.ascontiguousarray(per_rank[h * local_world],
                                   dtype=np.float32).ravel().copy()
        for lr in range(1, local_world):
            acc += np.ascontiguousarray(
                per_rank[h * local_world + lr],
                dtype=np.float32).ravel()
        leaders.append(acc)
    reduced, slow_bytes = simulate_quant_ring(leaders, block, bits)
    return ([reduced[r // local_world].reshape(shape).copy()
             for r in range(w)], slow_bytes)


# ---------------------------------------------------------------------------
# adaptive width selection (EQuARX-style dynamic block-wise width)
# ---------------------------------------------------------------------------

#: Per-block ``amax/rms`` above this marks the block q4-hostile: one
#: outlier would claim the whole nibble range and flush its block-mates
#: to zero. A Gaussian block of 1024 sits near sqrt(2*ln 1024) ~ 3.7.
DYNRANGE_THRESH = 6.0

#: Fraction of q4-hostile blocks above which the bucket stays on q8.
Q4_MAX_OUTLIER_FRAC = 0.05

#: Consecutive identical width verdicts required before the wire width
#: flips: keeps a borderline bucket from flapping 8<->4 every step.
WIDTH_HYSTERESIS = 2


def block_outlier_frac(x: np.ndarray, block: int = QUANT_BLOCK,
                       thresh: float = DYNRANGE_THRESH) -> float:
    """Fraction of (nonzero) blocks whose ``amax/rms`` exceeds
    ``thresh`` — the chooser's dynamic-range statistic, computed on a
    flat f32 bucket. All-zero blocks are neither counted nor hostile.
    The ragged tail block's rms divides by its REAL element count — the
    zero padding this function adds must not read as dynamic range."""
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    if x.size == 0:
        return 0.0
    nb = num_blocks(x.size, block)
    pad = nb * block - x.size
    v = (np.pad(x, (0, pad)) if pad else x).reshape(nb, block)
    amax = np.abs(v).max(axis=1)
    counts = np.full(nb, block, np.float64)
    counts[-1] = x.size - (nb - 1) * block
    rms = np.sqrt(np.square(v, dtype=np.float64).sum(axis=1) / counts)
    valid = rms > 0.0
    if not valid.any():
        return 0.0
    hostile = valid & (amax > thresh * rms)
    return float(hostile.sum()) / float(valid.sum())


class WidthChooser:
    """Deterministic per-bucket wire-width policy with hysteresis.

    Feed it the REDUCED bucket after each quantized collective
    (:meth:`observe`) — that bucket is bit-identical on every rank by
    the all-gather leg's byte-forwarding construction, so every rank's
    chooser walks the identical state machine and the next step's width
    agrees world-wide with zero extra communication (deciding from the
    per-rank raw gradient would diverge). The torch.distributed door
    feeds the statistic computed on the card instead
    (:meth:`observe_frac`, ``ops/quant.py`` ``block_outlier_frac``).

    Starts at q8 (safe); drops to q4 only after ``hysteresis``
    consecutive low-dynamic-range verdicts, and climbs back the same
    way. ``widths`` records the width used per observed step
    (:meth:`histogram`)."""

    def __init__(self, *, thresh: float = DYNRANGE_THRESH,
                 max_frac: float = Q4_MAX_OUTLIER_FRAC,
                 hysteresis: int = WIDTH_HYSTERESIS,
                 block: int = QUANT_BLOCK, initial: int = 8):
        quant_levels(initial)
        self.thresh = float(thresh)
        self.max_frac = float(max_frac)
        self.hysteresis = max(int(hysteresis), 1)
        self.block = block
        self._width = initial
        self._pending_width = initial
        self._pending_count = 0
        self.widths: List[int] = []

    @property
    def width(self) -> int:
        """The wire width to use for the NEXT quantized collective."""
        return self._width

    def observe_frac(self, frac: float) -> int:
        """Fold one bucket's outlier fraction into the state machine;
        returns the width for the next step."""
        self.widths.append(self._width)
        verdict = 4 if float(frac) <= self.max_frac else 8
        if verdict == self._width:
            self._pending_count = 0
            self._pending_width = self._width
        else:
            if verdict == self._pending_width:
                self._pending_count += 1
            else:
                self._pending_width = verdict
                self._pending_count = 1
            if self._pending_count >= self.hysteresis:
                self._width = verdict
                self._pending_count = 0
        return self._width

    def observe(self, reduced: np.ndarray) -> int:
        """Observe a reduced bucket (bit-identical across ranks) and
        return the width for the next step."""
        return self.observe_frac(
            block_outlier_frac(reduced, self.block, self.thresh))

    def histogram(self) -> dict:
        """{width: steps used} over every observed step."""
        out: dict = {}
        for b in self.widths:
            out[b] = out.get(b, 0) + 1
        return out
