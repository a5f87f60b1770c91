"""Runtime collective sanitizer: the port's copy of the JAX package's
``comm/sanitizer.py``.

Armed by ``DPX_COMM_SANITIZE=1``: before every host-group collective
runs its native payload, all ranks exchange a fixed-size fingerprint of
what they are ABOUT to issue and compare. A rank that diverged — took a
rank-dependent branch, swallowed an exception past a barrier, had a
fault injected — raises a typed, rank-attributed
:class:`CollectiveMismatch` within ONE fingerprint exchange, instead of
leaving its peers to hang for a full ``DPX_COMM_TIMEOUT_MS`` deadline
with no attribution. The flight recorder (obs/trace.py) dumps on the
way out, as on every other typed comm failure. (The JAX package also
dumps its rolling schedule digest, ``analysis/schedule.py``, which the
port does not have yet.)

Wire format (``_RECORD`` struct, little-endian, 88 bytes — fixed size
so MISMATCHED ranks still complete the exchange):

====== ===== =====================================================
offset bytes field
====== ===== =====================================================
0      2     magic ``0xD9F1``
2      1     version (1)
3      1     pad
4      8     seq — per-comm monotone exchange counter (u64)
12     8     payload nbytes (u64)
20     4     CRC32 of the full ``file:line`` call site (u32)
24     12    op name (NUL-padded ASCII)
36     8     dtype name (NUL-padded ASCII, may be empty)
44     44    call site tail, ``file.py:line`` (NUL-padded)
====== ===== =====================================================

The exchange itself is a rooted gather of the 88-byte record to rank 0
followed by a broadcast of the full ``world x 88`` matrix — raw
``dpx_gather``/``dpx_broadcast`` native calls that bypass
``HostComm._pre_op`` (no recursion).
Every rank then compares locally and raises its OWN attributed error,
so supervisors see the mismatch from both sides.

Divergence is keyed on (seq, op, dtype, nbytes); the call-site fields
ride along for attribution only (two ranks may legitimately reach the
same collective from different lines).

Unarmed (the default), the entire feature is one ``is None`` attribute
test per collective in ``HostComm._pre_op`` — no fingerprinting, no
extra traffic, no measurable overhead.
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import zlib

from ..runtime.native import CommError

_MAGIC = 0xD9F1
_VERSION = 1
_FMT = "<HBxQQI12s8s44s"
RECORD_SIZE = struct.calcsize(_FMT)   # 88

_PKG_SKIP_DIRS = tuple(
    os.sep + os.path.join("distributed_pytorch_tpu_torch", d) + os.sep
    for d in ("comm", "runtime"))


class CollectiveMismatch(CommError):
    """Two ranks issued DIFFERENT collectives at the same sequence
    point — the cross-rank divergence that would otherwise surface as
    an unattributed ``CommTimeout`` hang. Carries both sides: this
    rank's op/call site and the diverging peer's."""

    def __init__(self, msg: str, *, seq: int = -1, peer_op: str = "",
                 call_site: str = "", peer_call_site: str = "", **kw):
        super().__init__(msg, **kw)
        self.seq = seq
        self.peer_op = peer_op
        self.call_site = call_site
        self.peer_call_site = peer_call_site


def _call_site() -> str:
    """First stack frame OUTSIDE the comm/runtime plumbing — the line
    that asked for the collective (falls back to the innermost frame
    for bare-comm callers like the tests)."""
    frame = sys._getframe(1)
    best = frame
    while frame is not None:
        fname = frame.f_code.co_filename
        if not any(d in fname for d in _PKG_SKIP_DIRS):
            best = frame
            break
        best = frame
        frame = frame.f_back
    return f"{os.path.basename(best.f_code.co_filename)}:{best.f_lineno}"


class CollectiveSanitizer:
    """Per-:class:`HostComm` fingerprint exchanger (one per comm —
    hierarchical sub-groups arm their own against their own world)."""

    def __init__(self, comm):
        self._comm = comm
        self._seq = 0

    # -- wire --------------------------------------------------------------

    def _pack(self, op: str, dtype: str, size: int, site: str) -> bytes:
        return struct.pack(
            _FMT, _MAGIC, _VERSION, self._seq, int(size),
            zlib.crc32(site.encode()) & 0xFFFFFFFF,
            op.encode()[:12], dtype.encode()[:8],
            site.encode()[-44:])

    @staticmethod
    def _unpack(raw: bytes) -> dict:
        magic, ver, seq, nbytes, crc, op, dtype, site = struct.unpack(
            _FMT, raw)
        return {"magic": magic, "version": ver, "seq": seq,
                "nbytes": nbytes, "site_crc": crc,
                "op": op.rstrip(b"\0").decode(errors="replace"),
                "dtype": dtype.rstrip(b"\0").decode(errors="replace"),
                "site": site.rstrip(b"\0").decode(errors="replace")}

    # -- the exchange ------------------------------------------------------

    def check(self, op: str, dtype: str = "", size: int = 0) -> None:
        """Fingerprint-exchange-and-compare for the collective this comm
        is about to issue. Raises :class:`CollectiveMismatch` when any
        peer's fingerprint diverges; returns silently when all match."""
        comm = self._comm
        if comm.world <= 1:
            return
        self._seq += 1
        site = _call_site()
        rec = self._pack(op, dtype, size, site)
        lib, h, world = comm._lib, comm._h, comm.world
        matrix = ctypes.create_string_buffer(RECORD_SIZE * world)
        if comm.rank == 0:
            rc = lib.dpx_gather(h, rec, RECORD_SIZE, matrix)
        else:
            rc = lib.dpx_gather(h, rec, RECORD_SIZE, None)
        if rc == 0:
            rc = lib.dpx_broadcast(h, matrix, RECORD_SIZE * world, 0)
        if rc != 0:
            # transport-level failure of the exchange itself: the
            # ordinary typed path
            comm._check(rc, f"sanitize:{op}")
        mine = self._unpack(rec)
        for peer in range(world):
            if peer == comm.rank:
                continue
            raw = matrix.raw[peer * RECORD_SIZE:(peer + 1) * RECORD_SIZE]
            theirs = self._unpack(raw)
            if theirs["magic"] != _MAGIC:
                self._raise(op, mine, peer, None, site)
            if (theirs["seq"] != mine["seq"]
                    or theirs["op"] != mine["op"]
                    or theirs["dtype"] != mine["dtype"]
                    or theirs["nbytes"] != mine["nbytes"]):
                self._raise(op, mine, peer, theirs, site)

    def _raise(self, op: str, mine: dict, peer: int,
               theirs: "dict | None", site: str) -> None:
        comm = self._comm
        if theirs is None:
            msg = (f"collective sanitizer: rank {peer} sent a garbled "
                   f"fingerprint while rank {comm.rank} issued "
                   f"{op!r} seq {mine['seq']} at {site}")
            exc = CollectiveMismatch(msg, op=op, rank=comm.rank,
                                     peer=peer, seq=mine["seq"],
                                     call_site=site)
        else:
            msg = (f"collective divergence at seq {mine['seq']}: "
                   f"rank {comm.rank} issued {mine['op']!r} "
                   f"(dtype={mine['dtype'] or '-'}, "
                   f"nbytes={mine['nbytes']}) at {site} "
                   f"but rank {peer} issued {theirs['op']!r} "
                   f"(dtype={theirs['dtype'] or '-'}, "
                   f"nbytes={theirs['nbytes']}, seq {theirs['seq']}) "
                   f"at {theirs['site']} — every rank must issue the "
                   "same collective sequence")
            exc = CollectiveMismatch(
                msg, op=op, rank=comm.rank, peer=peer, seq=mine["seq"],
                peer_op=theirs["op"], call_site=site,
                peer_call_site=theirs["site"])
        # the flight recorder rides out with the typed error, as on every
        # native failure path (HostComm._check)
        comm._dpxtrace.on_typed_failure(exc)
        raise exc
