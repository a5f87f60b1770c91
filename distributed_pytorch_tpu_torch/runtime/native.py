"""The port's ctypes layer over the repo's host library
(``native/dpxhost.cpp``).

The JAX package binds the same source through its own loader, which the
port cannot import. Here ``g++`` compiles ``native/dpxhost.cpp`` with the
flags of ``native/Makefile`` into ``build/torch_native/`` at the repo
root, keyed by a hash of the source and the flags, and ``ctypes`` loads
it; nothing is built at import, the first call builds. A build failure
raises: there is no silent fallback to a slower path.

Bound: ``dpx_crc32c``, the CRC32C (Castagnoli) of the handoff frames
(hardware sse4.2 where the CPU has it, a bit-identical table otherwise),
and every entry of the native host process group, which
:class:`HostComm` wraps (counterpart of the JAX package's
``runtime/native.py:229-594``): a ring all-reduce at f32/f64 (sum, max,
min), the quantized ring at 8 or 4 bits and its two legs, a rooted
reduce, gather and broadcast through rank 0's hub, and a barrier, over
localhost TCP. Every op observes a per-op deadline
(``DPX_COMM_TIMEOUT_MS``) and a failure raises the typed
:class:`CommError` family, naming the op, this rank and, when the
transport can tell, the peer to blame.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import socket
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import chaos, faults
from . import env as _env

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dpxhost.cpp"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fno-math-errno", "-fPIC", "-std=c++17", "-shared")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: Native error codes (``native/dpxhost.cpp``'s constants).
_RC_PEER_CLOSED = -2
_RC_TIMEOUT = -3
_RC_CORRUPT = -4


class CommError(RuntimeError):
    """A native host collective failed: which rank raised, in which op,
    and (when the transport could tell) which peer is to blame."""

    def __init__(self, msg: str, *, op: str = "", rank: int = -1,
                 peer: int = -1):
        super().__init__(msg)
        self.op = op
        self.rank = rank
        self.peer = peer


class CommPeerDied(CommError):
    """A peer closed its end mid-collective (an orderly close, a reset,
    or the abort of a failed rank)."""


class CommTimeout(CommError):
    """The per-op deadline (``DPX_COMM_TIMEOUT_MS``) elapsed: the peer is
    wedged or the link stalled, but nothing closed."""

    def __init__(self, msg: str, *, deadline_ms: int = 0, **kw):
        super().__init__(msg, **kw)
        self.deadline_ms = deadline_ms


class CommCorrupt(CommError):
    """A framed quantized payload failed its CRC32C check."""


class CommRetryExhausted(CommError):
    """The rendezvous kept failing through the retry budget
    (``DPX_RETRY_MAX`` retries, ``DPX_RETRY_BACKOFF_MS`` doubling
    backoff); the last failure is chained as ``__cause__``."""

    def __init__(self, msg: str, *, attempts: int = 0, **kw):
        super().__init__(msg, **kw)
        self.attempts = attempts


_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64, _INT, _VOIDP = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
# name -> (argtypes, restype) of every entry of dpxhost.cpp:486-1290
_SIGNATURES = {
    "dpx_crc32c": ([_VOIDP, _I64], ctypes.c_uint32),
    "dpx_comm_init": ([ctypes.c_char_p, _INT, _INT, _INT, _INT], _VOIDP),
    "dpx_comm_destroy": ([_VOIDP], None),
    "dpx_comm_abort": ([_VOIDP], None),
    "dpx_rank": ([_VOIDP], _INT),
    "dpx_world": ([_VOIDP], _INT),
    "dpx_set_timeout_ms": ([_VOIDP, _INT], None),
    "dpx_get_timeout_ms": ([_VOIDP], _INT),
    "dpx_last_error_peer": ([_VOIDP], _INT),
    "dpx_allreduce_f32_op": ([_VOIDP, _F32P, _I64, _INT], _INT),
    "dpx_allreduce_f64_op": ([_VOIDP, _F64P, _I64, _INT], _INT),
    # the quantized family: (data, n, block, chunk_blocks, bits)
    "dpx_allreduce_qn": ([_VOIDP, _F32P, _I64, _INT, _INT, _INT], _INT),
    "dpx_reduce_scatter_qn": ([_VOIDP, _F32P, _I64, _INT, _INT, _INT],
                              _INT),
    "dpx_allgather_qn": ([_VOIDP, _F32P, _I64, _INT, _INT, _INT], _INT),
    "dpx_reduce_f32": ([_VOIDP, _F32P, _I64], _INT),
    "dpx_gather": ([_VOIDP, ctypes.c_char_p, _I64, ctypes.c_char_p], _INT),
    "dpx_broadcast": ([_VOIDP, ctypes.c_char_p, _I64, _INT], _INT),
    "dpx_barrier": ([_VOIDP], _INT),
}


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"dpxhost-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/dpxhost.cpp`` unless the hashed library exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the port's host "
                           "library is built from native/dpxhost.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded host library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def crc32c(buf) -> int:
    """CRC32C of a bytes-like buffer or a numpy array (its C-order
    bytes)."""
    lib = load_library()
    if not isinstance(buf, np.ndarray):
        buf = np.frombuffer(memoryview(buf), dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    if buf.nbytes == 0:
        return int(lib.dpx_crc32c(None, 0))
    return int(lib.dpx_crc32c(buf.ctypes.data_as(ctypes.c_void_p),
                              buf.nbytes))


def _rendezvous(lib, addr: str, base_port: int, rank: int, world: int,
                timeout_ms: int):
    """``dpx_comm_init`` inside ``chaos.call_with_retry``: nothing is
    established yet when a connect fails, so a retry is safe. The
    ``init`` fault hook fires before each attempt
    (``flaky@op=init,rank=1,count=2`` refuses rank 1's connect twice).
    Up to ``DPX_RETRY_MAX`` retries, the k-th after
    ``DPX_RETRY_BACKOFF_MS * 2^(k-1)`` ms, each a ``comm_retry`` event;
    then :class:`CommRetryExhausted`."""
    def attempt():
        faults.on_comm_op("init", rank=rank)
        handle = lib.dpx_comm_init(addr.encode(), base_port, rank, world,
                                   timeout_ms)
        if not handle:
            raise CommError(f"native rendezvous failed (rank {rank}/{world} "
                            f"on {addr}:{base_port})", op="init", rank=rank)
        return handle

    return chaos.call_with_retry(attempt, op="init", rank=rank,
                                 transient=(faults.FlakyFault, CommError))


class HostComm:
    """The native process group of one rank process: a ring all-reduce
    and rooted ops through rank 0's hub, over localhost TCP, rendezvoused
    on ``base_port`` (rank r listens on ``base_port + r``). Every op works
    in place on a contiguous numpy buffer and is booked in :attr:`stats`
    (a ``utils.profiler.CommStats``) under its op name, with the wire
    bytes this rank sends (``comm/wire.py``'s formulas over the world).
    ``hidden=True`` books an op's time as overlapped with device work.

    Every op is a ``comm:<op>`` dpxtrace span (through
    ``CommStats.timed``), the comm stamps its rank on the spans and
    metrics snapshots of its process, and its ``stats`` are the dpxmon
    ``comm`` provider. Every op fires ``faults.on_comm_op`` under its
    op name first, and the comm is registered for ``drop_conn`` /
    ``diverge`` (``runtime/faults.py``). The JAX package's
    collective-schedule recorder (``analysis/schedule.py``) comes with
    the analysis tools."""

    #: allreduce op codes (``dpxhost.cpp``'s enum)
    _OPS = {"sum": 0, "max": 1, "min": 2}

    def __init__(self, master_addr: str, base_port: int, rank: int,
                 world: int, timeout_ms: int = 30000,
                 op_timeout_ms: Optional[int] = None):
        from ..comm import wire as _wire
        from ..obs import metrics as _dpxmon
        from ..obs import trace as _dpxtrace
        from ..utils.profiler import CommStats
        self._wire = _wire
        self._dpxtrace = _dpxtrace
        # every span and snapshot this process records from here on is
        # rank-attributed; the per-op accounting is the pull-model `comm`
        # provider (polled once per snapshot; a newer comm replaces it)
        _dpxtrace.set_rank(rank)
        self.stats = CommStats()
        _dpxmon.set_rank(rank)
        _dpxmon.register_provider("comm", self.stats.monitor_metrics)
        self._lib = load_library()
        self._h = None
        # the native layer takes a dotted quad only
        addr = socket.gethostbyname(master_addr)
        self._h = _rendezvous(self._lib, addr, base_port, rank, world,
                              timeout_ms)
        if op_timeout_ms is None:
            op_timeout_ms = _env.get("DPX_COMM_TIMEOUT_MS")
        self._lib.dpx_set_timeout_ms(self._h, op_timeout_ms)
        self.op_timeout_ms = op_timeout_ms
        self.rank = rank
        self.world = world
        # kept so derived sub-groups (comm/hier.py) rendezvous on ports
        # relative to this group's
        self.master_addr = master_addr
        self.base_port = base_port
        self._hier_ring = None
        self._sanitizer = None
        if _env.get("DPX_COMM_SANITIZE"):
            from ..comm.sanitizer import CollectiveSanitizer
            self._sanitizer = CollectiveSanitizer(self)
        faults.register_comm(self)

    def close(self) -> None:
        ring, self._hier_ring = self._hier_ring, None
        if ring is not None:
            ring.close()
        if self._h:
            self._lib.dpx_comm_destroy(self._h)
            self._h = None

    def abort(self) -> None:
        """Tear every link of this comm down now, without freeing the
        handle: blocked peers see the close within one deadline tick, and
        every later op here raises :class:`CommError`."""
        if self._h:
            self._lib.dpx_comm_abort(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _pre_op(self, op: str, *, dtype: str = "", size: int = 0) -> None:
        # fault injection first: an injected extra barrier lands
        # where the schedule diverges
        faults.on_comm_op(op, rank=self.rank, comm=self)
        if self._h is None:
            raise CommError(f"{op} on a closed comm (rank {self.rank})",
                            op=op, rank=self.rank)
        if self._sanitizer is not None:
            self._sanitizer.check(op, dtype=dtype, size=size)

    def _check(self, rc: int, what: str) -> None:
        """Map a native return code onto the typed errors."""
        if rc == 0:
            return
        peer = self._lib.dpx_last_error_peer(self._h) if self._h else -1
        where = f"(rank {self.rank}, op {what}"
        where += f", peer {peer})" if peer >= 0 else ")"
        if rc == _RC_PEER_CLOSED:
            exc = CommPeerDied(f"peer closed connection mid-collective "
                               f"{where}", op=what, rank=self.rank,
                               peer=peer)
        elif rc == _RC_TIMEOUT:
            exc = CommTimeout(f"deadline {self.op_timeout_ms}ms exceeded "
                              f"{where}", deadline_ms=self.op_timeout_ms,
                              op=what, rank=self.rank, peer=peer)
        elif rc == _RC_CORRUPT:
            exc = CommCorrupt(f"framed quant payload failed CRC32 {where}",
                              op=what, rank=self.rank, peer=peer)
        else:
            exc = CommError(f"native {what} failed {where} rc={rc}",
                            op=what, rank=self.rank, peer=peer)
        # flight recorder: the last spans of this rank's timeline ride
        # out beside the typed error (obs/trace.py); best effort, it
        # never masks `exc`
        self._dpxtrace.on_typed_failure(exc)
        raise exc

    def _per_rank(self, total: int) -> int:
        return total // max(self.world, 1)

    @staticmethod
    def _f32(arr: np.ndarray):
        return arr.ctypes.data_as(_F32P)

    def allreduce(self, arr: np.ndarray, op: str = "sum",
                  hidden: bool = False) -> np.ndarray:
        """Ring all-reduce of a float32 or float64 array, in place when it
        is C-contiguous (else on a contiguous copy, returned): ``sum`` or
        elementwise ``max`` / ``min`` (the same ring and bytes). The
        quantized ops and ``broadcast`` take their input alike."""
        if op not in self._OPS:
            raise ValueError(f"allreduce op must be sum|max|min, got {op!r}")
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in (np.float32, np.float64):
            raise TypeError(f"allreduce supports f32/f64, got {arr.dtype}")
        self._pre_op("allreduce", dtype=str(arr.dtype), size=int(arr.size))
        nbytes = self._per_rank(self._wire.ring_allreduce_wire_bytes(
            arr.size, self.world, arr.dtype.itemsize))
        with self.stats.timed(f"allreduce_{op}", nbytes, hidden=hidden):
            if arr.dtype == np.float32:
                rc = self._lib.dpx_allreduce_f32_op(
                    self._h, self._f32(arr), arr.size, self._OPS[op])
            else:
                rc = self._lib.dpx_allreduce_f64_op(
                    self._h, arr.ctypes.data_as(_F64P), arr.size,
                    self._OPS[op])
        self._check(rc, "allreduce")
        return arr

    def _quant(self, fn, op: str, stat_op: str, arr: np.ndarray, bits: int,
               block: Optional[int], chunk_blocks: Optional[int],
               nbytes_total, hidden: bool) -> np.ndarray:
        block = block or self._wire.QUANT_BLOCK
        chunk_blocks = chunk_blocks or self._wire.QUANT_CHUNK_BLOCKS
        self._wire.quant_levels(bits)
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        self._pre_op(op, dtype="float32", size=int(arr.size))
        nbytes = self._per_rank(nbytes_total(arr.size, self.world, block,
                                             bits))
        with self.stats.timed(stat_op, nbytes, hidden=hidden):
            rc = fn(self._h, self._f32(arr), arr.size, block, chunk_blocks,
                    bits)
        self._check(rc, stat_op)
        return arr

    def allreduce_quant(self, arr: np.ndarray, bits: int = 8,
                        block: Optional[int] = None,
                        chunk_blocks: Optional[int] = None,
                        hidden: bool = False) -> np.ndarray:
        """In-place quantized ring all-reduce (sum) of a float32 array at
        8 or 4 bits: lossy, one quantization step per hop, and the result
        bit-identical on every rank (``comm/wire.py``'s
        ``simulate_quant_ring`` byte for byte). Booked as
        ``allreduce_q8`` / ``allreduce_q4``."""
        op = f"allreduce_q{bits}"
        return self._quant(self._lib.dpx_allreduce_qn, op, op, arr, bits,
                           block, chunk_blocks,
                           self._wire.quant_ring_allreduce_wire_bytes,
                           hidden)

    def allreduce_q8(self, arr, block=None, chunk_blocks=None,
                     hidden: bool = False) -> np.ndarray:
        return self.allreduce_quant(arr, 8, block, chunk_blocks, hidden)

    def allreduce_q4(self, arr, block=None, chunk_blocks=None,
                     hidden: bool = False) -> np.ndarray:
        return self.allreduce_quant(arr, 4, block, chunk_blocks, hidden)

    def reduce_scatter_quant(self, arr: np.ndarray, bits: int = 8,
                             block: Optional[int] = None,
                             chunk_blocks: Optional[int] = None,
                             hidden: bool = False) -> np.ndarray:
        """The reduce-scatter leg of :meth:`allreduce_quant` alone, in
        place: this rank's ``ring_owned_span`` holds the reduced sum,
        every other span a partial one. Half the all-reduce's bytes."""
        return self._quant(self._lib.dpx_reduce_scatter_qn,
                           "reduce_scatter", "reduce_scatter", arr, bits,
                           block, chunk_blocks,
                           self._wire.quant_leg_wire_bytes, hidden)

    def reduce_scatter_q8(self, arr, block=None,
                          chunk_blocks=None) -> np.ndarray:
        return self.reduce_scatter_quant(arr, 8, block, chunk_blocks)

    def allgather_quant(self, arr: np.ndarray, bits: int = 8,
                        block: Optional[int] = None,
                        chunk_blocks: Optional[int] = None,
                        hidden: bool = False) -> np.ndarray:
        """The byte-forwarding all-gather leg alone, in place: this rank
        contributes its ``ring_owned_span``, and afterwards the buffer is
        bit-identical on every rank (each span decodes its owner's
        bytes, the owner's own span included)."""
        return self._quant(self._lib.dpx_allgather_qn, "allgather",
                           "allgather", arr, bits, block, chunk_blocks,
                           self._wire.quant_leg_wire_bytes, hidden)

    def allgather_q8(self, arr, block=None, chunk_blocks=None) -> np.ndarray:
        return self.allgather_quant(arr, 8, block, chunk_blocks)

    def owned_span(self, n: int, block: Optional[int] = None):
        """(offset, count) of the span this rank owns after a quantized
        reduce-scatter of ``n`` elements."""
        return self._wire.ring_owned_span(
            n, self.world, self.rank, block or self._wire.QUANT_BLOCK)

    def reduce(self, arr: np.ndarray) -> np.ndarray:
        """Rooted sum of a float32 array into rank 0's, in place; other
        ranks' buffers are left as they were."""
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        self._pre_op("reduce", dtype="float32", size=int(arr.size))
        with self.stats.timed("reduce", arr.nbytes):
            rc = self._lib.dpx_reduce_f32(self._h, self._f32(arr), arr.size)
        self._check(rc, "reduce")
        return arr

    def gather(self, arr: np.ndarray) -> Optional[list]:
        """Rooted gather: every rank's array in rank order on rank 0,
        ``None`` elsewhere."""
        arr = np.ascontiguousarray(arr)
        self._pre_op("gather", dtype=str(arr.dtype), size=int(arr.size))
        recv = (np.zeros((self.world,) + arr.shape, dtype=arr.dtype)
                if self.rank == 0 else None)
        with self.stats.timed("gather", arr.nbytes):
            rc = self._lib.dpx_gather(
                self._h, arr.tobytes(), arr.nbytes,
                None if recv is None else recv.ctypes.data_as(
                    ctypes.c_char_p))
        self._check(rc, "gather")
        return None if recv is None else [recv[r] for r in range(self.world)]

    def all_gather(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's array stacked ``(world, *shape)`` on every rank
        (a gather to the hub, then a broadcast)."""
        arr = np.ascontiguousarray(arr)
        got = self.gather(arr)
        stacked = (np.stack(got) if got is not None else
                   np.zeros((self.world,) + arr.shape, dtype=arr.dtype))
        return self.broadcast(stacked, src=0)

    def broadcast(self, arr: np.ndarray, src: int = 0) -> np.ndarray:
        """Rank ``src``'s bytes into every rank's ``arr``, in place."""
        arr = np.ascontiguousarray(arr)
        self._pre_op("broadcast", dtype=str(arr.dtype), size=int(arr.size))
        with self.stats.timed("broadcast", arr.nbytes):
            rc = self._lib.dpx_broadcast(
                self._h, arr.ctypes.data_as(ctypes.c_char_p), arr.nbytes,
                src)
        self._check(rc, "broadcast")
        return arr

    def barrier(self) -> None:
        self._pre_op("barrier")
        with self.stats.timed("barrier", 4):
            rc = self._lib.dpx_barrier(self._h)
        self._check(rc, "barrier")
