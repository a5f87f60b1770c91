"""dpxtrace: the span-tracing spine shared by train, comm, checkpoint
and serve.

Counterpart of ``distributed_pytorch_tpu/obs/trace.py``, the same
records under the same names, so ``tools/dpxtrace.py`` and
``tools/dpxmon.py`` read a port log unchanged:

* **Spans**: ``with span("comm:allreduce", bytes=n):`` records one timed
  region with ``trace_id`` / ``span_id`` / ``parent_id`` lineage. Timing
  is ``perf_counter_ns`` on the host; every span also carries a wall
  stamp from ONE ``time.time()`` / ``perf_counter_ns()`` pair taken per
  process at import, so the logs of many ranks merge on a common base.
  Nesting is per thread: the serve engine thread's spans parent under
  its own stack, never the submitter's.
* **Host time, not device time**: under CUDA's asynchronous launch a
  span around kernel launches measures the launches, as the JAX
  package's spans measure dispatch. Nothing here synchronizes the card.
* **Flight recorder**: every finished span also lands in a bounded
  per-process ring (``DPX_TRACE_RING`` spans, drop-counted). Typed
  failure paths call :func:`on_typed_failure`, which dumps the ring as
  ONE ``flight_recorder`` line-JSON event.
* **Sink**: spans append to ``DPX_TRACE_LOG`` (default
  ``DPX_METRICS_LOG``) as ``trace_span`` events, one ``O_APPEND`` write
  per line, so the ranks sharing one file keep their lines whole.

* **Profiler bridge**: whenever a ``torch.profiler`` is recording, every
  :func:`span` also opens a ``record_function`` range named
  ``dpx.<span name>``, ``DPX_TRACE`` on or off, so the spans sit on the
  device trace's clock beside the kernels they launched. Records are
  still written only under ``DPX_TRACE``; :func:`emit_span`, timed after
  the fact, opens no range.

With ``DPX_TRACE`` off and no profiler recording, :func:`span` is one
module-global read, one read of torch's profiler flag and two tests
returning a shared no-op context manager.

:func:`wall_now` is the one wall stamp of the port's loggers
(``utils/logging.py``): anchor wall time plus elapsed
``perf_counter_ns``, monotone within a process even when the system
clock steps. Stdlib only; the env registry is imported lazily.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TRACE_ENV", "RING_ENV", "LOG_ENV",
    "span", "event", "emit_span", "new_trace_id", "enabled", "refresh",
    "configure", "set_rank", "wall_now", "wall_from_ns", "wall_from_mono",
    "flight_snapshot", "flight_dump", "on_typed_failure", "reset",
]

#: Env var: master switch for span recording (off = near-zero overhead).
TRACE_ENV = "DPX_TRACE"
#: Env var: flight-recorder ring capacity in spans (0 disables the ring).
RING_ENV = "DPX_TRACE_RING"
#: Env var: span sink path (default: the DPX_METRICS_LOG stream).
LOG_ENV = "DPX_TRACE_LOG"
#: Prefix of the ``torch.profiler`` range each span opens while a
#: profiler records.
RANGE_PREFIX = "dpx."

# ---------------------------------------------------------------------------
# wall anchor: ONE (wall, perf_counter_ns, monotonic) triple per process.
# Every duration is perf_counter_ns math; every wall stamp is anchor +
# elapsed — so stamps are monotone and cross-clock conversions exact.
# ---------------------------------------------------------------------------

_ANCHOR_WALL = time.time()
_ANCHOR_NS = time.perf_counter_ns()
_ANCHOR_MONO = time.monotonic()


def wall_now() -> float:
    """Monotone wall-clock stamp: anchor + elapsed ``perf_counter_ns``.
    The framework's loggers use this instead of ``time.time()`` so a
    stepping system clock can never make event timestamps go backwards
    within a process."""
    return _ANCHOR_WALL + (time.perf_counter_ns() - _ANCHOR_NS) / 1e9


def wall_from_ns(ns: int) -> float:
    """Wall seconds of a ``perf_counter_ns`` stamp from THIS process."""
    return _ANCHOR_WALL + (ns - _ANCHOR_NS) / 1e9


def wall_from_mono(t: float) -> float:
    """Wall seconds of a ``time.monotonic()`` stamp from THIS process
    (the serve request lifecycle records monotonic timestamps)."""
    return _ANCHOR_WALL + (t - _ANCHOR_MONO)


# ---------------------------------------------------------------------------
# process-local state
# ---------------------------------------------------------------------------


class _State:
    __slots__ = ("enabled", "ring", "ring_cap", "dropped", "recorded",
                 "rank", "log_path", "log_fd", "lock", "last_dump_n")

    def __init__(self, enabled: bool, ring_cap: int,
                 log_path: Optional[str], rank: Optional[int]):
        self.enabled = enabled
        self.ring_cap = max(int(ring_cap), 0)
        self.ring: collections.deque = collections.deque(
            maxlen=self.ring_cap or 1)
        self.dropped = 0
        self.recorded = 0
        self.rank = rank
        self.log_path = log_path
        self.log_fd: Optional[int] = None   # cached O_APPEND sink fd
        self.lock = threading.Lock()
        self.last_dump_n = -1

    def close_fd(self) -> None:
        fd, self.log_fd = self.log_fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass


_state: Optional[_State] = None
_state_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()


def _envreg():
    # lazy: this module must import with NOTHING but stdlib available
    # (the dpxtrace CLI loads it in a bare venv)
    from ..runtime import env
    return env


def _init() -> _State:
    global _state
    with _state_lock:
        if _state is None:
            env = _envreg()
            _state = _State(
                enabled=bool(env.get(TRACE_ENV)),
                ring_cap=int(env.get(RING_ENV)),
                log_path=env.get(LOG_ENV) or env.get("DPX_METRICS_LOG"),
                rank=None)
        return _state


def refresh() -> None:
    """Re-read the ``DPX_TRACE*`` knobs (tests and long-lived programs
    that flip the env mid-process; child processes re-read at import).
    Keeps the rank but drops the ring."""
    global _state
    rank = None
    with _state_lock:
        if _state is not None:
            rank = _state.rank
            _state.close_fd()
        _state = None
    st = _init()
    st.rank = rank


def configure(enabled: Optional[bool] = None,
              ring: Optional[int] = None,
              log_path: Optional[str] = "__unset__",
              rank: Optional[int] = None) -> None:
    """Programmatic override of the env-derived config (benchmark arms,
    tests). Only the named fields change."""
    st = _init()
    if enabled is not None:
        st.enabled = bool(enabled)
    if ring is not None:
        st.ring_cap = max(int(ring), 0)
        st.ring = collections.deque(maxlen=st.ring_cap or 1)
        st.dropped = 0
    if log_path != "__unset__":
        with st.lock:
            st.close_fd()
            st.log_path = log_path
    if rank is not None:
        st.rank = int(rank)


def reset() -> None:
    """Drop all state (test isolation); next use re-reads the env."""
    global _state
    with _state_lock:
        if _state is not None:
            _state.close_fd()
        _state = None
    _tls.__dict__.pop("stack", None)


def enabled() -> bool:
    st = _state if _state is not None else _init()
    return st.enabled


def set_rank(rank: int) -> None:
    """Stamp this process's rank onto every subsequent span (called by
    ``HostComm.__init__`` / the process-group front door)."""
    _init().rank = int(rank)


def new_trace_id() -> str:
    """A process-unique trace id (pid-scoped counter — deterministic,
    collision-free across the ranks of one host-group launch)."""
    return f"{os.getpid():x}-{next(_ids):x}"


def _new_span_id() -> str:
    return f"{os.getpid():x}.{next(_ids):x}"


def _stack() -> List["_Span"]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


_PROFILER = "torch.autograd.profiler"


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is recording: the module flag its
    ``profile`` sets, read only when torch is already loaded (this
    module imports with the stdlib alone)."""
    mod = sys.modules.get(_PROFILER)
    return mod is not None and mod._is_profiler_enabled


def _open_range(name: str):
    """An entered ``record_function`` range ``dpx.<name>``."""
    rf = sys.modules[_PROFILER].record_function(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _record(st: _State, rec: Dict[str, Any]) -> None:
    """Ring append (drop-counted) + line-JSON sink. Never raises: a
    tracing failure must not take down the traced op.

    The sink is a CACHED ``O_APPEND`` fd with one ``os.write`` per span
    under the state lock — the same single-write-per-line multi-writer
    contract as ``utils.logging.append_event`` (which opens per event;
    spans are ~100x more frequent than failure events, so the sink
    amortizes the open). The record shape matches ``append_event``'s
    (``event``/``time`` first), so the merged stream stays uniform."""
    line = None
    try:
        with st.lock:
            if st.ring_cap and len(st.ring) == st.ring_cap:
                st.dropped += 1
            if st.ring_cap:
                st.ring.append(rec)
            st.recorded += 1
        if st.log_path:
            out = {"event": "trace_span", "time": rec.get("t0_wall"),
                   **rec}
            try:
                # compact, no default hook: span records are built from
                # JSON-native values; the fallback keeps odd attrs safe
                text = json.dumps(out, separators=(",", ":"))
            except (TypeError, ValueError):
                text = json.dumps(out, default=str)
            line = (text + "\n").encode()
            with st.lock:
                if st.log_fd is None:
                    st.log_fd = os.open(
                        st.log_path,
                        os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                os.write(st.log_fd, line)
    except Exception:
        pass


class _NullSpan:
    """The disabled path: a shared, reusable no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name: str, **attrs) -> None:
        pass

    @property
    def span_id(self) -> None:
        return None

    trace_id = None


_NULL = _NullSpan()


class _RangeSpan(_NullSpan):
    """``DPX_TRACE`` off while a profiler records: the ``dpx.`` range
    alone, no record."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        self._rf = _open_range(self.name)
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


class _Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "tid",
                 "attrs", "events", "t0_ns", "t1_ns", "_st", "_ambient",
                 "_rf")

    def __init__(self, st: _State, name: str, trace_id: Optional[str],
                 parent_id: Optional[str], tid: Optional[str],
                 attrs: Dict[str, Any]):
        self._st = st
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.tid = tid
        self.attrs = attrs
        self.events: List[Tuple[str, int, Dict[str, Any]]] = []
        self.t0_ns = 0
        self.t1_ns = 0
        self._ambient = False
        self._rf = None

    def __enter__(self) -> "_Span":
        if _profiling():
            self._rf = _open_range(self.name)
        stack = _stack()
        if self.parent_id is None and stack:
            top = stack[-1]
            self.parent_id = top.span_id
            if self.trace_id is None:
                self.trace_id = top.trace_id
        stack.append(self)
        self._ambient = True
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        if self._ambient:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:           # unbalanced exit: repair
                stack.remove(self)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._finish()
        return False

    def event(self, name: str, **attrs) -> None:
        """Instant event attached to this span's timeline."""
        self.events.append((name, time.perf_counter_ns(), attrs))

    def _finish(self) -> None:
        st = self._st
        rec: Dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t0_wall": wall_from_ns(self.t0_ns),
            "dur_ns": self.t1_ns - self.t0_ns,
            "rank": st.rank,
            "pid": os.getpid(),
            "tid": self.tid or threading.current_thread().name,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.events:
            rec["events"] = [
                {"name": n, "t_wall": wall_from_ns(ns), **a}
                for n, ns, a in self.events]
        _record(st, rec)


def span(name: str, *, trace_id: Optional[str] = None,
         parent_id: Optional[str] = None, tid: Optional[str] = None,
         **attrs):
    """Open a timed span as a context manager.

    Disabled tracing returns a shared no-op while no profiler records
    (a global read and a flag read: the near-zero-overhead contract),
    else the span's ``dpx.<name>`` profiler range alone.
    ``trace_id``/``parent_id`` default to the ambient per-thread span
    stack; pass them explicitly to stitch lineage across threads (the
    serve request lifecycle does)."""
    st = _state if _state is not None else _init()
    if not st.enabled:
        return _RangeSpan(name) if _profiling() else _NULL
    return _Span(st, name, trace_id, parent_id, tid, attrs)


def event(name: str, **attrs) -> None:
    """Record one instant event: attached to the ambient span when one
    is open (fault injections inside a collective), standalone
    otherwise. No-op when tracing is off."""
    st = _state if _state is not None else _init()
    if not st.enabled:
        return
    stack = _stack()
    if stack:
        stack[-1].event(name, **attrs)
        return
    now = time.perf_counter_ns()
    rec = {"name": name, "ph": "i",
           "trace_id": attrs.pop("trace_id", None),
           "span_id": _new_span_id(), "parent_id": None,
           "t0_wall": wall_from_ns(now), "dur_ns": 0,
           "rank": st.rank, "pid": os.getpid(),
           "tid": threading.current_thread().name}
    if attrs:
        rec["attrs"] = attrs
    _record(st, rec)


def emit_span(name: str, t0_wall: float, t1_wall: float, *,
              trace_id: Optional[str] = None,
              parent_id: Optional[str] = None,
              span_id: Optional[str] = None,
              tid: Optional[str] = None, **attrs) -> Optional[str]:
    """Record an ALREADY-TIMED span from explicit wall stamps (the serve
    lifecycle synthesizes its span tree at retirement from the request's
    recorded timestamps — :func:`wall_from_mono` converts them).
    Returns the span id (for parenting children), or None when tracing
    is off."""
    st = _state if _state is not None else _init()
    if not st.enabled:
        return None
    sid = span_id or _new_span_id()
    rec: Dict[str, Any] = {
        "name": name, "trace_id": trace_id, "span_id": sid,
        "parent_id": parent_id, "t0_wall": t0_wall,
        "dur_ns": max(int(round((t1_wall - t0_wall) * 1e9)), 0),
        "rank": st.rank, "pid": os.getpid(),
        "tid": tid or threading.current_thread().name,
    }
    if attrs:
        rec["attrs"] = attrs
    _record(st, rec)
    return sid


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def flight_snapshot() -> Tuple[List[Dict[str, Any]], int]:
    """(last-N span records, dropped count) of this process's ring."""
    st = _state if _state is not None else _init()
    with st.lock:
        return list(st.ring), st.dropped


def flight_dump(reason: str, rank: Optional[int] = None,
                **fields) -> bool:
    """Dump the flight recorder's last-N spans as ONE ``flight_recorder``
    line-JSON event (the postmortem timeline a failed rank ships).

    Idempotent per recording point — a teardown cascade that fails
    several ops in a row dumps once, like the schedule recorder's flush
    — and silent when the ring is empty (a supervisor that never traced
    a span has no timeline to ship). ``rank`` is a fallback attribution
    when this process never learned its own; with neither, ``-1``
    ("this process is not a rank": a single-process serve engine, a
    campaign runner) — the dump must stay rank-attributed either way,
    that is the ``dpxtrace check`` contract. Never raises; returns
    whether a line was written."""
    st = _state if _state is not None else _init()
    if not st.enabled or not st.log_path:
        return False
    try:
        with st.lock:
            if st.recorded == st.last_dump_n or not st.ring:
                return False
            st.last_dump_n = st.recorded
            spans = list(st.ring)
            dropped = st.dropped
        from ..utils.logging import append_event
        return append_event(
            "flight_recorder", path=st.log_path, reason=reason,
            rank=st.rank if st.rank is not None
            else (rank if rank is not None else -1),
            pid=os.getpid(), n_spans=len(spans),
            dropped=dropped, spans=spans, **fields)
    except Exception:
        return False


#: Attribution attributes lifted off a typed error into the flight dump
#: (the typed vocabularies: CommError op/rank/peer, ServeError
#: request/iteration, HandoffError engine, PagePoolExhausted
#: needed/free_pages, WorkerFailure exitcode/kind ...).
_ATTRIBUTION_ATTRS = ("op", "rank", "peer", "kind", "exitcode",
                      "request_id", "iteration", "engine", "needed",
                      "free_pages", "deadline_ms", "stage", "page",
                      "reason")


def on_typed_failure(exc: BaseException, **extra) -> bool:
    """Flight-dump on a typed failure path: reason = the exception class
    name, fields = its attribution attributes. The call sites are the
    raise points of the typed vocabularies (``HostComm._check``, the
    serve engines' fail paths, the multiprocess supervisor) — best
    effort by contract, it must never mask the error it annotates."""
    try:
        fields: Dict[str, Any] = {}
        for attr in _ATTRIBUTION_ATTRS:
            v = getattr(exc, attr, None)
            if v is not None and not callable(v):
                fields["err_" + attr] = v
        fields.update(extra)
        rank = fields.get("err_rank")
        return flight_dump(type(exc).__name__,
                           rank=rank if isinstance(rank, int) else None,
                           error=str(exc)[:300], **fields)
    except Exception:
        return False
