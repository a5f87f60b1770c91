"""dpxmon: the live runtime metrics registry (one per process).

Counterpart of ``distributed_pytorch_tpu/obs/metrics.py``, the same
instruments, names and snapshot records:

* **Typed instruments**: :class:`Counter` (monotone), :class:`Gauge`
  (last value), :class:`Histogram` (cumulative count/sum/min/max plus a
  bounded reservoir of the most recent values for window percentiles).
  Get-or-create by name via :func:`counter` / :func:`gauge` /
  :func:`histogram`, or the one-call :func:`inc` / :func:`set_gauge` /
  :func:`observe`; one name holds one type.
* **Providers**: pull-model sources polled once per snapshot
  (:func:`register_provider`): the host group's CommStats (registered by
  ``HostComm.__init__``), the fleet router's gauges, and the built-ins
  (process RSS, the flight recorder's span and drop counts).
* **Snapshots**: :func:`emit_snapshot` writes ONE rank-attributed
  ``metrics_snapshot`` line-JSON event through
  ``utils.logging.append_event``. :func:`on_train_step` is the train-loop
  hook: it counts steps, observes the host's inter-step cadence into
  ``train.step_ms`` (no device synchronization: on the card it is the
  cadence of the launches, which the host door's device-to-host copy
  paces) and emits every ``DPX_MON_EVERY`` steps.

With ``DPX_MON=0`` every instrument method is one module-global read
and one ``if``. The streaming health evaluator over these snapshots is
:mod:`.health`. Stdlib only; cross-package imports are lazy.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "MON_ENV", "EVERY_ENV", "RESERVOIR_CAP",
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "inc", "set_gauge", "observe",
    "register_provider", "unregister_provider",
    "enabled", "configure", "refresh", "reset", "set_rank",
    "snapshot", "emit_snapshot", "on_train_step", "validate_snapshot",
]

#: Env var: master switch for metric recording (0 = every instrument is
#: a no-op costing one global read).
MON_ENV = "DPX_MON"
#: Env var: auto-emit a snapshot every N train steps (0 disables the
#: automatic train-loop cadence; explicit emit_snapshot always works).
EVERY_ENV = "DPX_MON_EVERY"

#: Bounded histogram reservoir: percentiles are over the most recent
#: this-many observations (cumulative count/sum/min/max never drop).
RESERVOIR_CAP = 256


def _envreg():
    # lazy: this module must import with NOTHING but stdlib available
    # (the dpxmon CLI loads it in a bare venv)
    from ..runtime import env
    return env


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotone event count. Snapshot value: the cumulative total.
    Incremented from arbitrary threads (the serve engines' caller
    threads), so the read-modify-write is locked."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        st = _state
        if st is None or not st.enabled:
            return
        with self._lock:
            self.value += n

    def snap(self):
        return self.value


class Gauge:
    """Last-set value (queue depth, occupancy, steps/s)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        st = _state
        if st is None or not st.enabled:
            return
        self.value = float(v)

    def snap(self):
        return self.value


class Histogram:
    """Cumulative count/sum/min/max + a bounded reservoir of the most
    recent :data:`RESERVOIR_CAP` observations for window percentiles
    (p50/p99 of the RECENT window — the SLO-rule view; overwrites of
    older observations are implicit and bounded by construction)."""

    __slots__ = ("name", "count", "sum", "min", "max", "recent",
                 "_lock")

    def __init__(self, name: str, cap: int = RESERVOIR_CAP):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.recent: collections.deque = collections.deque(maxlen=cap)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        st = _state
        if st is None or not st.enabled:
            return
        v = float(v)
        # locked: observed from arbitrary threads; the reservoir must
        # also never mutate under snap()'s sorted() iteration
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self.recent.append(v)

    def snap(self) -> Optional[Dict[str, float]]:
        if not self.count:
            return None
        def q(xs, frac: float) -> float:
            return xs[min(len(xs) - 1, int(frac * (len(xs) - 1) + 0.5))]

        with self._lock:   # one consistent view of all five fields
            xs = sorted(self.recent)
            return {"count": self.count, "sum": round(self.sum, 6),
                    "min": self.min, "max": self.max,
                    "p50": q(xs, 0.50), "p99": q(xs, 0.99)}


# ---------------------------------------------------------------------------
# process-local registry state
# ---------------------------------------------------------------------------


class _State:
    __slots__ = ("enabled", "every", "instruments", "providers", "rank",
                 "lock", "steps", "last_emit_steps", "last_emit_ns",
                 "last_step_ns")

    def __init__(self, enabled: bool, every: int):
        self.enabled = enabled
        self.every = max(int(every), 0)
        self.instruments: Dict[str, Any] = {}
        self.providers: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self.rank: Optional[int] = None
        self.lock = threading.Lock()
        self.steps = 0
        self.last_emit_steps = 0
        self.last_emit_ns: Optional[int] = None
        self.last_step_ns: Optional[int] = None


_state: Optional[_State] = None
_state_lock = threading.Lock()


def _init() -> _State:
    global _state
    with _state_lock:
        if _state is None:
            env = _envreg()
            _state = _State(enabled=bool(env.get(MON_ENV)),
                            every=int(env.get(EVERY_ENV)))
        return _state


def refresh() -> None:
    """Re-read the ``DPX_MON*`` knobs; keeps rank, drops instruments
    (tests and long-lived programs that flip the env mid-process)."""
    global _state
    rank = None
    with _state_lock:
        if _state is not None:
            rank = _state.rank
        _state = None
    _init().rank = rank


def configure(enabled: Optional[bool] = None,
              every: Optional[int] = None,
              rank: Optional[int] = None) -> None:
    """Programmatic override of the env-derived config (benchmark arms,
    tests). Only the named fields change."""
    st = _init()
    if enabled is not None:
        st.enabled = bool(enabled)
    if every is not None:
        st.every = max(int(every), 0)
    if rank is not None:
        st.rank = int(rank)


def reset() -> None:
    """Drop all state (test isolation); next use re-reads the env."""
    global _state
    with _state_lock:
        _state = None


def enabled() -> bool:
    st = _state if _state is not None else _init()
    return st.enabled


def set_rank(rank: int) -> None:
    """Stamp this process's rank onto every subsequent snapshot (called
    by ``HostComm.__init__`` alongside ``trace.set_rank``)."""
    _init().rank = int(rank)


def _instrument(name: str, cls):
    st = _state if _state is not None else _init()
    inst = st.instruments.get(name)
    if inst is None:
        with st.lock:
            inst = st.instruments.get(name)
            if inst is None:
                inst = st.instruments[name] = cls(name)
    if not isinstance(inst, cls):
        raise TypeError(f"metric {name!r} is a {type(inst).__name__}, "
                        f"requested as {cls.__name__}")
    return inst


def counter(name: str) -> Counter:
    return _instrument(name, Counter)


def gauge(name: str) -> Gauge:
    return _instrument(name, Gauge)


def histogram(name: str) -> Histogram:
    return _instrument(name, Histogram)


def inc(name: str, n: int = 1) -> None:
    st = _state if _state is not None else _init()
    if not st.enabled:
        return
    counter(name).inc(n)


def set_gauge(name: str, v: float) -> None:
    st = _state if _state is not None else _init()
    if not st.enabled:
        return
    gauge(name).set(v)


def observe(name: str, v: float) -> None:
    st = _state if _state is not None else _init()
    if not st.enabled:
        return
    histogram(name).observe(v)


# ---------------------------------------------------------------------------
# providers (pull model, polled once per snapshot)
# ---------------------------------------------------------------------------


def register_provider(name: str,
                      fn: Callable[[], Dict[str, Any]]) -> None:
    """Register ``fn() -> {metric name: number}``, polled at snapshot
    time. Re-registering a name replaces the provider (elastic children
    and tests rebuild comms; the newest is the live one)."""
    _init().providers[name] = fn


def unregister_provider(name: str) -> None:
    _init().providers.pop(name, None)


def _rss_bytes() -> Optional[int]:
    """Current resident set, /proc (Linux); None where unavailable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return None


def _builtin_metrics() -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    rss = _rss_bytes()
    if rss is not None:
        out["proc.rss_bytes"] = rss
    # dpxtrace flight-recorder accounting: recorded spans + counted
    # drops (0/0 when tracing is off — still reported, the health rule
    # vocabulary expects the key space to be stable)
    from . import trace as _trace
    tst = _trace._state
    if tst is not None:
        out["obs.spans_recorded"] = tst.recorded
        out["obs.flight_dropped"] = tst.dropped
    return out


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


def snapshot() -> Dict[str, Any]:
    """The registry's current view: every instrument (histograms as
    ``{count,sum,min,max,p50,p99}`` dicts) + one poll of every provider
    + the built-ins (RSS, flight-recorder drops). Unset gauges and
    empty histograms are omitted — absent means never-observed, and the
    health evaluator treats absent as not-evaluable, never as zero."""
    st = _state if _state is not None else _init()
    out: Dict[str, Any] = {}
    for name, inst in list(st.instruments.items()):
        v = inst.snap()
        if v is not None:
            out[name] = v
    for pname, fn in list(st.providers.items()):
        try:
            polled = fn() or {}
        except Exception:  # noqa: BLE001 — a provider must never take
            continue       # down the snapshot path
        for k, v in polled.items():
            if v is not None:
                out[k] = v
    out.update(_builtin_metrics())
    return out


def _resolve_rank(st: _State) -> Optional[int]:
    if st.rank is not None:
        return st.rank
    from . import trace as _trace
    if _trace._state is not None and _trace._state.rank is not None:
        return _trace._state.rank
    try:
        from ..runtime import context
        return int(context.get_rank())
    except Exception:  # noqa: BLE001 — bare-venv / pre-init use
        return None


def emit_snapshot(path: Optional[str] = None,
                  step: Optional[int] = None,
                  source: str = "process", **extra) -> bool:
    """Write ONE rank-attributed ``metrics_snapshot`` line-JSON event
    (``path`` defaults to ``$DPX_METRICS_LOG`` via ``append_event``).
    No-op (False) when recording is disabled or no sink is configured —
    observability must never take down the instrumented path."""
    st = _state if _state is not None else _init()
    if not st.enabled:
        return False
    try:
        snap = snapshot()
        from ..utils.logging import append_event
        return append_event("metrics_snapshot", path=path,
                            rank=_resolve_rank(st), step=step,
                            source=source, metrics=snap, **extra)
    except Exception:  # noqa: BLE001
        return False


def on_train_step(source: str = "train") -> None:
    """Train-loop hook (the host/front-door steps call it once per
    step): counts ``train.steps``, observes the inter-step cadence into
    ``train.step_ms``, and — every ``DPX_MON_EVERY`` steps — refreshes
    ``train.steps_per_sec`` from the wall delta since the last emission
    and writes a snapshot. One global read + one ``if`` when disabled
    (the hot-path contract)."""
    st = _state if _state is not None else _init()
    if not st.enabled:
        return
    now = time.perf_counter_ns()
    st.steps += 1
    counter("train.steps").inc()
    if st.last_step_ns is not None:
        histogram("train.step_ms").observe((now - st.last_step_ns) / 1e6)
    st.last_step_ns = now
    if st.every and st.steps % st.every == 0:
        if st.last_emit_ns is not None and now > st.last_emit_ns:
            sps = ((st.steps - st.last_emit_steps)
                   / ((now - st.last_emit_ns) / 1e9))
            gauge("train.steps_per_sec").set(round(sps, 3))
        st.last_emit_ns = now
        st.last_emit_steps = st.steps
        emit_snapshot(step=st.steps, source=source)


# ---------------------------------------------------------------------------
# strict snapshot validation (the dpxmon `check` contract)
# ---------------------------------------------------------------------------

_HIST_KEYS = ("count", "sum", "min", "max", "p50", "p99")


def validate_snapshot(rec: Dict[str, Any]) -> List[str]:
    """Strictly validate one ``metrics_snapshot`` record. Returns issue
    strings (empty = valid): rank attribution is REQUIRED (a per-rank
    metric stream that cannot say which rank it came from is
    ungreppable in a multi-writer log), ``metrics`` must be a dict of
    name -> number | histogram-summary, histogram summaries must carry
    every expected key as a number."""
    issues: List[str] = []
    if not isinstance(rec.get("rank"), int):
        issues.append("metrics_snapshot carries no integer rank "
                      "attribution")
    if not isinstance(rec.get("time"), (int, float)):
        issues.append("metrics_snapshot carries no numeric time")
    if not isinstance(rec.get("source"), str):
        issues.append("metrics_snapshot carries no source")
    metrics = rec.get("metrics")
    if not isinstance(metrics, dict):
        issues.append("metrics_snapshot carries no metrics dict")
        return issues
    for name, v in metrics.items():
        if isinstance(v, bool) or not isinstance(v, (int, float, dict)):
            issues.append(f"metric {name!r}: value {v!r} is neither a "
                          f"number nor a histogram summary")
        elif isinstance(v, dict):
            for k in _HIST_KEYS:
                if not isinstance(v.get(k), (int, float)) \
                        or isinstance(v.get(k), bool):
                    issues.append(f"metric {name!r}: histogram summary "
                                  f"missing numeric {k!r}")
                    break
    return issues
