"""The program's phases on a one-card trace: device time and idle under
the ``dpx.<span>`` ranges that the port opens on the profiler's clock
while a profiler records (``obs/trace.py``; the DDP engine's
``dp_step`` > ``forward`` / ``backward`` / ``grad_reduce`` / ``update``).

Read from a :class:`portbench.trace.Summary` built from events: its
lists hold each device op's name and interval and each host op's. They
carry no correlation ids, so a device op is matched to its launch by
order. On one stream the card runs its ops in the order the host called
the CUDA launch, copy and set functions, so the k-th such call inside
the window launched the k-th device op to start there. The profiler
drops a device record now and then (on an H100, 3 of 20,360 in one of
four traced XL windows, none in the others); each dropped record shifts
the match by one op, so a phase may take, at each of its ends, as many
ops of its neighbour as were dropped. The match is refused (None) where more than
:data:`DROPPED_SHARE` of the launches lack their device op, or where
there are more device ops than launches (a second stream). A device op
counts under every ``dpx.`` range open at its launch's start, an idle
gap under every one open at its midpoint.

None where the trace holds no ``dpx.`` range (a program without the
spans) or no host list (a data-parallel rank's reduced record).
Stdlib only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import yardstick

PREFIX = "dpx."
#: Host calls that put one operation on a device stream: the ``cuda*``
#: and ``cu*`` kernel launches, copies and sets.
LAUNCH_MARKS = ("LaunchKernel", "Memcpy", "Memset")
#: Share of the window's launches whose device record may be missing
#: before the order match is refused.
DROPPED_SHARE = 0.002


def is_launch(name: str) -> bool:
    """Whether a host op of that name is a launch, copy or set call."""
    return name.startswith("cu") and any(m in name for m in LAUNCH_MARKS)


def _ranges(summary) -> Optional[List[Tuple[str, float, float]]]:
    host = getattr(summary, "_host", None)
    if host is None:
        return None
    out = [(n[len(PREFIX):], s, e) for n, s, e in host
           if n.startswith(PREFIX)]
    return out or None


def _open_at(ranges, t: float) -> List[str]:
    return [n for n, s, e in ranges if s <= t <= e]


def device_by_phase(summary) -> Optional[Dict[str, float]]:
    """Device seconds launched under each ``dpx.`` range, by its span
    name (an op counts under each enclosing range)."""
    ranges = _ranges(summary)
    if ranges is None:
        return None
    lo, hi = summary.lo, summary.hi
    launches = sorted(s for n, s, _ in summary._host
                      if lo <= s <= hi and is_launch(n))
    ops = sorted(summary.device, key=lambda iv: (iv[1], iv[2]))
    dropped = len(launches) - len(ops)
    if not 0 <= dropped <= DROPPED_SHARE * len(launches):
        return None
    out = dict.fromkeys((n for n, _, _ in ranges), 0.0)
    for t, (_, s, e) in zip(launches, ops):
        for name in _open_at(ranges, t):
            out[name] += (e - s) / 1e6
    return out


def idle_by_phase(summary) -> Optional[Dict[str, float]]:
    """Device idle seconds while each ``dpx.`` range was open on the
    host (at each gap's midpoint), by its span name."""
    ranges = _ranges(summary)
    if ranges is None:
        return None
    out = dict.fromkeys((n for n, _, _ in ranges), 0.0)
    for s, e in yardstick.idle_gaps([(s, e) for _, s, e in summary.device],
                                    summary.lo, summary.hi):
        for name in _open_at(ranges, (s + e) / 2):
            out[name] += (e - s) / 1e6
    return out


def _per_step(ctx, trace, phase: str, reduce) -> Optional[float]:
    if ctx.get("kind") != "train" or trace is None:
        return None
    by_phase = reduce(trace)
    if not by_phase or phase not in by_phase:
        return None
    return 1e3 * by_phase[phase] / ctx["traced_steps"]


def device_ms_per_step(ctx, trace, phase: str) -> Optional[float]:
    """A reader's value: device ms per traced step launched under the
    span ``phase``; None where nothing ran under it or it is unknown."""
    return _per_step(ctx, trace, phase, device_by_phase)


def idle_ms_per_step(ctx, trace, phase: str) -> Optional[float]:
    """A reader's value: device idle ms per traced step while the span
    ``phase`` was open."""
    return _per_step(ctx, trace, phase, idle_by_phase)
