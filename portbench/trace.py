"""Device traces: ``torch.profiler`` over a marked window, reduced to
what the per-layer readers and the result's ``breakdown`` read.

The traced window is a ``record_function`` range, :data:`WINDOW`, so its
ends sit on the profiler's own clock beside the kernels. Device
operations (kernels, copies, sets) are clipped to it; busy time is the
union of their intervals; idle gaps are named by the innermost host
operation running at the gap's midpoint.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from . import yardstick

WINDOW = "portbench.window"
NAME_CHARS = 160
#: Host-side ranges the benchmark wraps around its calls into the
#: program in a traced run.
SPAN_PREFIX = "portbench."

Interval = Tuple[str, float, float]          # (name, start_us, end_us)


class Capture:
    """Start and stop a trace around part of a run. ``start`` waits for
    the device first; ``stop`` waits for it before closing the window
    unless told not to; ``summarize`` reduces what was recorded."""

    def __init__(self):
        self.summary: Optional[Summary] = None
        self._prof = self._range = None
        self.stopped = False

    def start(self, all_threads: bool = False) -> None:
        """Begin recording; ``all_threads`` records the host operations
        of every thread (a serving engine runs its own loop thread),
        where this torch can, at a cost to the host that training,
        driven from one thread, need not pay."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts, **(_all_threads() if all_threads else {}))
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self, sync: bool = True) -> None:
        import torch
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._range = None
        self.stopped = True

    def summarize(self) -> "Summary":
        """Reduce the trace: called once the measured window has closed,
        since reading the events holds the interpreter for seconds."""
        if self.summary is None:
            self.summary = from_events(self._prof.events())
            self._prof = None
        return self.summary


def _all_threads() -> dict:
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def from_events(events) -> "Summary":
    """Split ``torch.profiler`` events into device operations and host
    operations and reduce them."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for e in events:
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = iv
            else:
                host.append(iv)
        elif not getattr(e, "is_user_annotation", False):
            device.append(iv)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return Summary(device, host, window[1], window[2])


class Summary:
    """One traced window, in seconds."""

    def __init__(self, device: List[Interval], host: List[Interval],
                 lo_us: float, hi_us: float):
        self.lo, self.hi = lo_us, hi_us
        self.window_s = (hi_us - lo_us) / 1e6
        inside = [(n, max(s, lo_us), min(e, hi_us)) for n, s, e in device
                  if min(e, hi_us) > max(s, lo_us)]
        self.device = inside
        self.busy_s = yardstick.union_seconds(
            [(s, e) for _, s, e in inside], lo_us, hi_us) / 1e6
        self.by_class: Dict[str, float] = {}
        self.launches: Dict[str, int] = {}
        self.by_name: Dict[str, float] = {}
        for n, s, e in inside:
            cls = yardstick.classify(n)
            self.by_class[cls] = self.by_class.get(cls, 0.0) + (e - s) / 1e6
            self.launches[cls] = self.launches.get(cls, 0) + 1
            self.by_name[n] = self.by_name.get(n, 0.0) + (e - s) / 1e6
        self._host = sorted(host, key=lambda iv: iv[1])
        self.idle_by_host = self._name_gaps(
            yardstick.idle_gaps([(s, e) for _, s, e in inside], lo_us, hi_us))

    def _name_gaps(self, gaps) -> Dict[str, float]:
        """Idle seconds by the innermost host operation running at each
        gap's midpoint (the shortest range that covers it), under the
        benchmark span around it if any: one sweep over both lists."""
        out: Dict[str, float] = {}
        ops, spans, i = [], [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            t = (s + e) / 2
            while i < len(self._host) and self._host[i][1] <= t:
                name, hs, he = self._host[i]
                heapq.heappush(spans if name.startswith(SPAN_PREFIX)
                               else ops, (he - hs, he, name))
                i += 1
            for heap in (ops, spans):
                while heap and heap[0][1] < t:
                    heapq.heappop(heap)
            inner = ops[0][2] if ops else "no host op"
            name = f"{spans[0][2]} > {inner}" if spans else inner
            name = name[:NAME_CHARS]
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def to_record(self) -> dict:
        """What a rank process sends back: the reduced numbers only."""
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "by_class": self.by_class, "launches": self.launches,
                "by_name": self.by_name, "idle_by_host": self.idle_by_host}

    @classmethod
    def from_record(cls, rec: dict) -> "Summary":
        self = cls.__new__(cls)
        for key, value in rec.items():
            setattr(self, key, value)
        return self

    def launches_of(self, cls: str) -> int:
        return self.launches.get(cls, 0)

    def seconds_of(self, cls: str) -> float:
        return self.by_class.get(cls, 0.0)

    def breakdown(self) -> dict:
        """The result's ``breakdown``: the ten device operations that
        took most time, and the idle time by what the host was doing."""
        def top(d):
            return [[n[:NAME_CHARS], v] for n, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_name),
                "idle_gaps": top(self.idle_by_host)}
