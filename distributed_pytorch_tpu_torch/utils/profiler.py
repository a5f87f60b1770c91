"""Tracing and profiling.

Counterpart of ``distributed_pytorch_tpu/utils/profiler.py`` on
``torch.profiler`` and CUDA events:

- **Device traces**: :func:`trace` / :func:`start_trace` /
  :func:`stop_trace` record host and (on the card) CUDA activity with
  ``torch.profiler`` and write a Chrome trace (``trace_<pid>_<n>.json``)
  into the log directory; :func:`annotate` names a region of it.
- **Step timing**: :class:`StepTimer` and :func:`time_steps_amortized`
  fence each measurement on the card with a CUDA event and a
  synchronize (PyTorch returns before the device finishes, so an
  unfenced host clock times the enqueue); :func:`fetch_fence` fences by
  a host read instead.
- **Cost of one call**: the JAX package asks XLA's compiled program
  without running it; PyTorch compiles nothing, so
  :func:`compiled_memory` runs the call once and reads the allocator's
  peak, and :func:`compiled_stats` profiles it once and counts its ops,
  kernel launches and the profiler's FLOP estimate.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..obs import trace as _dpxtrace
from ..runtime.context import map_tensors

# ---------------------------------------------------------------------------
# device traces
# ---------------------------------------------------------------------------

_TRACE_SEQ = itertools.count()
_active: Dict[str, Any] = {}


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_trace(logdir: str) -> None:
    """Start recording a profile that :func:`stop_trace` writes into
    ``logdir``. One trace at a time per process."""
    if _active:
        raise RuntimeError("a trace is already being recorded")
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    _active.update(prof=prof, logdir=logdir)


def stop_trace() -> str:
    """Stop the trace of :func:`start_trace`, write it and return its
    path."""
    if not _active:
        raise RuntimeError("no trace is being recorded")
    prof, logdir = _active.pop("prof"), _active.pop("logdir")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Record a host and device profile of the block into ``logdir``
    (a Chrome trace: chrome://tracing, Perfetto or TensorBoard)."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named region on the trace timeline, as a context manager or a
    decorator (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class CommStats:
    """Per-process communication accounting: calls, wall seconds and
    payload bytes on the wire, per collective op, each op's time split
    into ``overlapped_s`` (issued with ``hidden=True``: it hid behind
    compute) and ``exposed_s`` (the step waited on it)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.per_op: Dict[str, Dict[str, float]] = {}

    def record(self, op: str, nbytes: int, seconds: float,
               hidden: bool = False) -> None:
        d = self.per_op.setdefault(
            op, {"calls": 0, "seconds": 0.0, "bytes": 0,
                 "overlapped_s": 0.0, "exposed_s": 0.0})
        d["calls"] += 1
        d["seconds"] += seconds
        d["bytes"] += int(nbytes)
        d["overlapped_s" if hidden else "exposed_s"] += seconds

    @contextlib.contextmanager
    def timed(self, op: str, nbytes: int, hidden: bool = False):
        """Time a collective, record its wire bytes, and name it on the
        trace timeline (``comm:<op>``); with ``DPX_TRACE`` on also a
        dpxtrace span of that name (obs/trace.py), which puts every comm
        op on the cross-rank timeline with its overlapped-vs-exposed
        attribution (``hidden``)."""
        t0 = time.perf_counter()
        try:
            with annotate(f"comm:{op}"):
                with _dpxtrace.span(f"comm:{op}", bytes=int(nbytes),
                                    hidden=hidden):
                    yield
        finally:
            self.record(op, nbytes, time.perf_counter() - t0,
                        hidden=hidden)

    def snapshot(self) -> Dict[str, float]:
        """Totals so far, summed over ops."""
        out = {"calls": 0, "seconds": 0.0, "bytes": 0,
               "overlapped_s": 0.0, "exposed_s": 0.0}
        for d in self.per_op.values():
            for k in out:
                out[k] += d.get(k, 0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-op totals (a copy; safe to serialize)."""
        return {op: dict(d) for op, d in self.per_op.items()}

    def monitor_metrics(self) -> Dict[str, float]:
        """Flat ``{metric name: number}`` view: per-op calls and bytes,
        and the totals with the exposed / overlapped split in ms."""
        out: Dict[str, float] = {}
        for op, d in self.per_op.items():
            out[f"comm.{op}.calls"] = d["calls"]
            out[f"comm.{op}.bytes"] = d["bytes"]
        tot = self.snapshot()
        out["comm.calls"] = tot["calls"]
        out["comm.bytes"] = tot["bytes"]
        out["comm.exposed_ms"] = round(tot["exposed_s"] * 1e3, 3)
        out["comm.overlapped_ms"] = round(tot["overlapped_s"] * 1e3, 3)
        return out


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The CUDA caching allocator's stats of ``device`` (default: the
    current card; ``torch.cuda.memory_stats``); empty for a CPU device
    or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


# ---------------------------------------------------------------------------
# fences and step timing
# ---------------------------------------------------------------------------

def _cuda_devices(x: Any) -> List[torch.device]:
    devs: List[torch.device] = []

    def see(t):
        if t.is_cuda and t.device not in devs:
            devs.append(t.device)
        return t
    map_tensors(see, x)
    return devs


def block_until_ready(x: Any) -> Any:
    """Wait until the work producing ``x`` is done: on each card one of
    its tensors lives on, a CUDA event recorded on the current stream
    and waited for (a CPU tensor is ready when it exists). Returns
    ``x``."""
    for dev in _cuda_devices(x):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()
    return x


def fetch_fence(x: Any) -> None:
    """Read every tensor of ``x`` to the host: a copy cannot finish
    before its value exists. Fence with a scalar (the loss) so the copy
    itself costs nothing."""
    map_tensors(lambda t: t.detach().cpu(), x)


class StepTimer:
    """Wall-clock step timing with fencing: per step as a context
    manager (``h["fence"] = out.loss`` inside the block) or through
    :meth:`measure`. The first ``warmup`` steps are kept apart from the
    summary. ``fetch=True`` fences by a host read (:func:`fetch_fence`)
    instead of a CUDA event."""

    def __init__(self, warmup: int = 1, fetch: bool = False):
        self.warmup = warmup
        self.fetch = fetch
        self.times: List[float] = []
        self.warmup_times: List[float] = []

    def _fence(self, x: Any) -> None:
        if self.fetch:
            fetch_fence(x)
        else:
            block_until_ready(x)

    @contextlib.contextmanager
    def step(self, fence: Any = None):
        t0 = time.perf_counter()
        holder: Dict[str, Any] = {}
        try:
            yield holder
        finally:
            f = holder.get("fence", fence)
            if f is not None:
                self._fence(f)
            self._record(time.perf_counter() - t0)

    def measure(self, fn: Callable, *args, n: int = 10,
                fence_of: Optional[Callable] = None, **kwargs):
        """Time ``n`` calls of ``fn`` after its own ``warmup`` calls,
        fencing each result (``fence_of`` picks what to fence). Returns
        the last result."""
        out = None
        for i in range(self.warmup + n):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._fence(fence_of(out) if fence_of is not None else out)
            dt = time.perf_counter() - t0
            (self.warmup_times if i < self.warmup else self.times).append(dt)
        return out

    def _record(self, dt: float) -> None:
        if len(self.warmup_times) < self.warmup:
            self.warmup_times.append(dt)
        else:
            self.times.append(dt)

    @property
    def count(self) -> int:
        return len(self.times)

    def summary(self) -> Dict[str, float]:
        """mean/median/p10/p90 step seconds and steps/sec over the
        post-warmup samples."""
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": statistics.fmean(ts),
            "median_s": ts[n // 2],
            "p10_s": ts[max(0, int(0.10 * n) - 1)] if n >= 10 else ts[0],
            "p90_s": ts[min(n - 1, int(0.90 * n))],
            "steps_per_sec": n / sum(ts),
        }

    def throughput(self, items_per_step: int) -> float:
        """items/sec given a fixed per-step count."""
        s = self.summary()
        return s["steps_per_sec"] * items_per_step if s else 0.0


def time_steps_amortized(step_fn: Callable, state: Any, n: int,
                         fence_of: Callable[[Any], Any]
                         ) -> Tuple[float, Any]:
    """Throughput timing: ``n`` dependent iterations ``state =
    step_fn(state)`` with no per-step synchronization and one fence of
    ``fence_of(final_state)`` at the end, so the launches of one step
    overlap the device work of the previous one. ``step_fn`` must
    already be warm. Returns ``(seconds_per_step, final_state)``."""
    t0 = time.perf_counter()
    for _ in range(n):
        state = step_fn(state)
    block_until_ready(fence_of(state))
    return (time.perf_counter() - t0) / n, state


# ---------------------------------------------------------------------------
# cost of one call
# ---------------------------------------------------------------------------

def _nbytes(x: Any) -> int:
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t
    map_tensors(add, x)
    return total[0]


def compiled_memory(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Memory of one call of ``fn(*args, **kwargs)`` on the card: the
    argument and output bytes, and ``temp_size_bytes``, the allocator's
    peak above what was allocated before the call, less the outputs
    (the intermediates' high-water mark). Unlike XLA's analysis this
    runs the call. Empty without a card."""
    if not torch.cuda.is_available():
        return {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_bytes = _nbytes(out)
    return {"argument_size_bytes": float(_nbytes((args, kwargs))),
            "output_size_bytes": float(out_bytes),
            "temp_size_bytes": float(max(peak - out_bytes, 0))}


def compiled_stats(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """One profiled call of ``fn(*args, **kwargs)``: ``ops`` (the
    profiler's host op events), ``kernel_launches`` (device kernel
    events; 0 on the CPU) and ``flops`` (the profiler's estimate for
    the matmuls and convolutions it knows). Unlike XLA's cost model
    this runs the call."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=_activities(),
                                with_flops=True) as prof:
        fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"ops": float(len(host)),
            "kernel_launches": float(len(device)),
            "flops": float(sum(getattr(e, "flops", 0) or 0 for e in host))}
