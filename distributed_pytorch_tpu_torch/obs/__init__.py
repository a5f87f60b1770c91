"""obs: cross-rank observability of the port: span tracing, the flight
recorder, Chrome-trace export, straggler detection, live metrics and
streaming SLO health.

Counterpart of ``distributed_pytorch_tpu/obs/``; the records are the
JAX package's, so its stdlib CLIs (``tools/dpxtrace.py`` merge / export
/ summarize / stragglers / check and ``tools/dpxmon.py`` replay /
follow / check) read a port log unchanged.

* :mod:`.trace`: the span API and per-rank flight recorder that the
  instrumented seams (comm ops, the host train step, the serve request
  lifecycle, checkpoint phases) write through; also the process wall
  anchor behind ``utils.logging``'s monotone timestamps.
* :mod:`.export`: per-rank line-JSON span logs merged into Chrome
  trace-event JSON (rank -> pid, thread -> tid, clocks aligned at
  collective exits), and the log vocabulary with its validator.
* :mod:`.detect`: per-op per-rank duration medians and the k * IQR
  straggler fence.
* :mod:`.metrics`: the dpxmon registry: counters, gauges, histograms,
  pull providers, rank-attributed ``metrics_snapshot`` events.
* :mod:`.health`: declarative SLO rules over snapshot windows and the
  ok -> degraded -> critical state machine with hysteresis.

Stdlib only, with lazy cross-package imports.
"""

from . import detect, export, health, metrics, trace  # noqa: F401
from .trace import (enabled, event, flight_dump, flight_snapshot,  # noqa: F401
                    new_trace_id, on_typed_failure, span, wall_now)

__all__ = [
    "trace", "export", "detect", "metrics", "health",
    "span", "event", "enabled", "new_trace_id", "wall_now",
    "flight_dump", "flight_snapshot", "on_typed_failure",
]
