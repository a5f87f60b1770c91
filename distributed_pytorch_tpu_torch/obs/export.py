"""Merge per-rank span logs into Chrome trace-event JSON, and the
vocabulary of the line-JSON stream.

Counterpart of ``distributed_pytorch_tpu/obs/export.py``, the same
functions on the same records:

* **rank -> pid, thread -> tid**: each rank renders as one process row,
  its control thread, serve-engine thread and checkpoint-io thread as
  lanes within it;
* **cross-rank clock alignment**: each process stamps spans against its
  own wall anchor, so rank clocks differ by the anchors' skew. Collective
  exits are synchronization points, so :func:`estimate_offsets` matches
  ``comm:*`` spans across ranks by (op name, occurrence) and shifts each
  rank by the median end-time delta against the lowest rank (barriers
  alone where every rank has one); the offsets are reported in the
  trace's metadata.

:data:`KNOWN_EVENTS` is the vocabulary of every event name the package
writes; :func:`check_log` flags malformed lines, unknown names and
failure events without a rank. Stdlib only.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "KNOWN_EVENTS", "FAILURE_EVENTS", "read_log", "collect_spans",
    "chrome_trace", "estimate_offsets", "check_log",
]

#: Every event name the framework writes into the line-JSON stream
#: (``utils.logging.append_event`` / ``MetricsLogger.event`` call
#: sites). The ``check`` validator flags names outside this vocabulary
#: — a typo'd event is invisible to every consumer that greps by name.
KNOWN_EVENTS = frozenset({
    # runtime / supervision
    "worker_failure", "comm_schedule", "schedule_divergence",
    "elastic_reconfigured", "elastic_recovered", "elastic_worker_exit",
    "elastic_giveup",
    # checkpointing
    "ckpt_save", "ckpt_restore",
    # serving
    "serve_request",
    # perfbench trajectory rows
    "bench_row",
    # observability (this subsystem)
    "trace_span", "flight_recorder", "fault_injected",
    # chaos campaigns (runtime/chaos.py + benchmarks/chaos_campaign.py):
    # one comm_retry per transient-fault retry (op/rank/attempt/backoff
    # attributed — a retry is never silent), one chaos_clause per
    # campaign clause verdict (fired / typed error / attribution /
    # recovery)
    "comm_retry", "chaos_clause",
    # dpxmon live monitoring (obs/metrics.py + obs/health.py): per-rank
    # registry snapshots and the SLO state machine's transitions
    "metrics_snapshot", "health_transition",
    # multi-replica fleet (serve/fleet/): one fleet_route per routed
    # request (home/replica/spilled attributed), one fleet_spill per
    # back-pressure spill (from/to replica), one fleet_scale per
    # scaling decision (add/drain/revive, rule attributed), and the
    # replica lifecycle edges — replica_failed is failure-shaped
    # (rank = replica id) and degrades that replica's health stream
    "fleet_route", "fleet_spill", "fleet_scale", "replica_drained",
    "replica_failed",
})

#: Failure-shaped events that MUST carry rank attribution — a failure
#: record that cannot say which rank it came from is ungreppable in a
#: multi-writer stream.
FAILURE_EVENTS = frozenset({"worker_failure", "comm_schedule",
                            "flight_recorder", "replica_failed"})


def read_log(path: str) -> Tuple[List[Dict[str, Any]],
                                 List[Tuple[int, str]]]:
    """Parse one line-JSON log. Returns ``(records, malformed)`` where
    each record gains ``_line`` (1-based) and malformed is
    ``[(line_no, reason)]`` — the log is a shared multi-writer file, so
    damage is surfaced with line numbers, never silently skipped."""
    records: List[Dict[str, Any]] = []
    malformed: List[Tuple[int, str]] = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                malformed.append((i, f"invalid JSON: {e.msg}"))
                continue
            if not isinstance(rec, dict):
                malformed.append((i, "not a JSON object"))
                continue
            rec["_line"] = i
            records.append(rec)
    return records, malformed


def collect_spans(records: Iterable[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Span records from a merged event stream: ``trace_span`` events
    plus the spans embedded in ``flight_recorder`` dumps (a killed rank
    may have shipped spans ONLY through its dump), deduplicated by
    span_id — dump spans already live-logged must not render twice."""
    spans: List[Dict[str, Any]] = []
    seen: set = set()

    def add(rec: Dict[str, Any]) -> None:
        sid = rec.get("span_id")
        if sid is not None and sid in seen:
            return
        if sid is not None:
            seen.add(sid)
        if not isinstance(rec.get("t0_wall"), (int, float)):
            return
        if not isinstance(rec.get("dur_ns"), (int, float)):
            # damaged/foreign record in the shared stream: render as an
            # instant rather than crash the whole export on arithmetic
            rec = dict(rec)
            rec["dur_ns"] = 0
        spans.append(rec)

    for rec in records:
        ev = rec.get("event")
        if ev == "trace_span":
            add(rec)
        elif ev == "flight_recorder":
            for s in rec.get("spans") or []:
                if isinstance(s, dict):
                    add(s)
    spans.sort(key=lambda s: s.get("t0_wall", 0.0))
    return spans


def _span_rank(s: Dict[str, Any]):
    r = s.get("rank")
    return r if r is not None else s.get("pid")


def estimate_offsets(spans: Sequence[Dict[str, Any]]
                     ) -> Dict[Any, float]:
    """Per-rank clock offsets (seconds, relative to the lowest rank)
    estimated from matched collective exits.

    For each rank, ``comm:*`` span END times are collected per op name
    in occurrence order; against the reference rank, the k-th exit of
    the same op happened "at the same time" up to one network hop, so
    ``offset = median(end_r[k] - end_ref[k])``. Barrier spans alone are
    used when every rank has one (the tightest sync point); otherwise
    all comm ops contribute. Ranks with no matchable comm spans get 0.
    """
    by_rank: Dict[Any, Dict[str, List[float]]] = {}
    for s in spans:
        name = s.get("name") or ""
        if not name.startswith("comm:"):
            continue
        r = _span_rank(s)
        end = s.get("t0_wall", 0.0) + s.get("dur_ns", 0) / 1e9
        by_rank.setdefault(r, {}).setdefault(name, []).append(end)
    if len(by_rank) < 2:
        return {r: 0.0 for r in by_rank}
    ranks = sorted(by_rank, key=lambda r: (r is None, r))
    ref = ranks[0]
    use_barrier = all("comm:barrier" in ops for ops in by_rank.values())
    offsets: Dict[Any, float] = {ref: 0.0}
    for r in ranks[1:]:
        deltas: List[float] = []
        for op, ends in by_rank[r].items():
            if use_barrier and op != "comm:barrier":
                continue
            ref_ends = by_rank[ref].get(op, [])
            for k in range(min(len(ends), len(ref_ends))):
                deltas.append(ends[k] - ref_ends[k])
        if deltas:
            deltas.sort()
            offsets[r] = deltas[len(deltas) // 2]
        else:
            offsets[r] = 0.0
    return offsets


def chrome_trace(records: Iterable[Dict[str, Any]],
                 align: bool = True) -> Dict[str, Any]:
    """Build the Chrome trace-event JSON dict from a merged event
    stream: complete ("X") events per span, instant ("i") events for
    zero-duration records (fault injections), process-name metadata per
    rank, and the estimated clock offsets in ``otherData``."""
    spans = collect_spans(records)
    offsets = estimate_offsets(spans) if align else {}
    events: List[Dict[str, Any]] = []
    ranks_seen: Dict[Any, None] = {}
    for s in spans:
        r = _span_rank(s)
        ranks_seen.setdefault(r, None)
        ts_s = s.get("t0_wall", 0.0) - offsets.get(r, 0.0)
        dur_us = s.get("dur_ns", 0) / 1e3
        ev: Dict[str, Any] = {
            "name": s.get("name", "?"),
            "ph": "i" if s.get("ph") == "i" else "X",
            "pid": r if isinstance(r, int) else -1,
            "tid": str(s.get("tid", "main")),
            "ts": ts_s * 1e6,
            "args": {k: v for k, v in (s.get("attrs") or {}).items()},
        }
        if ev["ph"] == "X":
            ev["dur"] = dur_us
        else:
            ev["s"] = "p"      # process-scoped instant marker
        for key in ("trace_id", "span_id", "parent_id"):
            if s.get(key) is not None:
                ev["args"][key] = s[key]
        events.append(ev)
        for sub in s.get("events") or []:
            if not isinstance(sub, dict):
                continue
            events.append({
                "name": sub.get("name", "?"), "ph": "i", "s": "t",
                "pid": ev["pid"], "tid": ev["tid"],
                "ts": (sub.get("t_wall", 0.0)
                       - offsets.get(r, 0.0)) * 1e6,
                "args": {k: v for k, v in sub.items()
                         if k not in ("name", "t_wall")},
            })
    for r in ranks_seen:
        events.append({
            "name": "process_name", "ph": "M",
            "pid": r if isinstance(r, int) else -1, "tid": "",
            "args": {"name": (f"rank {r}" if isinstance(r, int)
                              else "unattributed")},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock_offsets_s": {str(k): round(v, 6)
                                for k, v in offsets.items()},
            "n_spans": len(spans),
        },
    }


def check_log(records: Sequence[Dict[str, Any]],
              malformed: Sequence[Tuple[int, str]]
              ) -> List[Tuple[Optional[int], str]]:
    """The strict metrics-log validator behind ``dpxtrace check``.

    Issues (``(line_no, message)``): malformed JSON lines, records that
    are neither a named event nor a step record, event names outside
    :data:`KNOWN_EVENTS`, and failure-shaped events with no rank
    attribution. An empty return = the log is well-formed."""
    issues: List[Tuple[Optional[int], str]] = [
        (ln, f"malformed line: {why}") for ln, why in malformed]
    for rec in records:
        line = rec.get("_line")
        ev = rec.get("event")
        if ev is None:
            # MetricsLogger.log step records carry `step`, no `event`
            if "step" not in rec:
                issues.append(
                    (line, "record is neither a named event nor a "
                           "step record (no 'event'/'step' key)"))
            continue
        if ev not in KNOWN_EVENTS:
            issues.append(
                (line, f"unknown event name {ev!r} (not in the "
                       f"KNOWN_EVENTS vocabulary — obs/export.py)"))
        if ev in FAILURE_EVENTS and rec.get("rank") is None:
            issues.append(
                (line, f"failure event {ev!r} carries no rank "
                       f"attribution"))
    return issues
