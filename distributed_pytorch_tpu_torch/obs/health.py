"""Streaming SLO health evaluation over ``metrics_snapshot`` windows.

Counterpart of ``distributed_pytorch_tpu/obs/health.py``: the same rule
grammar, default rules, state machine and transition records.

**Rule grammar** (``parse_rules``; the ``DPX_MON_RULES`` knob and
``dpxmon --rules`` both speak it)::

    rules  = rule (';' rule)*
    rule   = metric '<=' number opts?      # ceiling: breach when value > n
           | metric '>=' number opts?      # floor:   breach when value < n
           | 'drift(' metric ')' opts?     # value below the trailing
                                           # median beyond the IQR gate
           | 'growth(' metric ')' opts?    # monotone growth across the
                                           # whole window (leak suspicion)
    opts   = '@' key '=' val (',' key '=' val)*
    keys   = window | k | floor | grow | name

Metric names resolve against the snapshot's ``metrics`` dict; a
``.p50`` / ``.p99`` / ``.max`` ... suffix reaches into a histogram
summary. A rule whose metric is ABSENT from a snapshot neither breaches
nor clears.

**State machine** (:class:`HealthMonitor`): per (rule, rank) breach
streaks with hysteresis: ``degrade_after`` consecutive breaches mark the
stream degraded, ``critical_after`` critical, ``recover_after``
consecutive clean evaluations recover it. The overall state is the
worst stream's; each overall transition is returned and, with a log
path, written as a rank-attributed ``health_transition`` event naming
the rule and metric. ``worker_failure`` / ``elastic_worker_exit`` /
``replica_failed`` events degrade the named rank's stream at once (the
``worker-failure`` pseudo-rule; a later snapshot from that rank, or a
fleet snapshot naming the replica live, clears it), and
``elastic_giveup`` is critical outright.

Stdlib only with lazy imports.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "OK", "DEGRADED", "CRITICAL", "STATES", "Rule", "parse_rules",
    "DEFAULT_RULES", "FAILURE_RULE", "resolve_metric", "HealthMonitor",
    "LogFollower", "scan_records",
]

OK, DEGRADED, CRITICAL = "ok", "degraded", "critical"
STATES = (OK, DEGRADED, CRITICAL)
_SEVERITY = {OK: 0, DEGRADED: 1, CRITICAL: 2}

#: Name of the built-in pseudo-rule failure events breach.
FAILURE_RULE = "worker-failure"

#: The default rule set the soak harness and dpxmon evaluate when no
#: spec is given: serve TTFT/TPOT p99 ceilings (generous: a contended
#: CPU host must pass them), throughput drift vs the trailing
#: median beyond the IQR gate, monotone RSS growth, pool saturation.
DEFAULT_RULES = (
    "serve.ttft_ms.p99<=30000;"
    "serve.tpot_ms.p99<=10000;"
    "drift(train.steps_per_sec)@k=3,floor=0.25;"
    "growth(proc.rss_bytes)@window=8,grow=0.05;"
    "serve.pool_occupancy<=0.98"
)


def _stats():
    # lazy: resolves under the dpxmon CLI's fabricated parents too
    from ..perfbench import stats
    return stats


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative SLO rule (see the module grammar)."""

    name: str
    kind: str                      # 'max' | 'min' | 'drift' | 'growth'
    metric: str
    threshold: Optional[float] = None
    window: int = 8                # trailing snapshots (drift/growth)
    k: float = 3.0                 # IQR multiplier (drift)
    rel_floor: float = 0.10        # minimum relative drop (drift)
    min_growth: float = 0.02       # net growth fraction (growth)


_RULE_FN_RE = re.compile(r"^(drift|growth)\(\s*([^)\s]+)\s*\)$")


def _parse_opts(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in filter(None, (t.strip() for t in text.split(","))):
        key, eq, val = tok.partition("=")
        if not eq:
            raise ValueError(f"bad rule option {tok!r}")
        out[key.strip()] = val.strip()
    return out


def parse_rules(spec: str) -> List[Rule]:
    """Parse a rule spec (module grammar). Raises ``ValueError`` on
    malformed input — a typo'd SLO that silently monitors nothing would
    make a soak gate vacuously green (the DPX_FAULT parser's
    contract)."""
    rules: List[Rule] = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        body, _, opt_text = part.partition("@")
        body = body.strip()
        opts = _parse_opts(opt_text) if opt_text else {}
        kw: Dict[str, Any] = {}
        if "window" in opts:
            kw["window"] = int(opts["window"])
        if "k" in opts:
            kw["k"] = float(opts["k"])
        if "floor" in opts:
            kw["rel_floor"] = float(opts["floor"])
        if "grow" in opts:
            kw["min_growth"] = float(opts["grow"])
        m = _RULE_FN_RE.match(body)
        if m:
            kind, metric = m.group(1), m.group(2)
            if kw.get("window", 8) < 4:
                # drift needs >= 3 trailing values and growth >= 4
                # history entries, both trimmed to the window — a
                # smaller window can never evaluate, i.e. the silently-
                # vacuous SLO this parser exists to reject
                raise ValueError(
                    f"rule {part!r}: {kind} needs window >= 4 "
                    f"(got {kw['window']}) — a smaller window never "
                    f"accumulates enough history to evaluate")
            rules.append(Rule(name=opts.get("name", f"{kind}:{metric}"),
                              kind=kind, metric=metric, **kw))
            continue
        for op, kind in (("<=", "max"), (">=", "min")):
            if op in body:
                metric, _, num = body.partition(op)
                metric = metric.strip()
                try:
                    threshold = float(num)
                except ValueError:
                    raise ValueError(
                        f"bad threshold in rule {part!r}") from None
                rules.append(Rule(
                    name=opts.get("name", f"{metric}{op}{num.strip()}"),
                    kind=kind, metric=metric, threshold=threshold, **kw))
                break
        else:
            raise ValueError(
                f"unparseable rule {part!r} (expected metric<=n, "
                f"metric>=n, drift(metric) or growth(metric))")
    return rules


def resolve_metric(metrics: Dict[str, Any], name: str):
    """Look ``name`` up in a snapshot's metrics dict; a dotted suffix
    (``serve.ttft_ms.p99``) reaches into a histogram summary. Returns
    None when absent (absent = not evaluable, never zero)."""
    v = metrics.get(name)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v
    if v is None and "." in name:
        base, _, sub = name.rpartition(".")
        parent = metrics.get(base)
        if isinstance(parent, dict):
            vv = parent.get(sub)
            if isinstance(vv, (int, float)) and not isinstance(vv, bool):
                return vv
    if isinstance(v, dict):
        return None   # a bare histogram needs a .pXX suffix
    return None


class _Stream:
    """Per-(rule, rank) hysteresis state."""

    __slots__ = ("state", "breaches", "clears", "history", "last_value",
                 "total_breaches")

    def __init__(self):
        self.state = OK
        self.breaches = 0
        self.clears = 0
        self.history: List[float] = []
        self.last_value: Optional[float] = None
        self.total_breaches = 0   # never resets — the audit view


class HealthMonitor:
    """Feed line-JSON records in time order; read back transitions and
    the current verdict (see the module docstring for the semantics)."""

    def __init__(self, rules: Optional[Iterable[Rule]] = None, *,
                 degrade_after: int = 1, critical_after: int = 3,
                 recover_after: int = 2,
                 emit_path: Optional[str] = None):
        self.rules: List[Rule] = list(
            parse_rules(DEFAULT_RULES) if rules is None else rules)
        self.degrade_after = max(int(degrade_after), 1)
        self.critical_after = max(int(critical_after),
                                  self.degrade_after)
        self.recover_after = max(int(recover_after), 1)
        self.emit_path = emit_path
        self.state = OK
        self.transitions: List[Dict[str, Any]] = []
        self._streams: Dict[Tuple[str, Any], _Stream] = {}
        self._snapshots_seen = 0

    # -- stream updates -----------------------------------------------------

    def _stream(self, rule_name: str, rank) -> _Stream:
        return self._streams.setdefault((rule_name, rank), _Stream())

    def _breach(self, s: _Stream, critical: bool = False) -> None:
        s.breaches += 1
        s.total_breaches += 1
        s.clears = 0
        if critical or s.breaches >= self.critical_after:
            new = CRITICAL
        elif s.breaches >= self.degrade_after:
            new = DEGRADED
        else:
            new = s.state
        # escalate only: a breach can never DOWNGRADE a stream (a
        # critical stream re-breaching after one clean snapshot must
        # not fall back to degraded on streak arithmetic)
        if _SEVERITY[new] > _SEVERITY[s.state]:
            s.state = new

    def _clear(self, s: _Stream) -> None:
        s.clears += 1
        # one clean evaluation breaks the CONSECUTIVE-breach streak
        # (critical_after means consecutive: ok↔degraded flapping at
        # the boundary must never escalate to critical) ...
        s.breaches = 0
        # ... but recovery itself is hysteretic: the state clears only
        # after recover_after consecutive clean evaluations
        if s.state != OK and s.clears >= self.recover_after:
            s.state = OK

    def _evaluate_rule(self, rule: Rule, rank, metrics: Dict[str, Any]
                       ) -> None:
        value = resolve_metric(metrics, rule.metric)
        if value is None:
            return   # absent: neither breach nor clear
        s = self._stream(rule.name, rank)
        s.last_value = value
        if rule.kind in ("drift", "growth"):
            s.history.append(float(value))
            if len(s.history) > max(rule.window, 2):
                del s.history[:len(s.history) - rule.window]
        breached = False
        if rule.kind == "max":
            breached = value > rule.threshold
        elif rule.kind == "min":
            breached = value < rule.threshold
        elif rule.kind == "drift":
            trailing = s.history[:-1]
            if len(trailing) >= 3:   # single/small windows: not evaluable
                st = _stats()
                agg = st.summarize(trailing, warmup=0,
                                   max_spread=float("inf"))
                gate = max(rule.k * agg.iqr,
                           rule.rel_floor * abs(agg.median))
                breached = value < agg.median - gate
        elif rule.kind == "growth":
            h = s.history
            if len(h) >= max(rule.window, 4) and h[0] > 0:
                monotone = all(b >= a for a, b in zip(h, h[1:]))
                breached = (monotone
                            and (h[-1] - h[0]) / h[0] >= rule.min_growth)
        if breached:
            self._breach(s)
        else:
            self._clear(s)

    # -- feeding ------------------------------------------------------------

    def feed(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Consume one record; returns the overall-state transitions it
        caused (usually empty)."""
        ev = rec.get("event")
        if ev == "metrics_snapshot":
            metrics = rec.get("metrics")
            rank = rec.get("rank")
            if isinstance(metrics, dict):
                self._snapshots_seen += 1
                for rule in self.rules:
                    self._evaluate_rule(rule, rank, metrics)
                # a live, reporting rank is a clean observation for its
                # failure pseudo-rule (the elastic-recovery half); the
                # rank-None stream (attempt-level elastic_worker_exit
                # events carry no rank) is cleared by ANY snapshot —
                # a reporting world is the evidence the job came back
                for key in ((FAILURE_RULE, rank), (FAILURE_RULE, None)):
                    if key in self._streams:
                        self._clear(self._streams[key])
                # a fleet snapshot names its live replica set
                # (serve/fleet/router.py): each named replica is a
                # clean observation for ITS failure stream — the
                # replica_failed events key on rank = replica id, so a
                # revived replica shows as degraded → ok with replica
                # attribution
                reps = rec.get("replicas")
                if isinstance(reps, (list, tuple)):
                    for r in reps:
                        key = (FAILURE_RULE, r)
                        if key in self._streams:
                            self._clear(self._streams[key])
        elif ev in ("worker_failure", "elastic_worker_exit",
                    "replica_failed"):
            s = self._stream(FAILURE_RULE, rec.get("rank"))
            s.breaches = max(s.breaches, self.degrade_after)
            s.total_breaches += 1
            s.clears = 0
            if s.state == OK:
                s.state = DEGRADED
            s.last_value = rec.get("exitcode")
        elif ev == "elastic_giveup":
            self._breach(self._stream(FAILURE_RULE, rec.get("rank")),
                         critical=True)
        else:
            return []
        return self._update_overall(rec)

    def _worst(self) -> Tuple[str, Optional[Tuple[str, Any, _Stream]]]:
        worst_state, worst = OK, None
        for (rule_name, rank), s in self._streams.items():
            if _SEVERITY[s.state] > _SEVERITY[worst_state]:
                worst_state = s.state
                worst = (rule_name, rank, s)
        return worst_state, worst

    def _update_overall(self, rec: Dict[str, Any]
                        ) -> List[Dict[str, Any]]:
        new_state, worst = self._worst()
        if new_state == self.state:
            return []
        if worst is None and self.transitions:
            # a recovery to ok has no firing stream — attribute it to
            # the rule that last degraded the monitor, so the
            # degraded → ok transition still names what recovered
            prev = self.transitions[-1]
            rule_name, rank, stream = prev["rule"], prev["rank"], None
            metric = prev["metric"]
        else:
            rule_name, rank, stream = worst if worst else (None, None,
                                                           None)
            metric = next((r.metric for r in self.rules
                           if r.name == rule_name), rule_name)
        tr = {"from": self.state, "to": new_state,
              "rule": rule_name, "metric": metric, "rank": rank,
              "value": stream.last_value if stream else None,
              "time": rec.get("time")}
        self.state = new_state
        self.transitions.append(tr)
        if self.emit_path:
            try:
                from ..utils.logging import append_event
                append_event("health_transition", path=self.emit_path,
                             **{k: v for k, v in tr.items()
                                if k != "time"})
            except Exception:  # noqa: BLE001 — monitoring must never
                pass           # take down the monitored run
        return [tr]

    # -- verdicts -----------------------------------------------------------

    @property
    def snapshots_seen(self) -> int:
        return self._snapshots_seen

    def stream_states(self) -> List[Dict[str, Any]]:
        """EVERY (rule, rank) stream the monitor has ever tracked, with
        cumulative breach counts — the audit view a harness gates on
        (a recovered stream keeps its history here; :meth:`firing` is
        the live view)."""
        return [{"rule": rn, "rank": rank, "state": s.state,
                 "breaches": s.breaches,
                 "total_breaches": s.total_breaches,
                 "value": s.last_value}
                for (rn, rank), s in self._streams.items()]

    def firing(self) -> List[Dict[str, Any]]:
        """Streams currently not-ok, worst first — the attribution the
        ``critical`` verdict names."""
        rows = [{"rule": rn, "rank": rank, "state": s.state,
                 "breaches": s.breaches, "value": s.last_value}
                for (rn, rank), s in self._streams.items()
                if s.state != OK]
        rows.sort(key=lambda r: -_SEVERITY[r["state"]])
        return rows

    def verdict(self) -> Dict[str, Any]:
        return {"state": self.state,
                "snapshots": self._snapshots_seen,
                "transitions": list(self.transitions),
                "firing": self.firing()}


def scan_records(records: Iterable[Dict[str, Any]],
                 monitor: Optional[HealthMonitor] = None
                 ) -> HealthMonitor:
    """Replay records (time order as given) through a monitor."""
    mon = monitor if monitor is not None else HealthMonitor()
    for rec in records:
        mon.feed(rec)
    return mon


class LogFollower:
    """Incremental line-JSON reader for LIVE evaluation: each
    :meth:`poll` parses the complete lines appended since the last
    call, feeds them to the monitor, and returns the transitions. A
    torn final line (a writer mid-``os.write``) stays buffered until
    its newline arrives — the multi-writer stream is never
    half-parsed."""

    def __init__(self, path: str, monitor: HealthMonitor):
        self.path = path
        self.monitor = monitor
        self._offset = 0
        self._buf = b""

    def poll(self) -> List[Dict[str, Any]]:
        import json
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        self._offset += len(chunk)
        data = self._buf + chunk
        lines = data.split(b"\n")
        self._buf = lines.pop()   # b"" after a complete final line
        out: List[Dict[str, Any]] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue   # damage is the validator's job, not ours
            if isinstance(rec, dict):
                out.extend(self.monitor.feed(rec))
        return out
