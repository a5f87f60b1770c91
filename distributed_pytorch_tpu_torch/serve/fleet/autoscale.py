"""SLO-driven fleet elasticity.

Counterpart of ``distributed_pytorch_tpu/serve/fleet/autoscale.py``. The
autoscaler owns an ``obs/health.py`` :class:`HealthMonitor` over TTFT /
queue-depth rules (``DPX_FLEET_SCALE_RULES`` speaks the dpxmon rule
grammar) and turns its verdict into fleet actions:

- a degraded or critical verdict ADDS a replica (up to
  ``DPX_FLEET_MAX_REPLICAS``), attributed to the firing rule;
- ``DPX_FLEET_DRAIN_AFTER_OK`` consecutive ok evaluations DRAIN the
  youngest replica (down to ``DPX_FLEET_MIN_REPLICAS``): drain, never
  kill, so the router finishes that replica's streams first.

Every decision is a replica-attributed ``fleet_scale`` event, written
by the router's add / drain paths. :meth:`FleetAutoscaler.step` is a
synchronous evaluate-and-act tick: the serving harness calls it on its
own cadence, tests drive it with injected metrics, and nothing here
owns a thread.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ...obs import health as dpxhealth
from ...obs import metrics as dpxmon
from ...runtime import env as dpxenv
from .router import FleetRouter

#: Default scale rules: the serve TTFT p99 ceiling (generous: a CPU
#: host must pass it) and the fleet's worst per-replica queue depth. Both
#: metrics are in every fleet snapshot, so the rules evaluate without
#: extra plumbing.
DEFAULT_FLEET_RULES = ("serve.ttft_ms.p99<=30000;"
                       "fleet.max_queue_depth<=16")


@dataclass
class AutoscaleConfig:
    """Elasticity bounds and policy; ``None`` knobs default from the
    typed env registry (``DPX_FLEET_*``, runtime/env.py)."""

    min_replicas: Optional[int] = None   # DPX_FLEET_MIN_REPLICAS
    max_replicas: Optional[int] = None   # DPX_FLEET_MAX_REPLICAS
    rules: Optional[str] = None          # DPX_FLEET_SCALE_RULES
    drain_after_ok: Optional[int] = None  # DPX_FLEET_DRAIN_AFTER_OK
    degrade_after: int = 1
    recover_after: int = 2


class FleetAutoscaler:
    """SLO verdict -> replica count, with hysteresis on both edges
    (the monitor's recover_after on the way down to ok; the ok-streak
    requirement before a drain)."""

    def __init__(self, router: FleetRouter,
                 config: Optional[AutoscaleConfig] = None):
        self.router = router
        self.config = cfg = config or AutoscaleConfig()
        self.min_replicas = (cfg.min_replicas
                             if cfg.min_replicas is not None
                             else dpxenv.get("DPX_FLEET_MIN_REPLICAS"))
        self.max_replicas = (cfg.max_replicas
                             if cfg.max_replicas is not None
                             else dpxenv.get("DPX_FLEET_MAX_REPLICAS"))
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"bad elasticity bounds: 1 <= min ({self.min_replicas})"
                f" <= max ({self.max_replicas}) required")
        self.rules_spec = (cfg.rules if cfg.rules is not None
                           else (dpxenv.get("DPX_FLEET_SCALE_RULES")
                                 or DEFAULT_FLEET_RULES))
        self.drain_after_ok = (cfg.drain_after_ok
                               if cfg.drain_after_ok is not None
                               else dpxenv.get("DPX_FLEET_DRAIN_AFTER_OK"))
        self.monitor = dpxhealth.HealthMonitor(
            dpxhealth.parse_rules(self.rules_spec),
            degrade_after=cfg.degrade_after,
            recover_after=cfg.recover_after)
        self._ok_streak = 0
        self.decisions: List[Dict[str, Any]] = []

    def step(self, metrics: Optional[Dict[str, Any]] = None
             ) -> Optional[Dict[str, Any]]:
        """One evaluate-and-act tick: feed the current registry
        snapshot (or ``metrics``, for tests and offline replay) to the
        monitor, then scale on the verdict. Returns the decision dict
        (action/replica/rule/state) or None when nothing changed."""
        snap = metrics if metrics is not None else dpxmon.snapshot()
        self.monitor.feed({"event": "metrics_snapshot", "rank": 0,
                           "metrics": snap,
                           "replicas": self.router._admitting()})
        state = self.monitor.state
        live = len(self.router._admitting())
        decision: Optional[Dict[str, Any]] = None
        if state != dpxhealth.OK:
            self._ok_streak = 0
            if live < self.max_replicas:
                firing = self.monitor.firing()
                rule = firing[0]["rule"] if firing else ""
                rid = self.router.add_replica(rule=rule,
                                              reason="slo_degraded")
                decision = {"action": "add", "replica": rid,
                            "rule": rule, "state": state}
        else:
            self._ok_streak += 1
            if (self._ok_streak >= self.drain_after_ok
                    and live > self.min_replicas):
                rid = max(self.router._admitting())   # youngest first
                if self.router.drain_replica(rid, rule="sustained_ok",
                                             reason="scale_in"):
                    decision = {"action": "drain", "replica": rid,
                                "rule": "sustained_ok", "state": state}
                    self._ok_streak = 0
        if decision is not None:
            self.decisions.append(decision)
        return decision
