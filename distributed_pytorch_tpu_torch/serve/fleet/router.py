"""The fleet router: R replica engines behind one front door.

Counterpart of ``distributed_pytorch_tpu/serve/fleet/router.py``.
``FleetRouter`` keeps the engine contract (``submit() -> future +
streamed tokens``) over R :class:`~..engine.InferenceEngine` replicas
sharing one model (one ``nn.Module``, one copy of the weights on the
card). Routing is prefix-affine (``placement.py``): the prompt's
first-page chunk rendezvous-hashes to a home replica, so shared prefixes
land where their pages already live. Back-pressure (a ``queue_full`` /
``no_free_pages`` rejection, or a home queue already at
``DPX_FLEET_SPILL_QUEUE``) spills the request to the least-loaded
replica, a logged ``fleet_spill`` event. When every replica rejects,
the caller gets ``AdmissionRejected(reason="fleet_exhausted")`` with the
last rejection chained; a rejection every replica would make (an
invalid request) is raised at once, without walking the fleet.

Failure isolation: :meth:`kill_replica` (the in-process analogue of a
replica's host dying) fails only that replica's in-flight requests, each
a typed ``ReplicaFailed`` naming it; placement re-homes its prefix shard
over the survivors at once. :meth:`drain_replica` is the graceful
opposite: stop admitting, finish what is in flight, release the pages.

Determinism survives routing: a sampled request without a generator gets
one seeded with its fleet-level id, so its stream is ``generate()``'s
whichever replica, and engine-local id, serves it.

Fleet events go to the metrics log through ``utils.logging.append_event``
with the JAX package's names and fields (``fleet_route``, ``fleet_spill``,
``replica_failed``, ``replica_drained``, ``fleet_scale``), and the
fleet's gauges as a ``metrics_snapshot`` event. Not ported yet: the
``faults.on_comm_op(FLEET_OP)`` hook of ``submit`` and the
``FleetAutoscaler`` (ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...runtime import env as _env
from ...runtime.device import default_generator
from ...utils.logging import append_event
from ..engine import EngineConfig, InferenceEngine
from ..types import AdmissionRejected, EngineStopped, SamplingParams
from . import placement
from .types import (REPLICA_DRAINING, REPLICA_FAILED, REPLICA_LIVE,
                    REPLICA_RETIRED, FleetConfig, FleetHandle, Replica,
                    ReplicaFailed)

#: The op name of routed submits in the fault-injection grammar (the
#: hook itself comes with the port's ``runtime/faults.py``).
FLEET_OP = "fleet_submit"

#: Rejection reasons that mean capacity (spillable) rather than an
#: invalid request (a too-long prompt is rejected alike by every replica).
_SPILL_REASONS = ("queue_full", "no_free_pages")


class FleetRouter:
    """Multi-replica serving front door.

    >>> fleet = FleetRouter(model, FleetConfig(n_replicas=2))
    >>> fleet.start()
    >>> h = fleet.submit(prompt_ids, SamplingParams(max_new_tokens=32))
    >>> tokens = h.result(timeout=60)
    >>> fleet.shutdown()
    """

    def __init__(self, model, config: Optional[FleetConfig] = None):
        self.config = cfg = config or FleetConfig()
        self.model = model
        self._engine_cfg = cfg.engine or EngineConfig()
        n = (cfg.n_replicas if cfg.n_replicas is not None
             else _env.get("DPX_FLEET_REPLICAS"))
        if n < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n}")
        self._spill_queue = (cfg.spill_queue if cfg.spill_queue is not None
                             else _env.get("DPX_FLEET_SPILL_QUEUE"))
        self.metrics = cfg.metrics or self._engine_cfg.metrics
        # the placement chunk is the replicas' prefix-index chunk, so
        # fleet affinity and in-replica page sharing agree
        self._page_len = (self._engine_cfg.page_len
                          if self._engine_cfg.page_len is not None
                          else _env.get("DPX_SERVE_PAGE_LEN"))
        self._lock = threading.RLock()
        self._replicas: Dict[int, Replica] = {}
        self._next_rid = 0
        self._next_fid = 0
        self._routes = 0
        self._affinity_hits = 0
        self._spills = 0
        self._started = False
        for _ in range(n):
            self._build_replica()

    # -- lifecycle ----------------------------------------------------------

    def _build_replica(self) -> Replica:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            eng = InferenceEngine(self.model, self._engine_cfg)
            rep = Replica(rid=rid, engine=eng)
            self._replicas[rid] = rep
            if self._started:
                eng.start()
        return rep

    def start(self) -> "FleetRouter":
        with self._lock:
            if self._started:
                raise RuntimeError("fleet already started")
            self._started = True
            for rep in self._replicas.values():
                if rep.state == REPLICA_LIVE:
                    rep.engine.start()
        return self

    def shutdown(self) -> None:
        """Orderly stop: every live or draining replica shuts down (its
        in-flight requests fail ``EngineStopped``, not ``ReplicaFailed``:
        the caller asked for this)."""
        with self._lock:
            reps = list(self._replicas.values())
            self._started = False
        for rep in reps:
            if rep.state in (REPLICA_LIVE, REPLICA_DRAINING):
                rep.engine.shutdown(wait=True)
                rep.state = REPLICA_RETIRED

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- placement views ----------------------------------------------------

    def _admitting(self) -> List[int]:
        with self._lock:
            return [r.rid for r in self._replicas.values()
                    if r.state == REPLICA_LIVE]

    def _loads(self, rids: List[int]) -> Dict[int, tuple]:
        out = {}
        for rid in rids:
            rep = self._replicas.get(rid)
            if rep is None:
                continue
            st = rep.engine.stats()
            out[rid] = (st["queue_depth"], self._occupancy(st))
        return out

    @staticmethod
    def _occupancy(st: Dict) -> float:
        """A replica's occupancy from its engine's stats: pool pages in
        use when paged, slots in use otherwise."""
        return (st["pages"]["pool_occupancy"] if st["paged"]
                else st["active_slots"] / max(st["n_slots"], 1))

    def home_of(self, prompt) -> Optional[int]:
        """The current home replica of a prompt (None when nothing
        admits); a drain or failure re-homes the shard at the next call."""
        key = placement.prefix_key(
            np.asarray(prompt, np.int32).reshape(-1), self._page_len)
        admitting = self._admitting()
        return placement.rendezvous(key, admitting) if admitting else None

    # -- front door ---------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               generator: Optional[torch.Generator] = None, on_token=None,
               tenant: Optional[str] = None) -> FleetHandle:
        """Route one request; returns a :class:`FleetHandle` at once (the
        engine's streaming contract; ``tenant`` goes to the replica's
        inflight quota). Raises ``AdmissionRejected`` synchronously, with
        ``reason="fleet_exhausted"`` when every replica refused."""
        sp = params or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            fid = self._next_fid
            self._next_fid += 1
        key = placement.prefix_key(prompt, self._page_len)
        admitting = self._admitting()
        if not admitting:
            raise AdmissionRejected(
                f"fleet request {fid}: no live replica admits traffic",
                reason="fleet_exhausted", request_id=fid)
        home = placement.rendezvous(key, admitting)
        if generator is None and sp.temperature != 0.0:
            # the engine would seed with its own request id, which
            # depends on the replica: seed with the fleet id instead
            generator = default_generator(self.model.device, fid)
        order = placement.spill_order(key, home, self._loads(admitting),
                                      self._spill_queue)
        last_reject: Optional[Exception] = None
        for rid in order:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != REPLICA_LIVE:
                continue
            try:
                inner = rep.engine.submit(prompt, sp, generator=generator,
                                          on_token=on_token, tenant=tenant)
            except AdmissionRejected as e:
                if e.reason in _SPILL_REASONS:
                    last_reject = e       # capacity: walk the fleet
                    continue
                raise                     # invalid everywhere: no walk
            except EngineStopped as e:
                last_reject = e           # died between the checks
                continue
            return self._routed(fid, home, rid, rep, inner)
        exc = AdmissionRejected(
            f"fleet request {fid}: every live replica "
            f"({len(admitting)}) rejected admission, fleet exhausted",
            reason="fleet_exhausted", request_id=fid)
        exc.__cause__ = last_reject
        raise exc

    def _routed(self, fid: int, home: int, rid: int, rep: Replica,
                inner) -> FleetHandle:
        spilled = rid != home
        with self._lock:
            self._routes += 1
            routes = self._routes
            if spilled:
                self._spills += 1
            else:
                self._affinity_hits += 1
        if spilled:
            append_event("fleet_spill", path=self._path(),
                         request_id=fid, from_replica=home,
                         to_replica=rid,
                         engine_request_id=inner.request_id)
        append_event("fleet_route", path=self._path(), request_id=fid,
                     replica=rid, home=home, spilled=spilled,
                     engine_request_id=inner.request_id)
        if routes % max(self.config.log_every, 1) == 0:
            self.emit_snapshot(step=routes)
        return FleetHandle(fid, rep, inner)

    # -- failure and elasticity ---------------------------------------------

    def kill_replica(self, rid: int, *, reason: str = "killed") -> None:
        """Hard-kill one replica in-process (the analogue of its host
        dying, through the engine's ``crash``): its in-flight requests
        fail typed ``ReplicaFailed``, its prefix shard re-homes over the
        survivors at the next ``submit``, and a ``replica_failed`` event
        is logged. Idempotent."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state in (REPLICA_FAILED,
                                            REPLICA_RETIRED):
                return
            rep.state = REPLICA_FAILED
        st = rep.engine.stats()
        inflight = st["queue_depth"] + st["active_slots"]
        rep.engine.crash(
            ReplicaFailed(f"replica {rid} {reason}", replica=rid))
        append_event("replica_failed", path=self._path(), rank=rid,
                     replica=rid, reason=reason, inflight=inflight)
        self.emit_snapshot()

    def drain_replica(self, rid: int, *, timeout_s: float = 120.0,
                      rule: str = "", reason: str = "drain") -> bool:
        """Graceful retire: stop admitting (placement re-homes the shard
        now), let the engine finish every in-flight request, then shut
        it down and release its pages. Returns False (the replica back to
        live) if the work outlasts ``timeout_s``; refuses to drain the
        last live replica."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != REPLICA_LIVE:
                return False
            if len(self._admitting()) <= 1:
                raise ValueError(
                    f"cannot drain replica {rid}: it is the last live "
                    f"replica (the fleet would admit nothing)")
            rep.state = REPLICA_DRAINING
        eng = rep.engine
        deadline = time.monotonic() + timeout_s
        drained = False
        while time.monotonic() < deadline:
            st = eng.stats()
            if st["queue_depth"] == 0 and st["active_slots"] == 0:
                drained = True
                break
            time.sleep(0.01)
        if not drained:
            with self._lock:
                rep.state = REPLICA_LIVE     # drain aborted, not killed
            return False
        eng.shutdown(wait=True)
        with self._lock:
            rep.state = REPLICA_RETIRED
        append_event("replica_drained", path=self._path(), rank=rid,
                     replica=rid, rule=rule, reason=reason,
                     completed=st["completed"])
        append_event("fleet_scale", path=self._path(), action="drain",
                     rank=rid, replica=rid, rule=rule, reason=reason,
                     replicas=len(self._admitting()))
        self.emit_snapshot()
        return True

    def add_replica(self, *, rule: str = "",
                    reason: str = "scale_out") -> int:
        """Scale out by one replica (a fresh engine over the shared
        model, started if the fleet is); logs a ``fleet_scale`` event."""
        rep = self._build_replica()
        append_event("fleet_scale", path=self._path(), action="add",
                     rank=rep.rid, replica=rep.rid, rule=rule,
                     reason=reason, replicas=len(self._admitting()))
        self.emit_snapshot()
        return rep.rid

    def revive_replica(self, rid: int, *, backoff_s: float = 0.0) -> int:
        """Relaunch a failed replica under the same id, with an attempt
        count and a doubling backoff between attempts."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != REPLICA_FAILED:
                raise ValueError(
                    f"replica {rid} is not failed: revive relaunches "
                    f"failed replicas only (add_replica scales out)")
            rep.attempt += 1
            attempt = rep.attempt
        if backoff_s > 0:
            time.sleep(min(backoff_s * (2 ** (attempt - 1)), 30.0))
        eng = InferenceEngine(self.model, self._engine_cfg)
        with self._lock:
            rep.engine = eng
            rep.state = REPLICA_LIVE
            if self._started:
                eng.start()
        append_event("fleet_scale", path=self._path(), action="revive",
                     rank=rid, replica=rid, attempt=attempt,
                     reason="relaunch", replicas=len(self._admitting()))
        self.emit_snapshot()
        return rid

    # -- observability ------------------------------------------------------

    def _path(self) -> Optional[str]:
        return self.metrics.path if self.metrics is not None else None

    def stats(self) -> Dict:
        with self._lock:
            reps = list(self._replicas.values())
            routes, hits, spills = (self._routes, self._affinity_hits,
                                    self._spills)
        per = {}
        completed = failed = 0
        for rep in reps:
            st = rep.engine.stats()
            per[rep.rid] = {"state": rep.state, "attempt": rep.attempt,
                            "queue_depth": st["queue_depth"],
                            "active_slots": st["active_slots"],
                            "completed": st["completed"],
                            "failed": st["failed"]}
            completed += st["completed"]
            failed += st["failed"]
        return {"replicas": per,
                "live": sum(1 for r in reps if r.state == REPLICA_LIVE),
                "routes": routes, "spills": spills,
                "affinity_hits": hits,
                "route_affinity_hit_rate": (hits / routes) if routes
                else None,
                "completed": completed, "failed": failed}

    def snapshot_metrics(self) -> Dict[str, float]:
        """The fleet's gauges and each replica's queue depth and
        occupancy (the JAX router's dpxmon provider)."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in (REPLICA_LIVE, REPLICA_DRAINING)]
            routes, hits = self._routes, self._affinity_hits
        out: Dict[str, float] = {
            "fleet.replicas": float(sum(1 for r in reps
                                        if r.state == REPLICA_LIVE)),
            "fleet.route_affinity_hit_rate":
                (hits / routes) if routes else 0.0,
        }
        depths = []
        for rep in reps:
            st = rep.engine.stats()
            out[f"fleet.r{rep.rid}.queue_depth"] = float(st["queue_depth"])
            out[f"fleet.r{rep.rid}.pool_occupancy"] = float(
                self._occupancy(st))
            depths.append(st["queue_depth"])
        out["fleet.max_queue_depth"] = float(max(depths, default=0))
        return out

    def emit_snapshot(self, step: Optional[int] = None) -> None:
        """One ``metrics_snapshot`` event of the fleet (its gauges and the
        current admitting set as ``replicas``), when a metrics log is
        configured."""
        if self._path() is None:
            return
        append_event("metrics_snapshot", path=self._path(),
                     source="serve_fleet",
                     step=step if step is not None else self._routes,
                     replicas=self._admitting(),
                     metrics=self.snapshot_metrics())
