"""Fleet-level types: the fleet configuration, the replica lifecycle,
the typed replica failure and the caller's fleet request handle.

Counterpart of ``distributed_pytorch_tpu/serve/fleet/types.py``. The
fleet keeps the engine contract (``submit() -> future + streamed
tokens``) and adds one failure: a replica can die with requests in
flight. That failure is typed and attributed (:class:`ReplicaFailed`
carries ``replica``), so a supervisor knows which replica to relaunch
and that no other replica's streams were touched.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

from ..engine import EngineConfig
from ..types import EngineStopped, ServeError

#: Replica lifecycle states. ``live`` admits traffic; ``draining``
#: finishes its in-flight requests but admits nothing new (placement
#: leaves it out, re-homing its prefix shard); ``failed`` died with
#: requests in flight (revivable under the same id); ``retired`` drained
#: cleanly and released its pages.
REPLICA_LIVE = "live"
REPLICA_DRAINING = "draining"
REPLICA_FAILED = "failed"
REPLICA_RETIRED = "retired"


class ReplicaFailed(ServeError):
    """A fleet replica died (crash, kill) with this request in flight on
    it. ``replica`` is the failed replica's id: only that replica's
    in-flight requests raise this, streams on other replicas complete
    unchanged. The engine's ``EngineStopped`` is chained as
    ``__cause__``."""

    def __init__(self, msg: str, *, replica: int = -1, **kw):
        super().__init__(msg, **kw)
        self.replica = replica


@dataclass
class FleetConfig:
    """Fleet shape and routing policy; None knobs default from the env
    registry (``DPX_FLEET_REPLICAS``, ``DPX_FLEET_SPILL_QUEUE``).

    ``engine`` is every replica's :class:`~..engine.EngineConfig`, used
    as it is. ``spill_queue`` is the home replica's queue depth at which
    a request spills to the least-loaded replica instead of queueing
    behind that back-pressure (a ``queue_full`` / ``no_free_pages``
    rejection spills regardless)."""

    n_replicas: Optional[int] = None     # DPX_FLEET_REPLICAS
    engine: Optional[EngineConfig] = None
    spill_queue: Optional[int] = None    # DPX_FLEET_SPILL_QUEUE
    metrics: Optional[object] = None     # MetricsLogger of fleet events
    log_every: int = 8                   # routes between snapshots


@dataclass
class Replica:
    """One replica: a stable integer id (the ``rank`` of its fleet
    events, kept across relaunches), the engine serving it, its state and
    its relaunch count."""

    rid: int
    engine: object                       # InferenceEngine
    state: str = REPLICA_LIVE
    attempt: int = 0


class FleetHandle:
    """The caller's view of a fleet request: the engine ``RequestHandle``
    contract (a future for the token array, the streamed ``tokens``, the
    completion metrics) plus ``replica``, the replica that served it.

    Failure translation happens here, once: the engine future resolves
    once and its done-callback resolves this one. An ``EngineStopped``
    from a replica the router marked failed becomes a
    :class:`ReplicaFailed` (cause chained); one from an orderly fleet
    shutdown passes through (there is no replica to blame)."""

    def __init__(self, request_id: int, replica: Replica, inner):
        self.request_id = request_id      # fleet-level id
        self.replica = replica.rid
        self._replica = replica
        self.inner = inner                # engine RequestHandle
        self.tokens = inner.tokens
        self.future: Future = Future()
        inner.future.add_done_callback(self._resolve)

    @property
    def state(self) -> str:
        return self.inner.state

    @property
    def metrics(self) -> dict:
        return self.inner.metrics

    def _resolve(self, fut: Future) -> None:
        exc = fut.exception()
        if exc is None:
            self.future.set_result(fut.result())
            return
        if (isinstance(exc, EngineStopped)
                and self._replica.state == REPLICA_FAILED):
            typed = ReplicaFailed(
                f"replica {self.replica} failed with request "
                f"{self.request_id} in flight "
                f"({len(self.tokens)} token(s) streamed)",
                replica=self.replica, request_id=self.request_id,
                iteration=exc.iteration)
            typed.__cause__ = exc
            exc = typed
        self.future.set_exception(exc)

    def result(self, timeout: Optional[float] = None):
        """Block for the final (n_tokens,) int32 array; raises the typed
        ``ServeError``, :class:`ReplicaFailed` when the serving replica
        died mid-flight."""
        return self.future.result(timeout)
