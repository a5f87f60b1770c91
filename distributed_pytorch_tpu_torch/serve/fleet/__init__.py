"""serve/fleet: a multi-replica engine fleet behind one front door.

R replica ``InferenceEngine``s (any ``EngineConfig``: contiguous, paged,
quantized pool) sharing one model, behind a :class:`FleetRouter` with
prefix-affine routing, spill on exhaustion and typed replica failure
isolation."""

from .placement import least_loaded, prefix_key, rendezvous, spill_order
from .router import FLEET_OP, FleetRouter
from .types import (REPLICA_DRAINING, REPLICA_FAILED, REPLICA_LIVE,
                    REPLICA_RETIRED, FleetConfig, FleetHandle, Replica,
                    ReplicaFailed)

__all__ = [
    "FleetRouter", "FleetConfig", "FleetHandle", "Replica",
    "ReplicaFailed", "FLEET_OP", "prefix_key", "rendezvous",
    "least_loaded", "spill_order", "REPLICA_LIVE", "REPLICA_DRAINING",
    "REPLICA_FAILED", "REPLICA_RETIRED",
]
