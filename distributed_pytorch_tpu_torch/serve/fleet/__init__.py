"""serve/fleet: a multi-replica engine fleet behind one front door.

R replica ``InferenceEngine``s (any ``EngineConfig``: contiguous, paged,
quantized pool) sharing one model, behind a :class:`FleetRouter` with
prefix-affine routing, spill on exhaustion, typed replica failure
isolation and SLO-driven elasticity (:class:`FleetAutoscaler`)."""

from .autoscale import (DEFAULT_FLEET_RULES, AutoscaleConfig,
                        FleetAutoscaler)
from .placement import least_loaded, prefix_key, rendezvous, spill_order
from .router import FLEET_OP, FleetRouter
from .types import (REPLICA_DRAINING, REPLICA_FAILED, REPLICA_LIVE,
                    REPLICA_RETIRED, FleetConfig, FleetHandle, Replica,
                    ReplicaFailed)

__all__ = [
    "FleetRouter", "FleetConfig", "FleetHandle", "Replica",
    "ReplicaFailed", "FleetAutoscaler", "AutoscaleConfig",
    "DEFAULT_FLEET_RULES", "FLEET_OP", "prefix_key", "rendezvous",
    "least_loaded", "spill_order", "REPLICA_LIVE", "REPLICA_DRAINING",
    "REPLICA_FAILED", "REPLICA_RETIRED",
]
