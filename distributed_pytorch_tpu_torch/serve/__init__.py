"""Continuous-batching serving of the port: the engine over the
contiguous slot pool or the paged, prefix-shared KV pool (exact or
block-quantized pages), with speculative decoding of greedy requests;
disaggregated prefill/decode serving joined by a KV-page handoff
(``disagg``); and a multi-replica fleet behind one front door
(``fleet``)."""

from .disagg import DisaggConfig, DisaggEngine
from .engine import EngineConfig, InferenceEngine
from .fleet import FleetConfig, FleetHandle, FleetRouter, ReplicaFailed
from .metrics import aggregate, percentile, request_record
from .pages import PagedSlotPool, PagePool, PrefixIndex
from .spec import SpecConfig, SpecState, accept_greedy
from .types import (AdmissionRejected, EngineStopped, HandoffCorrupt,
                    HandoffError, HandoffTimeout, PagePoolExhausted,
                    PrefillEngineDied, RequestDeadlineExceeded,
                    RequestHandle, SamplingParams, ServeError,
                    SpecDecodeError)

__all__ = ["AdmissionRejected", "DisaggConfig", "DisaggEngine",
           "EngineConfig", "EngineStopped", "FleetConfig", "FleetHandle",
           "FleetRouter", "HandoffCorrupt", "HandoffError",
           "HandoffTimeout", "InferenceEngine", "PagePool",
           "PagePoolExhausted", "PagedSlotPool", "PrefillEngineDied",
           "PrefixIndex", "ReplicaFailed", "RequestDeadlineExceeded",
           "RequestHandle", "SamplingParams", "ServeError", "SpecConfig",
           "SpecDecodeError", "SpecState", "accept_greedy", "aggregate",
           "percentile", "request_record"]
