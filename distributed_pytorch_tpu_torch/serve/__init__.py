"""Continuous-batching serving of the port (non-paged engine)."""

from .engine import EngineConfig, InferenceEngine
from .metrics import aggregate, percentile, request_record
from .types import (AdmissionRejected, EngineStopped,
                    RequestDeadlineExceeded, RequestHandle, SamplingParams,
                    ServeError)

__all__ = ["AdmissionRejected", "EngineConfig", "EngineStopped",
           "InferenceEngine", "RequestDeadlineExceeded", "RequestHandle",
           "SamplingParams", "ServeError", "aggregate", "percentile",
           "request_record"]
