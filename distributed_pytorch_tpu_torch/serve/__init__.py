"""Continuous-batching serving of the port: the engine over the
contiguous slot pool or the paged, prefix-shared KV pool."""

from .engine import EngineConfig, InferenceEngine
from .metrics import aggregate, percentile, request_record
from .pages import PagedSlotPool, PagePool, PrefixIndex
from .types import (AdmissionRejected, EngineStopped, PagePoolExhausted,
                    RequestDeadlineExceeded, RequestHandle, SamplingParams,
                    ServeError)

__all__ = ["AdmissionRejected", "EngineConfig", "EngineStopped",
           "InferenceEngine", "PagePool", "PagePoolExhausted",
           "PagedSlotPool", "PrefixIndex", "RequestDeadlineExceeded",
           "RequestHandle", "SamplingParams", "ServeError", "aggregate",
           "percentile", "request_record"]
