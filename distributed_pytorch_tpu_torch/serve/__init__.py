"""Continuous-batching serving of the port: the engine over the
contiguous slot pool or the paged, prefix-shared KV pool (exact or
block-quantized pages), with speculative decoding of greedy requests."""

from .engine import EngineConfig, InferenceEngine
from .metrics import aggregate, percentile, request_record
from .pages import PagedSlotPool, PagePool, PrefixIndex
from .spec import SpecConfig, SpecState, accept_greedy
from .types import (AdmissionRejected, EngineStopped, PagePoolExhausted,
                    RequestDeadlineExceeded, RequestHandle, SamplingParams,
                    ServeError, SpecDecodeError)

__all__ = ["AdmissionRejected", "EngineConfig", "EngineStopped",
           "InferenceEngine", "PagePool", "PagePoolExhausted",
           "PagedSlotPool", "PrefixIndex", "RequestDeadlineExceeded",
           "RequestHandle", "SamplingParams", "ServeError", "SpecConfig",
           "SpecDecodeError", "SpecState", "accept_greedy", "aggregate",
           "percentile", "request_record"]
