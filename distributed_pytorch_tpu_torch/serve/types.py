"""Request-level types of the serving engine: sampling parameters, the
request lifecycle and the typed failure vocabulary.

The port's own copy of ``distributed_pytorch_tpu/serve/types.py`` (the
port imports nothing of the JAX package). Every failure is a typed
exception carrying the request id and the engine iteration, so callers
never parse message strings. Handoff, speculative-decoding and page
errors wait for the slices that bring those features.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs with the semantics of
    ``models.generate.make_generate_fn`` (temperature 0 is greedy).
    ``eos_token`` stops generation early (included in the output);
    ``deadline_ms`` is a wall-clock SLO from submit, enforced while
    queued and while decoding; lower ``priority`` runs sooner (FCFS
    within a priority class)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    deadline_ms: Optional[float] = None
    priority: int = 0


class ServeError(RuntimeError):
    """A serving-engine failure: carries the request id and the engine
    iteration at which it was observed."""

    def __init__(self, msg: str, *, request_id: Optional[int] = None,
                 iteration: Optional[int] = None):
        super().__init__(msg)
        self.request_id = request_id
        self.iteration = iteration


class AdmissionRejected(ServeError):
    """The front door refused the request outright (bounded queue full,
    prompt longer than the largest bucket, prompt + max_new beyond the
    slot cache). Raised synchronously from ``submit`` with ``reason``."""

    def __init__(self, msg: str, *, reason: str = "rejected", **kw):
        super().__init__(msg, **kw)
        self.reason = reason


class RequestDeadlineExceeded(ServeError):
    """The request's ``deadline_ms`` elapsed before completion, while
    queued (``stage='queued'``) or mid-decode (``stage='running'``)."""

    def __init__(self, msg: str, *, deadline_ms: float = 0.0,
                 stage: str = "running", **kw):
        super().__init__(msg, **kw)
        self.deadline_ms = deadline_ms
        self.stage = stage


class EngineStopped(ServeError):
    """The engine shut down while the request was still in flight."""


#: Request lifecycle states (host-side bookkeeping only).
QUEUED, RUNNING, FINISHED, FAILED = "queued", "running", "finished", "failed"


@dataclass
class Request:
    """One in-flight generation request (engine-internal)."""

    request_id: int
    prompt: Any                      # np.ndarray (S,) int32
    params: SamplingParams
    generator: Any                   # torch.Generator of the sampler
    submit_t: float                  # monotonic
    deadline_t: Optional[float]      # monotonic, or None
    on_token: Optional[Callable[[int, int], None]] = None
    handle: Any = None               # RequestHandle (set by the engine)
    state: str = QUEUED
    slot: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    admit_t: Optional[float] = None
    admit_iteration: Optional[int] = None
    retire_iteration: Optional[int] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, FAILED)


class RequestHandle:
    """The caller's view of a submitted request: a future for the final
    token array, the streamed tokens so far, and (after completion) the
    per-request SLO metrics."""

    def __init__(self, request: Request):
        self._request = request
        self.future: Future = Future()
        # the one token list, shared with the engine-side Request
        self.tokens: List[int] = request.out_tokens
        self.metrics: dict = {}

    @property
    def request_id(self) -> int:
        return self._request.request_id

    @property
    def state(self) -> str:
        return self._request.state

    def result(self, timeout: Optional[float] = None):
        """Block for the final (n_tokens,) int32 array; raises the
        request's typed ``ServeError`` on failure."""
        return self.future.result(timeout)
