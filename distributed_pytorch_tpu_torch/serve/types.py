"""Request-level types of the serving engine: sampling parameters, the
request lifecycle and the typed failure vocabulary.

The port's own copy of ``distributed_pytorch_tpu/serve/types.py`` (the
port imports nothing of the JAX package). Every failure is a typed
exception carrying the request id and the engine iteration, so callers
never parse message strings. The handoff errors (``HandoffError`` and
its three kinds) name the side of the disaggregated split they blame
(``serve/disagg/``).
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
    slot cache, the tenant's inflight quota full). Raised synchronously
    from ``submit`` with ``reason`` (and ``tenant`` for
    ``reason="tenant_quota"``)."""

    def __init__(self, msg: str, *, reason: str = "rejected",
                 tenant: Optional[str] = None, **kw):
        super().__init__(msg, **kw)
        self.reason = reason
        self.tenant = tenant


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


class HandoffError(ServeError):
    """A KV-page handoff of disaggregated serving (``serve/disagg/``)
    failed. Base of the handoff vocabulary: carries the request, the
    iteration and ``engine``, the side of the split it blames
    (``"prefill"``, ``"decode"`` or ``"transport"``). A dead prefill
    engine fails only its in-flight requests, typed, while
    decode-resident streams go on producing their tokens."""

    def __init__(self, msg: str, *, engine: str = "transport", **kw):
        super().__init__(msg, **kw)
        self.engine = engine


class PrefillEngineDied(HandoffError):
    """The prefill engine died (crash, severed transport) with this
    request on its side of the handoff: queued for prefill,
    mid-prefill, or sent but never received. Only those requests fail;
    every decode-resident stream continues."""


class HandoffTimeout(HandoffError):
    """A sent handoff frame did not reach the decode pool within
    ``DPX_HANDOFF_TIMEOUT_MS``: the transport or the prefill side is
    wedged but nothing closed. ``deadline_ms`` is the deadline."""

    def __init__(self, msg: str, *, deadline_ms: float = 0.0, **kw):
        super().__init__(msg, **kw)
        self.deadline_ms = deadline_ms


class HandoffCorrupt(HandoffError):
    """A handoff frame failed its integrity check (magic, version,
    geometry or CRC32C). ``page`` names the first page tensor whose
    CRC32C mismatched (-1: the header or the logits section): corrupt
    KV never reaches the decode pool."""

    def __init__(self, msg: str, *, page: int = -1, **kw):
        super().__init__(msg, **kw)
        self.page = page


class SpecDecodeError(ServeError):
    """A speculative-decoding step (``serve/spec/``) failed for this
    request: the draft's proposal loop, the batched verify or the commit
    of the accepted prefix raised. ``stage`` (``"propose"``,
    ``"verify"`` or ``"commit"``) says which. Only the speculating
    requests fail: the verify writes nothing, so co-resident
    non-speculative streams go on unchanged."""

    def __init__(self, msg: str, *, stage: str = "verify", **kw):
        super().__init__(msg, **kw)
        self.stage = stage


class PagePoolExhausted(ServeError):
    """The paged KV pool (``serve/pages/``) could not supply a page:
    the free list is empty and every other page is held by a live reader
    (refcount > 0), so nothing is LRU-evictable. The pool raises it with
    ``needed``/``free_pages``; the engine re-raises it with the victim
    request and iteration attached (a mid-decode growth failure fails
    that request only). At admission the same condition is back-pressure
    instead: the request stays queued while other requests hold pages,
    or fails ``AdmissionRejected(reason="no_free_pages")`` when nothing
    could ever release them."""

    def __init__(self, msg: str, *, needed: int = 0, free_pages: int = 0,
                 **kw):
        super().__init__(msg, **kw)
        self.needed = needed
        self.free_pages = free_pages


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
    # paged KV (serve/pages/): full prefix pages the radix index supplied
    # at admission, and the prefill tokens that reuse saved (0/0 cold or
    # unpaged)
    prefix_hit_pages: int = 0
    prefill_tokens_saved: int = 0
    #: the tenant its quota counts against (None: untenanted)
    tenant: Optional[str] = None
    #: speculative decoding: drafts proposed for it and accepted
    spec_proposed: int = 0
    spec_accepted: int = 0
    retire_iteration: Optional[int] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    # disaggregated serving (serve/disagg/): the frame leaves the prefill
    # engine at handoff_send_t and is taken off the transport by the
    # decode engine at handoff_recv_t; with submit_t, admit_t and
    # first_token_t they split TTFT into queue, prefill, handoff and
    # decode spans (serve/metrics.py). None in the monolithic engine.
    handoff_send_t: Optional[float] = None
    handoff_recv_t: Optional[float] = None
    handoff_bytes: Optional[int] = None
    #: where the disagg router finds it for failure attribution:
    #: "prefill_queue" | "prefill" | "handoff" | "decode"
    stage: Optional[str] = None

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
