"""The disaggregated serving front door (``serve/disagg/``).

Counterpart of ``distributed_pytorch_tpu/serve/disagg/router.py``.
:class:`DisaggEngine` keeps the engine contract (``submit(prompt,
SamplingParams, generator=...) -> RequestHandle`` with a future,
streaming callbacks and per-request SLO metrics) while prefill and
decode run as separate engines joined by the KV-page handoff:

    submit() -> AdmissionScheduler -> PrefillEngine (radix reuse, tail
    prefill, extract pages, encode frame) -> transport (exact f32 or
    block q8/q4 wire; DPX_HANDOFF_WIDTH) -> DecodeEngine (integrity
    check, adopt pages, sample token 0, decode loop) -> future

The router owns what both engines need one authority for: the admission
queue, the request registry, the handoff-in-flight set (swept by the
decode loop against ``DPX_HANDOFF_TIMEOUT_MS``) and the one completion
path: every retirement and every typed failure goes through
:meth:`finish_ok` / :meth:`fail` under a lock, so a request resolves
once whichever engine saw its fate first.

Failure containment: :meth:`on_prefill_dead` fails only the requests on
the prefill side (queued, mid-prefill, sent but unreceived), each a
typed ``PrefillEngineDied`` blaming ``engine="prefill"``, and refuses
later submissions with ``reason="prefill_dead"``; every decode-resident
stream goes on producing ``generate()``'s tokens.

Observability: every ``log_every`` decode iterations the split's gauges
go through the dpxmon registry into one rank-attributed
``metrics_snapshot`` event of the metrics log; each completion observes
the TTFT / TPOT histograms the health rules read, and at retirement
``emit_request_trace`` writes the request's span tree (queue, prefill,
handoff, decode, stream) under the trace id it got at submit.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...models.generate import _check_attn_compatible, _model_window
from ...obs import metrics as dpxmon
from ...obs import trace as dpxtrace
from ...runtime import env as _env
from ...runtime.device import default_generator
from ...utils.logging import MetricsLogger
from ..engine import _default_buckets
from ..metrics import emit_request_trace, request_record
from ..scheduler import AdmissionScheduler
from ..spec import SpecConfig
from ..types import (FAILED, FINISHED, AdmissionRejected, EngineStopped,
                     HandoffCorrupt, HandoffError, HandoffTimeout,
                     PagePoolExhausted, PrefillEngineDied, Request,
                     RequestDeadlineExceeded, RequestHandle, SamplingParams)
from . import frames
from .decode import DecodeEngine
from .prefill import PrefillEngine
from .transport import LocalTransport


@dataclass
class DisaggConfig:
    """Shape and policy of the split. ``n_slots`` x ``max_len`` budgets
    the decode pool (``EngineConfig``'s meaning); the prefill pool holds
    prompts only (``prefill_pages``, default four max-bucket prompts, so
    the radix index has residency to hit). ``handoff_width`` is the frame
    wire: ``f32`` (exact, the default), ``q8`` or ``q4``. ``kv_dtype`` is
    both pools' resident width; when it equals ``handoff_width`` the
    frame carries the prefill pool's codes and scales as they are.
    ``spec_decode`` speculates on the decode side with ``draft_model``.
    None knobs default from the env registry (``DPX_HANDOFF_WIDTH``,
    ``DPX_HANDOFF_TIMEOUT_MS``, ``DPX_SERVE_PAGE_LEN``,
    ``DPX_SERVE_N_PAGES``, ``DPX_SERVE_PREFIX_SHARE``,
    ``DPX_SERVE_KV_DTYPE``, ``DPX_SPEC_DECODE``, ``DPX_SPEC_DRAFT_LEN``).
    """

    n_slots: int = 4
    max_len: int = 256
    buckets: Optional[Tuple[int, ...]] = None
    max_queue: int = 64
    metrics: Optional[MetricsLogger] = None
    log_every: int = 16
    allow_custom_attn: bool = False
    page_len: Optional[int] = None
    n_pages: Optional[int] = None          # decode pool
    prefill_pages: Optional[int] = None    # prefill pool
    prefix_share: Optional[bool] = None
    handoff_width: Optional[str] = None    # "f32" | "q8" | "q4"
    handoff_timeout_ms: Optional[int] = None
    kv_dtype: Optional[str] = None
    spec_decode: Optional[bool] = None
    draft_model: Any = None
    draft_len: Optional[int] = None


class DisaggEngine:
    """Disaggregated prefill/decode serving of a ``TransformerLM``: the
    drop-in for :class:`~..engine.InferenceEngine` when a long prefill
    must never stall decode cadence. Runs on the model's device.

    >>> eng = DisaggEngine(model, DisaggConfig(n_slots=4))
    >>> eng.start()
    >>> h = eng.submit(prompt_ids, SamplingParams(max_new_tokens=32))
    >>> tokens = h.result(timeout=60)
    >>> eng.shutdown()
    """

    def __init__(self, model, config: Optional[DisaggConfig] = None, *,
                 transport=None):
        self.config = cfg = config or DisaggConfig()
        if cfg.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {cfg.n_slots}")
        _check_attn_compatible(model, cfg.allow_custom_attn)
        if _model_window(model) is not None:
            raise ValueError(
                "disaggregated serving runs on the paged KV cache, which "
                "does not support sliding-window models: use the "
                "monolithic InferenceEngine (its rolling SlotPool already "
                "bounds their memory)")
        if model.pos is not None and cfg.max_len > model.max_seq:
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's max_seq "
                f"({model.max_seq})")
        self.model = model
        self.device = model.device
        self.buckets = tuple(sorted(cfg.buckets)) if cfg.buckets \
            else _default_buckets(cfg.max_len)
        if max(self.buckets) > cfg.max_len:
            raise ValueError(
                f"largest prefill bucket ({max(self.buckets)}) exceeds "
                f"max_len ({cfg.max_len}): the decode pool cannot hold it")
        width = cfg.handoff_width if cfg.handoff_width is not None \
            else _env.get("DPX_HANDOFF_WIDTH")
        self.handoff_width = width
        bits = frames.resolve_handoff_bits(width)
        self.handoff_timeout_ms = (
            cfg.handoff_timeout_ms if cfg.handoff_timeout_ms is not None
            else _env.get("DPX_HANDOFF_TIMEOUT_MS"))
        page_len = (cfg.page_len if cfg.page_len is not None
                    else _env.get("DPX_SERVE_PAGE_LEN"))
        n_pages = (cfg.n_pages if cfg.n_pages is not None
                   else _env.get("DPX_SERVE_N_PAGES"))
        if not n_pages:
            n_pages = cfg.n_slots * (-(-cfg.max_len // page_len))
        share = (cfg.prefix_share if cfg.prefix_share is not None
                 else _env.get("DPX_SERVE_PREFIX_SHARE"))
        prefill_pages = cfg.prefill_pages or \
            4 * (-(-max(self.buckets) // page_len))
        self.metrics = cfg.metrics
        self.scheduler = AdmissionScheduler(cfg.max_queue)
        self.transport = transport if transport is not None \
            else LocalTransport()
        if not getattr(self.transport, "pollable", True):
            # the decode loop drains the transport between tokens with
            # recv(0) polls; a transport whose recv can only block would
            # stall cadence on the channel and read an idle prefill peer
            # as dead
            raise ValueError(
                f"{type(self.transport).__name__} is not pollable: the "
                f"DisaggEngine decode loop needs a non-blocking recv")
        kv_dtype = (cfg.kv_dtype if cfg.kv_dtype is not None
                    else _env.get("DPX_SERVE_KV_DTYPE"))
        self.kv_dtype = kv_dtype
        self.prefill = PrefillEngine(
            model, self, self.transport, buckets=self.buckets,
            page_len=page_len, n_pages=prefill_pages,
            prefix_share=bool(share), bits=bits, kv_dtype=kv_dtype)
        spec_on = (cfg.spec_decode if cfg.spec_decode is not None
                   else _env.get("DPX_SPEC_DECODE"))
        spec = None
        if spec_on:
            if cfg.draft_model is None:
                raise ValueError(
                    "spec_decode=True requires draft_model (DisaggConfig): "
                    "there is nothing to propose with")
            draft_len = (cfg.draft_len if cfg.draft_len is not None
                         else _env.get("DPX_SPEC_DRAFT_LEN"))
            spec = SpecConfig(draft_model=cfg.draft_model,
                              draft_len=int(draft_len))
        self.decode = DecodeEngine(
            model, self, self.transport, n_slots=cfg.n_slots,
            max_len=cfg.max_len, page_len=page_len, n_pages=n_pages,
            kv_dtype=kv_dtype, spec=spec, buckets=self.buckets)
        # per-tenant inflight quota (0 = unlimited), moved under _lock
        # and given back in the one exactly-once completion path
        self._tenant_max = int(_env.get("DPX_SERVE_TENANT_MAX_INFLIGHT"))
        self._tenant_inflight: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._handoff: Dict[int, Request] = {}   # sent, not yet adopted
        self._requests: Dict[int, Request] = {}  # all in flight
        self._next_id = 0
        self._completed = 0
        self._failed = 0
        self._stop = False
        self._started = False
        self._prefill_dead_cause: Optional[Exception] = None
        self._crash: Optional[Exception] = None

    # -- front door --------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               generator: Optional[torch.Generator] = None, on_token=None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Enqueue one request; ``InferenceEngine.submit``'s contract
        (a synchronous typed ``AdmissionRejected`` when it can never be
        served, a bounded queue, the request's own generator, the
        tenant's inflight quota)."""
        sp = params or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            if self._stop:
                # dpxlint: disable=DPX004 pre-admission, no request id assigned yet
                raise EngineStopped("engine is shut down")
            rid = self._next_id
            self._next_id += 1
        self._validate(prompt, sp, rid)
        if generator is None and sp.temperature != 0.0:
            generator = default_generator(self.device, rid)
        now = time.monotonic()
        req = Request(request_id=rid, prompt=prompt, params=sp,
                      generator=generator, submit_t=now,
                      deadline_t=(now + sp.deadline_ms / 1e3
                                  if sp.deadline_ms is not None else None),
                      on_token=on_token, tenant=tenant,
                      stage="prefill_queue",
                      trace_id=dpxtrace.new_trace_id())
        req.handle = RequestHandle(req)
        with self._lock:
            if self._stop:
                raise EngineStopped("engine is shut down", request_id=rid)
            if self._prefill_dead_cause is not None:
                exc = AdmissionRejected(
                    f"request {rid}: the prefill engine is dead; "
                    f"decode-resident streams continue, new admissions "
                    f"are refused", reason="prefill_dead", request_id=rid)
                exc.__cause__ = self._prefill_dead_cause
                raise exc
            if (tenant is not None and self._tenant_max > 0
                    and self._tenant_inflight.get(tenant, 0)
                    >= self._tenant_max):
                dpxmon.inc("serve.rejected")
                dpxmon.inc(f"serve.rejected.tenant.{tenant}")
                raise AdmissionRejected(
                    f"request {rid}: tenant {tenant!r} already has "
                    f"{self._tenant_inflight[tenant]} inflight "
                    f"request(s) (DPX_SERVE_TENANT_MAX_INFLIGHT="
                    f"{self._tenant_max})", reason="tenant_quota",
                    tenant=tenant, request_id=rid)
            self.scheduler.submit(req)   # may raise AdmissionRejected
            self._requests[rid] = req
            if tenant is not None:
                self._tenant_inflight[tenant] = \
                    self._tenant_inflight.get(tenant, 0) + 1
        self.prefill.wake()
        return req.handle

    def _validate(self, prompt, sp: SamplingParams, rid: int) -> None:
        s = int(prompt.shape[0])
        if s < 1 or sp.max_new_tokens < 1:
            raise AdmissionRejected(
                f"request {rid}: empty prompt or max_new_tokens < 1",
                reason="invalid", request_id=rid)
        if s > max(self.buckets):
            raise AdmissionRejected(
                f"request {rid}: prompt length {s} exceeds the largest "
                f"prefill bucket ({max(self.buckets)})",
                reason="prompt_too_long", request_id=rid)
        if s + sp.max_new_tokens > self.config.max_len:
            raise AdmissionRejected(
                f"request {rid}: prompt ({s}) + max_new_tokens "
                f"({sp.max_new_tokens}) exceeds the decode pool "
                f"({self.config.max_len})", reason="too_long",
                request_id=rid)
        L = self.decode.pool.page_len
        worst = -(-(s + sp.max_new_tokens - 1) // L)
        if worst > self.decode.pool.n_pages:
            raise AdmissionRejected(
                f"request {rid}: worst-case page need ({worst}) exceeds "
                f"the decode page pool ({self.decode.pool.n_pages} pages "
                f"of {L})", reason="no_free_pages", request_id=rid)
        need = -(-s // self.prefill.pool.page_len)
        if need > self.prefill.pool.n_pages:
            raise AdmissionRejected(
                f"request {rid}: prompt needs {need} page(s), more than "
                f"the whole prefill pool ({self.prefill.pool.n_pages})",
                reason="no_free_pages", request_id=rid)

    def start(self) -> "DisaggEngine":
        if self._started:
            raise RuntimeError("engine already started")
        self._started = True
        self.decode.start()
        self.prefill.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        """Stop both loops; every request still in flight fails with a
        typed ``EngineStopped``."""
        with self._lock:
            self._stop = True
        self.prefill.stop(wait=wait)
        self.decode.stop(wait=wait)
        self._drain_on_stop()

    def __enter__(self) -> "DisaggEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- the one completion path ------------------------------------------

    def _resolve(self, req: Request) -> bool:
        """Claim the right to resolve ``req`` (once, under the lock);
        False if another path already did."""
        with self._lock:
            if req.done:
                return False
            self._requests.pop(req.request_id, None)
            self._handoff.pop(req.request_id, None)
            if req.tenant is not None:
                n = self._tenant_inflight.get(req.tenant, 0)
                if n <= 1:
                    self._tenant_inflight.pop(req.tenant, None)
                else:
                    self._tenant_inflight[req.tenant] = n - 1
            return True

    def finish_ok(self, req: Request) -> None:
        if not self._resolve(req):
            return
        req.state = FINISHED
        with self._lock:
            self._completed += 1
        rec = request_record(req, "ok")
        req.handle.metrics = rec
        # dpxmon SLO instruments: the monolithic engine's histograms, so
        # the p99-ceiling health rules cover both front doors
        dpxmon.inc("serve.completed")
        for name in ("ttft_ms", "tpot_ms"):
            if rec[name] is not None:
                dpxmon.observe(f"serve.{name}", rec[name])
                if req.tenant is not None:
                    dpxmon.observe(f"serve.{name}.tenant.{req.tenant}",
                                   rec[name])
        if self.metrics is not None:
            self.metrics.event("serve_request", **rec)
        emit_request_trace(req, "ok")
        req.handle.future.set_result(np.asarray(req.out_tokens, np.int32))

    def fail(self, req: Request, exc: Exception, outcome: str) -> None:
        if not self._resolve(req):
            return
        req.state = FAILED
        with self._lock:
            self._failed += 1
        rec = request_record(req, outcome)
        req.handle.metrics = rec
        dpxmon.inc("serve.failed")
        dpxmon.inc(f"serve.outcome.{outcome}")
        if self.metrics is not None:
            self.metrics.event("serve_request", **rec)
        emit_request_trace(req, outcome)
        if isinstance(exc, (HandoffError, PagePoolExhausted)):
            # an infrastructure failure ships the split's recent spans
            # with the typed error (obs/trace.py, best effort)
            dpxtrace.on_typed_failure(exc)
        req.handle.future.set_exception(exc)

    def fail_queued_deadline(self, req: Request) -> None:
        self.fail(req, RequestDeadlineExceeded(
            f"request {req.request_id} missed its deadline "
            f"({req.params.deadline_ms} ms) while queued for prefill",
            deadline_ms=req.params.deadline_ms, stage="queued",
            request_id=req.request_id,
            iteration=self.prefill.iterations),
            outcome="deadline_queued")

    def fail_handoff_corrupt(self, exc: HandoffCorrupt,
                             iteration: int) -> None:
        """Fail a corrupt frame's request when the header named one;
        damage that names none (bad magic, a truncated header) means the
        channel cannot be trusted: prefill-side death, decode residents
        unaffected."""
        req = None
        if exc.request_id is not None:
            with self._lock:
                req = self._requests.get(exc.request_id)
        if req is not None:
            exc.iteration = iteration
            self.fail(req, exc, outcome="handoff_corrupt")
        else:
            self.on_prefill_dead(exc)

    # -- handoff bookkeeping ----------------------------------------------

    def enter_handoff(self, req: Request) -> None:
        with self._lock:
            self._handoff[req.request_id] = req

    def take_handoff(self, request_id: int) -> Optional[Request]:
        with self._lock:
            return self._handoff.pop(request_id, None)

    def handoff_count(self) -> int:
        with self._lock:
            return len(self._handoff)

    def sweep_handoff_timeouts(self, now: float, iteration: int) -> None:
        """Fail (typed ``HandoffTimeout``) every sent frame older than
        ``DPX_HANDOFF_TIMEOUT_MS``; the decode loop calls it every
        iteration, so a wedged prefill side cannot park a request."""
        tmo = self.handoff_timeout_ms
        if not tmo:
            return
        with self._lock:
            late = [r for r in self._handoff.values()
                    if r.handoff_send_t is not None
                    and (now - r.handoff_send_t) * 1e3 >= tmo]
        for req in late:
            self.fail(req, HandoffTimeout(
                f"request {req.request_id}: handoff frame not adopted "
                f"within {tmo} ms of its send",
                deadline_ms=float(tmo), engine="transport",
                request_id=req.request_id, iteration=iteration),
                outcome="handoff_timeout")

    # -- failure domains ---------------------------------------------------

    def on_prefill_dead(self, cause: Exception) -> None:
        """The prefill engine is gone (crash, severed transport). Fail
        only its side of the handoff (queued, mid-prefill, sent but
        unreceived), typed and attributed; refuse new work; leave every
        decode-resident stream running."""
        with self._lock:
            if self._prefill_dead_cause is not None:
                return
            self._prefill_dead_cause = cause
            victims = list(self._handoff.values())
        victims += self.prefill.drain_requests()
        victims += self.scheduler.drain()
        for req in victims:
            exc = PrefillEngineDied(
                f"request {req.request_id} lost in stage {req.stage}: "
                f"the prefill engine died ({cause!r}); decode-resident "
                f"streams continue", request_id=req.request_id,
                engine="prefill", iteration=self.prefill.iterations)
            exc.__cause__ = cause
            self.fail(req, exc, outcome="prefill_died")

    def on_decode_crash(self, cause: Exception) -> None:
        """A decode-loop crash strands every future: fail them all typed
        with the cause chained, then stop serving."""
        self._crash = cause
        with self._lock:
            self._stop = True
        self.prefill.stop(wait=False)
        self.transport.abort()
        self._drain_on_stop()

    def _drain_on_stop(self) -> None:
        cause = f" (engine crashed: {self._crash!r})" \
            if self._crash is not None else ""
        victims = self.scheduler.drain() + self.prefill.drain_requests() \
            + self.decode.drain_requests()
        with self._lock:
            victims += list(self._handoff.values())
        for req in victims:
            exc = EngineStopped(
                f"engine stopped with request {req.request_id} in stage "
                f"{req.stage}{cause}", request_id=req.request_id,
                iteration=self.decode.iterations)
            exc.__cause__ = self._crash
            if req.slot is not None:
                # decode-resident: its pages go back to the pool too
                self.decode.fail_resident(req, exc, outcome="engine_stopped")
            else:
                self.fail(req, exc, outcome="engine_stopped")

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict:
        """Split-aware engine stats: the prefill side decodes nothing
        (``prefill.decode_steps == 0``) and the decode side prefills
        nothing (``decode.prefill_admits == {}``)."""
        sent = self.transport.stats.summary()
        return {
            "completed": self._completed,
            "failed": self._failed,
            "queue_depth": len(self.scheduler),
            "buckets": self.buckets,
            "handoff_width": self.handoff_width,
            "prefill": self.prefill.stats(),
            "decode": self.decode.stats(),
            "handoff": {
                "in_flight": self.handoff_count(),
                "frames_sent": self.transport.frames_sent,
                "frames_recv": self.transport.frames_recv,
                "bytes_sent": int(sent.get("handoff_send", {})
                                  .get("bytes", 0)),
                "bytes_recv": int(sent.get("handoff_recv", {})
                                  .get("bytes", 0)),
            },
        }

    def periodic_metrics(self, iteration: int) -> None:
        """Every ``log_every`` decode iterations, the split's queue,
        occupancy and handoff gauges through the dpxmon registry into
        one rank-attributed ``metrics_snapshot`` event."""
        if self.metrics is None or iteration % self.config.log_every:
            return
        if not dpxmon.enabled():
            return
        d = self.decode.stats()
        ps = d["pages"]
        dpxmon.set_gauge("serve.queue_depth", len(self.scheduler))
        dpxmon.set_gauge("serve.handoff_in_flight", self.handoff_count())
        dpxmon.set_gauge("serve.active_slots", d["active_slots"])
        dpxmon.set_gauge("serve.pending_handoffs", d["pending_handoffs"])
        dpxmon.set_gauge("serve.tokens_emitted", d["tokens_emitted"])
        dpxmon.set_gauge("serve.pool_occupancy", ps["pool_occupancy"])
        dpxmon.set_gauge("serve.kv_bits", ps["kv_bits"])
        dpxmon.set_gauge("serve.kv_pool_bytes", ps["kv_pool_bytes"])
        dpxmon.set_gauge("serve.bytes_per_resident_token",
                         ps["bytes_per_resident_token"])
        dpxmon.set_gauge("serve.handoff_bytes_sent", int(
            self.transport.stats.summary()
            .get("handoff_send", {}).get("bytes", 0)))
        if self.decode.spec_proposed:
            dpxmon.set_gauge("serve.spec_acceptance_rate",
                             self.decode.spec_accepted
                             / self.decode.spec_proposed)
            dpxmon.set_gauge("serve.spec_tokens_per_iteration",
                             self.decode.spec_tokens
                             / max(self.decode.spec_iters, 1))
        dpxmon.emit_snapshot(path=self.metrics.path, step=iteration,
                             source="serve_disagg_engine")
