"""The continuous-batching inference engine (iteration-level scheduling
over a shared decode batch), non-paged.

Counterpart of ``distributed_pytorch_tpu/serve/engine.py``. One engine
thread runs the loop; each iteration

1. sweeps deadlines (queued and running requests; a miss fails that
   request with a typed ``RequestDeadlineExceeded``),
2. admits queued requests into free slots (prefill right-padded to a
   power-of-two bucket; at or above ``DPX_FLASH_MIN_SEQ`` keys a flash
   ``attn_fn`` runs the CUDA kernel), and
3. advances every active slot one token through the slot pool's batched
   decode, retiring slots that hit ``max_new_tokens`` / ``eos_token``.

Determinism contract: a request's stream equals a standalone
``models.generate.generate`` call on the same prompt with a generator in
the same state (the engine draws its sampling noise from the request's
own ``torch.Generator``, one draw per token, as ``generate`` does).

``EngineConfig(paged=True)`` serves from the paged, prefix-shared KV
pool (``serve/pages/``): identical prompt prefixes are computed once,
pool exhaustion is typed back-pressure at admission and a typed
per-request failure mid-decode, and the pool's page stats go into
``stats()`` and the metrics log. ``kv_dtype="q8"|"q4"`` keeps that pool
block-quantized.

``EngineConfig(spec_decode=True, draft_model=...)`` decodes greedy
requests speculatively (``serve/spec/``): the draft proposes
``draft_len`` tokens, one batched verify scores them, and only accepted
tokens are committed, so the stream is the target's own; sampled
requests share the batch non-speculatively. ``submit(tenant=)`` counts
a request against its tenant's inflight quota
(``DPX_SERVE_TENANT_MAX_INFLIGHT``).

Left for later slices: the fault-injection hooks and trace spans.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generate import _check_attn_compatible, _model_window, _sample
from ..runtime import env as _env
from ..runtime.device import default_generator
from ..utils.logging import MetricsLogger
from .cache import SlotPool
from .metrics import request_record
from .pages import PagedSlotPool
from .scheduler import AdmissionScheduler
from .spec import SpecConfig, SpecState, accept_greedy
from .types import (FAILED, FINISHED, QUEUED, RUNNING, AdmissionRejected,
                    EngineStopped, PagePoolExhausted, Request,
                    RequestDeadlineExceeded, RequestHandle, SamplingParams,
                    SpecDecodeError)


def _default_buckets(cap: int) -> Tuple[int, ...]:
    """Power-of-two prefill buckets up to ``cap`` (inclusive)."""
    out, b = [], 8
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return tuple(sorted(set(out)))


@dataclass
class EngineConfig:
    """Engine shape and policy. ``n_slots`` x ``max_len`` is the whole KV
    budget, allocated at startup; ``buckets`` are the padded prefill
    lengths (None = powers of two up to ``max_len``); ``max_queue``
    bounds admission; ``metrics`` receives one ``serve_request`` event
    per finished or failed request and, every ``log_every`` iterations,
    a ``metrics_snapshot`` of the engine's gauges.

    ``paged=True`` serves from the paged KV pool (``serve/pages/``);
    its ``page_len``, ``n_pages`` (0: the contiguous pool's budget,
    ``n_slots * ceil(max_len / page_len)``), ``prefix_share`` and
    ``kv_dtype`` default from ``DPX_SERVE_PAGE_LEN``,
    ``DPX_SERVE_N_PAGES``, ``DPX_SERVE_PREFIX_SHARE`` and
    ``DPX_SERVE_KV_DTYPE``; an explicit non-f32 ``kv_dtype`` on the
    contiguous pool raises.

    ``spec_decode=True`` (default ``DPX_SPEC_DECODE``) speculates with
    ``draft_model`` (a ``TransformerLM`` of the same vocabulary on the
    same device) proposing ``draft_len`` (default
    ``DPX_SPEC_DRAFT_LEN``) tokens per iteration; without a draft, or
    with a sliding-window model, it raises at construction.

    ``param_shardings`` (the reshard-free admit): the shardings the
    model's parameters must already carry, typically a train step's
    ``out_shardings["params"]`` (``parallel.handoff_shardings``);
    admission checks them once (``parallel.front_door.verify_handoff``)
    and never copies or reshards the weights: a mismatch raises a typed
    ``HandoffMismatch`` at construction."""

    n_slots: int = 4
    max_len: int = 256
    buckets: Optional[Tuple[int, ...]] = None
    max_queue: int = 64
    metrics: Optional[MetricsLogger] = None
    log_every: int = 16
    paged: bool = False
    page_len: Optional[int] = None
    n_pages: Optional[int] = None
    prefix_share: Optional[bool] = None
    kv_dtype: Optional[str] = None
    spec_decode: Optional[bool] = None
    draft_model: Optional[object] = None
    draft_len: Optional[int] = None
    param_shardings: Optional[Any] = None


class InferenceEngine:
    """Threaded serving front door over a ``TransformerLM``.

    >>> eng = InferenceEngine(model, EngineConfig(n_slots=4))
    >>> eng.start()
    >>> h = eng.submit(prompt_ids, SamplingParams(max_new_tokens=32))
    >>> tokens = h.result(timeout=60)   # np (n,) int32
    >>> eng.shutdown()

    The engine runs on the model's device (built on the card unless the
    caller asked for the CPU)."""

    def __init__(self, model, config: Optional[EngineConfig] = None):
        self.config = cfg = config or EngineConfig()
        if cfg.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {cfg.n_slots}")
        _check_attn_compatible(model, allow_custom_attn=False)
        if cfg.param_shardings is not None:
            # the train -> serve-admit half of the reshard-free handoff:
            # assert, never copy
            from ..parallel.front_door import verify_handoff
            verify_handoff(model, cfg.param_shardings,
                           what="serve-admit params")
        self.model = model
        self.device = model.device
        self.window = _model_window(model)
        if (self.window is None and model.pos is not None
                and cfg.max_len > model.max_seq):
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's max_seq "
                f"({model.max_seq}): learned position embeddings cannot "
                "address slots past their table")
        self.buckets = tuple(sorted(cfg.buckets)) if cfg.buckets \
            else _default_buckets(cfg.max_len)
        if self.window is None and max(self.buckets) > cfg.max_len:
            raise ValueError(
                f"largest prefill bucket ({max(self.buckets)}) exceeds "
                f"max_len ({cfg.max_len}) — the slot row cannot hold it")
        self._paged = cfg.paged
        if cfg.paged:
            if self.window is not None:
                raise ValueError(
                    "paged KV (serve/pages) does not support "
                    "sliding-window models — the rolling O(window) "
                    "SlotPool already bounds their memory (paged=False)")
            page_len = (cfg.page_len if cfg.page_len is not None
                        else _env.get("DPX_SERVE_PAGE_LEN"))
            n_pages = (cfg.n_pages if cfg.n_pages is not None
                       else _env.get("DPX_SERVE_N_PAGES"))
            if not n_pages:
                n_pages = cfg.n_slots * (-(-cfg.max_len // page_len))
            share = (cfg.prefix_share if cfg.prefix_share is not None
                     else _env.get("DPX_SERVE_PREFIX_SHARE"))
            kv_dtype = (cfg.kv_dtype if cfg.kv_dtype is not None
                        else _env.get("DPX_SERVE_KV_DTYPE"))
            self.pool = PagedSlotPool(model, cfg.n_slots, cfg.max_len,
                                      page_len=page_len, n_pages=n_pages,
                                      prefix_share=bool(share),
                                      kv_dtype=kv_dtype)
        else:
            if cfg.kv_dtype is not None and cfg.kv_dtype != "f32":
                raise ValueError(
                    f"kv_dtype={cfg.kv_dtype!r} requires the paged pool "
                    "(paged=True): the contiguous SlotPool has no "
                    "quantized storage mode")
            self.pool = SlotPool(model, cfg.n_slots, cfg.max_len,
                                 window=self.window)
        spec_on = (cfg.spec_decode if cfg.spec_decode is not None
                   else _env.get("DPX_SPEC_DECODE"))
        self._spec: Optional[SpecState] = None
        if spec_on:
            if self.window is not None:
                raise ValueError(
                    "spec_decode does not support sliding-window models: "
                    "the verify attends the whole resident prefix")
            if cfg.draft_model is None:
                raise ValueError(
                    "spec_decode=True requires draft_model "
                    "(EngineConfig): there is nothing to propose with")
            draft_len = (cfg.draft_len if cfg.draft_len is not None
                         else _env.get("DPX_SPEC_DRAFT_LEN"))
            self._spec = SpecState(
                SpecConfig(draft_model=cfg.draft_model,
                           draft_len=int(draft_len)),
                cfg.n_slots, cfg.max_len)
        # cumulative speculation accounting
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_iters = 0      # speculating row-iterations
        self._spec_tokens = 0     # tokens emitted through spec commits
        # per-tenant inflight quota (0 = unlimited), moved under _cond
        self._tenant_max = int(_env.get("DPX_SERVE_TENANT_MAX_INFLIGHT"))
        self._tenant_inflight: Dict[str, int] = {}
        self.metrics = cfg.metrics
        self._scheduler = AdmissionScheduler(cfg.max_queue)
        self._running: Dict[int, Request] = {}     # slot -> request
        self._free: List[int] = list(range(cfg.n_slots))[::-1]
        self._cur_tokens = np.zeros(cfg.n_slots, np.int64)
        self._iteration = 0
        self._tokens_emitted = 0
        self._completed = 0
        self._failed = 0
        self._next_id = 0
        self._cond = threading.Condition()
        self._stop = False
        self._crash: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- front door --------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               generator: Optional[torch.Generator] = None,
               on_token=None, tenant: Optional[str] = None
               ) -> RequestHandle:
        """Enqueue one request; returns a handle at once.

        ``prompt``: (S,) int token ids. ``generator``: the request's
        sampling noise source (default: one on the engine's device seeded
        with the request id); the engine draws from it exactly as
        ``generate()`` does, so a generator in the same state reproduces
        the stream standalone. ``on_token(token, index)`` is called from
        the engine thread for every emitted token. ``tenant`` counts the
        request against that tenant's inflight quota
        (``DPX_SERVE_TENANT_MAX_INFLIGHT``) until it retires or fails.
        Raises a typed :class:`AdmissionRejected` when the request can
        never be served, or the bounded queue or the tenant's quota is
        full."""
        sp = params or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._cond:
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
                      on_token=on_token, tenant=tenant)
        req.handle = RequestHandle(req)
        # enqueue under the lock the stop flag lives behind: a submit
        # racing shutdown either raises or lands before the final drain
        with self._cond:
            if self._stop:
                raise EngineStopped("engine is shut down", request_id=rid)
            if (tenant is not None and self._tenant_max > 0
                    and self._tenant_inflight.get(tenant, 0)
                    >= self._tenant_max):
                raise AdmissionRejected(
                    f"request {rid}: tenant {tenant!r} already has "
                    f"{self._tenant_inflight[tenant]} inflight "
                    f"request(s) (DPX_SERVE_TENANT_MAX_INFLIGHT="
                    f"{self._tenant_max})", reason="tenant_quota",
                    tenant=tenant, request_id=rid)
            self._scheduler.submit(req)   # may raise AdmissionRejected
            if tenant is not None:
                self._tenant_inflight[tenant] = \
                    self._tenant_inflight.get(tenant, 0) + 1
            self._cond.notify_all()
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
        if self.window is None and s + sp.max_new_tokens > self.config.max_len:
            raise AdmissionRejected(
                f"request {rid}: prompt ({s}) + max_new_tokens "
                f"({sp.max_new_tokens}) exceeds the slot cache "
                f"({self.config.max_len})",
                reason="too_long", request_id=rid)
        if (self.window is not None and self.model.pos is not None
                and s + sp.max_new_tokens > self.model.max_seq):
            raise AdmissionRejected(
                f"request {rid}: learned position embeddings cannot "
                f"extrapolate past max_seq ({self.model.max_seq})",
                reason="too_long", request_id=rid)
        if self._paged:
            # the last sampled token retires without a KV write (decode
            # writes positions s .. s+max_new-2)
            worst = -(-(s + sp.max_new_tokens - 1) // self.pool.page_len)
            if worst > self.pool.n_pages:
                # it could never hold its pages, even with the whole
                # pool to itself: reject now, not starve in the queue
                raise AdmissionRejected(
                    f"request {rid}: worst-case page need ({worst}) "
                    f"exceeds the page pool ({self.pool.n_pages} pages "
                    f"of {self.pool.page_len})",
                    reason="no_free_pages", request_id=rid)

    def start(self) -> "InferenceEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="dpx-torch-serve-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        """Stop the loop at its next iteration boundary; every request
        still queued or running fails with a typed ``EngineStopped``."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if wait and self._thread is not None:
            self._thread.join()
            self._thread = None

    def crash(self, exc: BaseException, wait: bool = True) -> None:
        """Hard-stop the engine as if its loop crashed with ``exc``:
        in-flight requests fail ``EngineStopped`` with ``exc`` chained."""
        with self._cond:
            self._crash = exc
            self._stop = True
            self._cond.notify_all()
        if wait:
            if self._thread is not None:
                self._thread.join(timeout=60.0)
                self._thread = None
            else:
                self._drain_on_stop()

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def stats(self) -> Dict:
        out = {"iterations": self._iteration,
               "completed": self._completed, "failed": self._failed,
               "tokens_emitted": self._tokens_emitted,
               "queue_depth": len(self._scheduler),
               "active_slots": len(self._running),
               "n_slots": self.config.n_slots,
               "decode_steps": self.pool.decode_steps,
               "prefill_admits": dict(self.pool.admits),
               "buckets": self.buckets,
               "paged": self._paged,
               "spec_decode": self._spec is not None}
        if self._paged:
            out["pages"] = self.pool.page_stats()
        if self._spec is not None:
            out["spec"] = {
                "draft_len": self._spec.cfg.draft_len,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance_rate": (
                    self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else None),
                "tokens_per_iteration": (
                    self._spec_tokens / self._spec_iters
                    if self._spec_iters else None),
                "spec_tokens": self._spec_tokens,
                "verify_steps": self.pool.verify_steps,
                "draft_decode_steps": self._spec.pool.decode_steps}
        return out

    def _emit_snapshot(self) -> None:
        """The engine's gauges as one ``metrics_snapshot`` event (the
        JAX engine's dpxmon snapshot record)."""
        m = {"serve.queue_depth": len(self._scheduler),
             "serve.active_slots": len(self._running),
             "serve.slot_occupancy": len(self._running)
             / self.config.n_slots,
             "serve.tokens_emitted": self._tokens_emitted}
        if self._paged:
            ps = self.pool.page_stats()
            m.update({"serve.pool_occupancy": ps["pool_occupancy"],
                      "serve.free_pages": ps["free_pages"],
                      "serve.prefix_hit_rate": ps["prefix_hit_rate"] or 0.0,
                      "serve.page_evictions": ps["evictions"],
                      "serve.kv_bits": ps["kv_bits"],
                      "serve.kv_pool_bytes": ps["kv_pool_bytes"],
                      "serve.bytes_per_resident_token":
                          ps["bytes_per_resident_token"]})
        if self._spec is not None and self._spec_proposed:
            m["serve.spec_acceptance_rate"] = (self._spec_accepted
                                               / self._spec_proposed)
            m["serve.spec_tokens_per_iteration"] = (
                self._spec_tokens / max(self._spec_iters, 1))
        self.metrics.event("metrics_snapshot", source="serve_engine",
                           step=self._iteration, metrics=m)

    # -- engine loop -------------------------------------------------------

    def _loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._cond:
                    # untimed wait is safe: every transition out of idle
                    # (submit, shutdown) notifies under this lock, and no
                    # deadline is pending while queue and slots are empty
                    while (not self._stop and not self._running
                           and not len(self._scheduler)):
                        self._cond.wait()
                    if self._stop:
                        break
                self._iteration += 1
                try:
                    self._sweep_deadlines(time.monotonic())
                    self._admit_from_queue()
                    if self._running:
                        self._decode_all()
                except Exception as e:  # noqa: BLE001
                    # a loop crash (CUDA error, bad weights) must not
                    # strand futures: fail them typed with the cause
                    with self._cond:
                        self._stop = True
                    self._crash = e
                    break
                if (self.metrics is not None
                        and self._iteration % self.config.log_every == 0):
                    self._emit_snapshot()
        self._drain_on_stop()

    def _sweep_deadlines(self, now: float) -> None:
        for req in self._scheduler.expired(now):
            self._fail(req, RequestDeadlineExceeded(
                f"request {req.request_id} missed its deadline "
                f"({req.params.deadline_ms} ms) while queued",
                deadline_ms=req.params.deadline_ms, stage="queued",
                request_id=req.request_id, iteration=self._iteration),
                outcome="deadline_queued")
        for req in list(self._running.values()):
            if req.deadline_t is not None and now >= req.deadline_t:
                self._fail(req, RequestDeadlineExceeded(
                    f"request {req.request_id} missed its deadline "
                    f"({req.params.deadline_ms} ms) mid-decode after "
                    f"{len(req.out_tokens)} tokens",
                    deadline_ms=req.params.deadline_ms, stage="running",
                    request_id=req.request_id, iteration=self._iteration),
                    outcome="deadline_running")

    def _admit_from_queue(self) -> None:
        while self._free:
            req = self._scheduler.pop()
            if req is None:
                return
            slot = self._free.pop()
            # claim the slot BEFORE the prefill: if it raises, the crash
            # drain finds the request in _running and fails its future
            req.state = RUNNING
            req.slot = slot
            self._running[slot] = req
            if self._paged:
                try:
                    logits, n_hit, offset = self.pool.admit(
                        req.prompt, slot, self.buckets)
                except PagePoolExhausted as e:
                    self._running.pop(slot, None)
                    self._free.append(slot)
                    req.slot = None
                    if self._running:
                        # back-pressure: a retirement will free pages;
                        # retry first in its class next iteration
                        req.state = QUEUED
                        self._scheduler.requeue(req)
                        return
                    exc = AdmissionRejected(
                        f"request {req.request_id}: page pool exhausted "
                        f"at admission ({e.needed} page(s) needed, "
                        f"{e.free_pages} free) with no running request "
                        f"to release pages", reason="no_free_pages",
                        request_id=req.request_id,
                        iteration=self._iteration)
                    exc.__cause__ = e
                    self._fail(req, exc, outcome="no_free_pages")
                    continue
                except AdmissionRejected as e:
                    self._running.pop(slot, None)
                    self._free.append(slot)
                    req.slot = None
                    exc = AdmissionRejected(
                        f"request {req.request_id}: {e}", reason=e.reason,
                        request_id=req.request_id,
                        iteration=self._iteration)
                    exc.__cause__ = e
                    self._fail(req, exc, outcome=e.reason)
                    continue
                req.prefix_hit_pages = n_hit
                req.prefill_tokens_saved = offset
            else:
                s = int(req.prompt.shape[0])
                bucket = next(b for b in self.buckets if b >= s)
                padded = torch.zeros((1, bucket), dtype=torch.long,
                                     device=self.device)
                padded[0, :s] = torch.from_numpy(
                    req.prompt.astype(np.int64))
                logits = self.pool.admit(padded, s, slot)
            if self._spec is not None and req.params.temperature == 0.0:
                # greedy requests speculate: prefill the draft's own
                # slot too (a prompt no bucket fits runs unspeculated)
                self._spec.admit(req.prompt, slot, self.buckets)
            req.admit_t = time.monotonic()
            req.admit_iteration = self._iteration
            self._emit(req, self._sample_for(req, logits))

    def _decode_all(self) -> None:
        spec_slots: List[int] = []
        if self._spec is not None:
            spec_slots = [s for s in sorted(self._running)
                          if self._spec.active[s]]
        slots = [s for s in sorted(self._running) if s not in spec_slots]
        if self._paged:
            # speculating rows take no part: their pages grow once
            # acceptance is known (ensure_spec_capacity), so rejected
            # drafts never demand a page
            for slot in list(slots):
                req = self._running[slot]
                try:
                    self.pool.ensure_decode_capacity(slot)
                except PagePoolExhausted as e:
                    # the victim fails typed; co-resident streams go on
                    self._fail(req, PagePoolExhausted(
                        f"request {req.request_id}: page pool exhausted "
                        f"mid-decode after {len(req.out_tokens)} tokens "
                        f"({e.needed} page(s) needed, {e.free_pages} "
                        f"free — every page held by a live reader)",
                        needed=e.needed, free_pages=e.free_pages,
                        request_id=req.request_id,
                        iteration=self._iteration),
                        outcome="no_free_pages")
                    slots.remove(slot)
        if slots:
            active = np.zeros(self.config.n_slots, bool)
            active[slots] = True
            logits = self.pool.decode(
                torch.from_numpy(self._cur_tokens).to(self.device), active)
            for slot in slots:
                req = self._running[slot]
                self._emit(req, self._sample_for(req, logits[slot:slot + 1]))
        spec_slots = [s for s in spec_slots if s in self._running]
        if spec_slots:
            self._spec_step(spec_slots)

    def _spec_fail(self, slots: List[int], cause: Exception,
                   stage: str) -> None:
        """Fail the speculating victims of a propose, verify or commit
        fault, typed and stage-attributed; non-speculating co-residents
        go on (the verify wrote nothing)."""
        for slot in slots:
            req = self._running.get(slot)
            if req is None:
                continue
            exc = SpecDecodeError(
                f"request {req.request_id}: speculative {stage} failed "
                f"after {len(req.out_tokens)} tokens: {cause!r}",
                stage=stage, request_id=req.request_id,
                iteration=self._iteration)
            exc.__cause__ = cause
            self._fail(req, exc, outcome="spec_decode")

    def _spec_step(self, spec_slots: List[int]) -> None:
        """One speculative iteration of the speculating slots: the draft
        proposes k tokens each, one batched verify scores all k+1
        positions, the longest matching prefix (and the bonus token) is
        emitted, and only accepted positions are committed; rollback is
        the draft's length rewind."""
        spec = self._spec
        k = spec.cfg.draft_len
        try:
            drafts = spec.propose(spec_slots, self._cur_tokens[spec_slots])
        except Exception as e:  # noqa: BLE001 — victim containment
            self._spec_fail(spec_slots, e, "propose")
            return
        tokens = np.zeros((self.config.n_slots, k + 1), np.int64)
        tokens[spec_slots, 0] = self._cur_tokens[spec_slots]
        tokens[spec_slots, 1:] = drafts
        try:
            logits, sk, sv = self.pool.spec_verify(
                torch.from_numpy(tokens).to(self.device))
            logits_np = logits[spec_slots].to(torch.float32).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — victim containment
            self._spec_fail(spec_slots, e, "verify")
            return
        commit = np.zeros(self.config.n_slots, np.int64)
        emits: Dict[int, List[int]] = {}
        for i, slot in enumerate(spec_slots):
            req = self._running[slot]
            sp = req.params
            out, e = accept_greedy(
                drafts[i], logits_np[i],
                sp.max_new_tokens - len(req.out_tokens), sp.eos_token)
            req.spec_proposed += k
            req.spec_accepted += e - 1
            self._spec_proposed += k
            self._spec_accepted += e - 1
            self._spec_iters += 1
            commit[slot] = e
            emits[slot] = out
        if self._paged:
            # only now, with the accepted counts known, may pages be
            # demanded; exhaustion fails that victim typed (its commit
            # zeroes, nothing of its iteration lands)
            for slot in list(emits):
                req = self._running[slot]
                try:
                    self.pool.ensure_spec_capacity(slot, int(commit[slot]))
                except PagePoolExhausted as e:
                    n_acc = int(commit[slot])
                    commit[slot] = 0
                    del emits[slot]
                    self._fail(req, PagePoolExhausted(
                        f"request {req.request_id}: page pool exhausted "
                        f"committing {n_acc} accepted token(s) after "
                        f"{len(req.out_tokens)} tokens ({e.needed} "
                        f"page(s) needed, {e.free_pages} free)",
                        needed=e.needed, free_pages=e.free_pages,
                        request_id=req.request_id,
                        iteration=self._iteration),
                        outcome="no_free_pages")
        try:
            self.pool.spec_commit(sk, sv, commit)
        except Exception as e:  # noqa: BLE001 — victim containment
            self._spec_fail(list(emits), e, "commit")
            return
        alive = [s for s in emits if s in self._running]
        spec.rollback(alive, commit[alive])
        self._spec_tokens += int(commit[alive].sum()) if alive else 0
        for slot in alive:
            req = self._running[slot]
            for tok in emits[slot]:
                self._emit(req, tok)
                if req.done:
                    break

    def _sample_for(self, req: Request, logits) -> int:
        sp = req.params
        tok = _sample(logits, req.generator, sp.temperature, sp.top_k,
                      sp.top_p)
        return int(tok[0].item())

    def _emit(self, req: Request, tok: int) -> None:
        now = time.monotonic()
        i = len(req.out_tokens)
        req.out_tokens.append(tok)    # handle.tokens aliases this list
        if req.first_token_t is None:
            req.first_token_t = now
        req.last_token_t = now
        self._cur_tokens[req.slot] = tok
        self._tokens_emitted += 1
        if req.on_token is not None:
            try:
                req.on_token(tok, i)
            except Exception:  # noqa: BLE001 — a user callback must
                pass           # never take down the engine loop
        sp = req.params
        if (len(req.out_tokens) >= sp.max_new_tokens
                or (sp.eos_token is not None and tok == sp.eos_token)):
            self._retire(req)

    def _free_slot(self, req: Request) -> None:
        if req.slot is not None:
            self.pool.release(req.slot)
            if self._spec is not None:
                # draft state exits through the same funnel
                self._spec.release(req.slot)
            self._running.pop(req.slot, None)
            self._free.append(req.slot)
            req.slot = None

    def _finish(self, req: Request, outcome: str) -> Dict:
        req.retire_iteration = self._iteration
        self._free_slot(req)
        self._tenant_release(req)
        rec = request_record(req, outcome)
        req.handle.metrics = rec
        if self.metrics is not None:
            self.metrics.event("serve_request", **rec)
        return rec

    def _retire(self, req: Request) -> None:
        req.state = FINISHED
        self._completed += 1
        self._finish(req, "ok")
        req.handle.future.set_result(np.asarray(req.out_tokens, np.int32))

    def _fail(self, req: Request, exc: BaseException, outcome: str) -> None:
        req.state = FAILED
        self._failed += 1
        self._finish(req, outcome)
        req.handle.future.set_exception(exc)

    def _tenant_release(self, req: Request) -> None:
        """Give the tenant its inflight credit back at any terminal
        transition (retirement or typed failure, queued or running)."""
        if req.tenant is None:
            return
        with self._cond:
            n = self._tenant_inflight.get(req.tenant, 0) - 1
            if n > 0:
                self._tenant_inflight[req.tenant] = n
            else:
                self._tenant_inflight.pop(req.tenant, None)

    def _drain_on_stop(self) -> None:
        cause = f" (engine loop crashed: {self._crash!r})" \
            if self._crash is not None else ""
        for req in self._scheduler.drain() + list(self._running.values()):
            exc = EngineStopped(
                f"engine stopped with request {req.request_id} "
                f"{req.state}{cause}", request_id=req.request_id,
                iteration=self._iteration)
            exc.__cause__ = self._crash
            self._fail(req, exc, outcome="engine_stopped")
