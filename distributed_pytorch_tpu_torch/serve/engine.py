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

Left for later slices: paged KV, speculative decoding, KV quantization,
tenant quotas, fault-injection hooks and metric gauges.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generate import _check_attn_compatible, _model_window, _sample
from ..runtime.device import default_generator
from ..utils.logging import MetricsLogger
from .cache import SlotPool
from .metrics import request_record
from .scheduler import AdmissionScheduler
from .types import (FAILED, FINISHED, RUNNING, AdmissionRejected,
                    EngineStopped, Request, RequestDeadlineExceeded,
                    RequestHandle, SamplingParams)


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
    per finished or failed request."""

    n_slots: int = 4
    max_len: int = 256
    buckets: Optional[Tuple[int, ...]] = None
    max_queue: int = 64
    metrics: Optional[MetricsLogger] = None


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
        self.pool = SlotPool(model, cfg.n_slots, cfg.max_len,
                             window=self.window)
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
               on_token=None) -> RequestHandle:
        """Enqueue one request; returns a handle at once.

        ``prompt``: (S,) int token ids. ``generator``: the request's
        sampling noise source (default: one on the engine's device seeded
        with the request id); the engine draws from it exactly as
        ``generate()`` does, so a generator in the same state reproduces
        the stream standalone. ``on_token(token, index)`` is called from
        the engine thread for every emitted token. Raises a typed
        :class:`AdmissionRejected` when the request can never be served
        or the bounded queue is full."""
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
                      on_token=on_token)
        req.handle = RequestHandle(req)
        # enqueue under the lock the stop flag lives behind: a submit
        # racing shutdown either raises or lands before the final drain
        with self._cond:
            if self._stop:
                raise EngineStopped("engine is shut down", request_id=rid)
            self._scheduler.submit(req)   # may raise AdmissionRejected
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
        return {"iterations": self._iteration,
                "completed": self._completed, "failed": self._failed,
                "tokens_emitted": self._tokens_emitted,
                "queue_depth": len(self._scheduler),
                "active_slots": len(self._running),
                "n_slots": self.config.n_slots,
                "decode_steps": self.pool.decode_steps,
                "prefill_admits": dict(self.pool.admits),
                "buckets": self.buckets}

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
            s = int(req.prompt.shape[0])
            bucket = next(b for b in self.buckets if b >= s)
            padded = torch.zeros((1, bucket), dtype=torch.long,
                                 device=self.device)
            padded[0, :s] = torch.from_numpy(req.prompt.astype(np.int64))
            logits = self.pool.admit(padded, s, slot)
            req.admit_t = time.monotonic()
            req.admit_iteration = self._iteration
            self._emit(req, self._sample_for(req, logits))

    def _decode_all(self) -> None:
        slots = sorted(self._running)
        active = np.zeros(self.config.n_slots, bool)
        active[slots] = True
        logits = self.pool.decode(
            torch.from_numpy(self._cur_tokens).to(self.device), active)
        for slot in slots:
            req = self._running[slot]
            self._emit(req, self._sample_for(req, logits[slot:slot + 1]))

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
            self._running.pop(req.slot, None)
            self._free.append(req.slot)
            req.slot = None

    def _finish(self, req: Request, outcome: str) -> Dict:
        req.retire_iteration = self._iteration
        self._free_slot(req)
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
