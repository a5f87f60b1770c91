"""The decode half of the disaggregated split (``serve/disagg/``).

Counterpart of ``distributed_pytorch_tpu/serve/disagg/decode.py``: the
loop that owns token cadence. Each iteration sweeps deadlines (running
requests, and sent-but-unreceived handoffs -> typed ``HandoffTimeout``),
drains the transport (every frame is integrity-checked by
``frames.decode_frame``; damage fails the named request typed
``HandoffCorrupt`` and never reaches the pool), installs pending frames
in this engine's page pool through the admissions' allocation path
(``PagedSlotPool.adopt``), so pool exhaustion is back-pressure while
streams run, and advances every active slot one token through the paged
decode (or a speculative iteration, ``serve/spec/``).

Nothing in this loop runs a prompt: a long prefill cannot appear
between two decode iterations, which is why the split exists (TPOT is
this engine's alone; ``serve/metrics.py`` splits TTFT accordingly). On
the card the loop runs on a CUDA stream of its own; the adopt's copy to
the card runs on it.

Token 0 is sampled here from the frame's exact f32 logits with the
request's generator, the draw ``generate()`` makes first, so an exact
(f32) handoff streams ``generate()``'s tokens from token 0 on.

Fault hooks (``runtime/faults.py``): each iteration fires
``on_serve_iteration``, the speculative step ``draft_propose`` and
``spec_verify``, as the monolithic engine does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ...models.generate import _sample
from ...runtime import faults
from ..pages import PagedSlotPool
from ..spec import SpecState, accept_greedy
from ..types import (HandoffCorrupt, PagePoolExhausted, Request,
                     RequestDeadlineExceeded, SpecDecodeError)
from . import frames
from .prefill import loop_stream, on_stream
from .transport import TransportSevered

#: Idle-poll interval of the decode loop (s): how long one recv blocks
#: when no stream is active; long enough not to spin, short enough that
#: a frame or a shutdown is picked up at once.
_IDLE_POLL_S = 0.02


class DecodeEngine:
    """The decode loop and slot pool of the disaggregated split."""

    def __init__(self, model, router, transport, *, n_slots: int,
                 max_len: int, page_len: int, n_pages: int,
                 kv_dtype: str = "f32", spec=None, buckets=None):
        self.model = model
        self.device = model.device
        self.router = router
        self.transport = transport
        self.n_slots = n_slots
        # no prefix index: adopted pages are private to their stream
        # (the sharing happened on the prefill side)
        self.pool = PagedSlotPool(model, n_slots, max_len,
                                  page_len=page_len, n_pages=n_pages,
                                  prefix_share=False, kv_dtype=kv_dtype)
        # speculative decoding lives here, with token cadence; ``spec``
        # is a SpecConfig, the draft prefills the request's prompt at
        # adoption over ``buckets``
        self._spec: Optional[SpecState] = None
        self._spec_buckets = tuple(buckets) if buckets else ()
        if spec is not None:
            self._spec = SpecState(spec, n_slots, max_len)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_iters = 0
        self.spec_tokens = 0
        self.iterations = 0
        self.tokens_emitted = 0
        self._running: Dict[int, Request] = {}
        self._free: List[int] = list(range(n_slots))[::-1]
        self._cur_tokens = np.zeros(n_slots, np.int64)
        self._pending = deque()       # decoded frames awaiting pages
        self._prefill_dead = False
        self._stop = False
        self._stream = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stream = loop_stream(self.device)
        self._thread = threading.Thread(target=self._loop,
                                        name="dpx-torch-serve-decode",
                                        daemon=True)
        self._thread.start()

    def stop(self, wait: bool = True) -> None:
        self._stop = True
        if (wait and self._thread is not None
                and self._thread is not threading.current_thread()):
            # the loop polls with a bounded timeout, so it sees the flag
            # within one idle tick
            self._thread.join()
            self._thread = None

    def drain_requests(self) -> List[Request]:
        """Everything still resident here (shutdown drain)."""
        return list(self._running.values()) + [e[1] for e in self._pending]

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        with torch.inference_mode(), on_stream(self._stream):
            self._serve()

    def _serve(self) -> None:
        while not self._stop:
            busy = bool(self._running or self._pending
                        or self.router.handoff_count())
            if not busy:
                # fully idle: wait for a frame (or stop) without counting
                # an iteration; a severed transport with no work is quiet
                if self._prefill_dead:
                    time.sleep(_IDLE_POLL_S)
                else:
                    try:
                        self._drain_transport(idle=True)
                    except Exception as e:  # noqa: BLE001
                        self.router.on_decode_crash(e)
                        return
                continue
            self.iterations += 1
            try:
                faults.on_serve_iteration(self.iterations)
                now = time.monotonic()
                self._sweep_deadlines(now)
                self.router.sweep_handoff_timeouts(now, self.iterations)
                # non-blocking drain while streams decode; a short
                # blocking poll when the only work is a frame in flight
                self._drain_transport(
                    idle=not (self._running or self._pending))
                self._admit_pending()
                if self._running:
                    self._decode_all()
                self.router.periodic_metrics(self.iterations)
            except Exception as e:  # noqa: BLE001 — a decode-loop crash
                # fails every resident future typed, with the cause
                # chained, then stops serving (the monolithic engine's
                # crash drain)
                self.router.on_decode_crash(e)
                return

    def _sweep_deadlines(self, now: float) -> None:
        for req in list(self._running.values()):
            if req.deadline_t is not None and now >= req.deadline_t:
                self.fail_resident(req, RequestDeadlineExceeded(
                    f"request {req.request_id} missed its deadline "
                    f"({req.params.deadline_ms} ms) mid-decode after "
                    f"{len(req.out_tokens)} tokens",
                    deadline_ms=req.params.deadline_ms, stage="running",
                    request_id=req.request_id,
                    iteration=self.iterations),
                    outcome="deadline_running")

    def _drain_transport(self, idle: bool) -> None:
        """Take every available frame off the transport; a severed
        transport is the prefill engine's death, and decode keeps
        serving its residents."""
        if self._prefill_dead:
            return
        timeout = _IDLE_POLL_S if idle else 0.0
        while True:
            try:
                raw = self.transport.recv(timeout)
            except TransportSevered as e:
                self._prefill_dead = True
                self.router.on_prefill_dead(e)
                return
            if raw is None:
                return
            t_recv = time.monotonic()
            try:
                # matched pool and wire widths keep the pages quantized:
                # the sender's resident codes are adopted as they are
                frame = frames.decode_frame(
                    raw, keep_bits=self.pool.quant_bits)
            except HandoffCorrupt as e:
                self.router.fail_handoff_corrupt(e, self.iterations)
                continue
            del raw
            req = self.router.take_handoff(frame.request_id)
            if req is None or req.done:
                # the request already failed (timeout, deadline): the
                # late frame is dropped, nothing was adopted
                continue
            self.transport.stats.record("handoff_recv", frame.kv_bytes,
                                        time.monotonic() - t_recv)
            req.handoff_recv_t = t_recv
            self._pending.append((frame, req))
            timeout = 0.0

    def _admit_pending(self) -> None:
        """Install pending frames in free slots, first come first served.
        Pool exhaustion is back-pressure while streams run (the frame
        waits for a retirement), a typed failure when nothing could ever
        free pages."""
        while self._pending and self._free:
            frame, req = self._pending[0]
            if req.done:
                self._pending.popleft()
                continue
            slot = self._free[-1]
            try:
                if frame.quantized:
                    self.pool.adopt_quantized(slot, frame.length,
                                              frame.ks, frame.vs)
                else:
                    self.pool.adopt(slot, frame.length, frame.ks, frame.vs)
            except PagePoolExhausted as e:
                if self._running:
                    return            # retry after a retirement
                self._pending.popleft()
                self.router.fail(req, PagePoolExhausted(
                    f"request {req.request_id}: decode page pool "
                    f"exhausted adopting its handoff ({e.needed} page(s) "
                    f"needed, {e.free_pages} free) with no running "
                    f"stream to release pages",
                    needed=e.needed, free_pages=e.free_pages,
                    request_id=req.request_id,
                    iteration=self.iterations),
                    outcome="no_free_pages")
                continue
            self._pending.popleft()   # the frame's host pages go with it
            self._free.pop()
            req.slot = slot
            req.stage = "decode"
            self._running[slot] = req
            if self._spec is not None and req.params.temperature == 0.0:
                # the draft reruns the whole prompt here: its prefill is
                # cheap by construction and needs no second handoff
                self._spec.admit(req.prompt, slot, self._spec_buckets)
            logits = torch.from_numpy(frame.logits)[None].to(self.device)
            self._emit(req, self._sample_for(req, logits))

    def _decode_all(self) -> None:
        spec_slots: List[int] = []
        if self._spec is not None:
            spec_slots = [s for s in sorted(self._running)
                          if self._spec.active[s]]
        slots = [s for s in sorted(self._running) if s not in spec_slots]
        for slot in list(slots):
            req = self._running[slot]
            try:
                self.pool.ensure_decode_capacity(slot)
            except PagePoolExhausted as e:
                self.fail_resident(req, PagePoolExhausted(
                    f"request {req.request_id}: decode page pool "
                    f"exhausted after {len(req.out_tokens)} tokens "
                    f"({e.needed} page(s) needed, {e.free_pages} free)",
                    needed=e.needed, free_pages=e.free_pages,
                    request_id=req.request_id,
                    iteration=self.iterations),
                    outcome="no_free_pages")
                slots.remove(slot)
        if slots:
            active = np.zeros(self.n_slots, bool)
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
        for slot in slots:
            req = self._running.get(slot)
            if req is None:
                continue
            exc = SpecDecodeError(
                f"request {req.request_id}: speculative {stage} failed "
                f"after {len(req.out_tokens)} tokens: {cause!r}",
                stage=stage, request_id=req.request_id,
                iteration=self.iterations)
            exc.__cause__ = cause
            self.fail_resident(req, exc, outcome="spec_decode")

    def _spec_step(self, spec_slots: List[int]) -> None:
        """One speculative iteration, the decode-side twin of
        ``InferenceEngine._spec_step``: propose k, one batched verify,
        commit the accepted prefix; failures stay with the speculating
        victims, through the router's one finish path."""
        spec = self._spec
        k = spec.cfg.draft_len
        try:
            faults.on_comm_op("draft_propose")
            drafts = spec.propose(spec_slots, self._cur_tokens[spec_slots])
        except Exception as e:  # noqa: BLE001 — victim containment
            self._spec_fail(spec_slots, e, "propose")
            return
        tokens = np.zeros((self.n_slots, k + 1), np.int64)
        tokens[spec_slots, 0] = self._cur_tokens[spec_slots]
        tokens[spec_slots, 1:] = drafts
        try:
            faults.on_comm_op("spec_verify")
            logits, sk, sv = self.pool.spec_verify(
                torch.from_numpy(tokens).to(self.device))
            logits_np = logits[spec_slots].to(torch.float32).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — victim containment
            self._spec_fail(spec_slots, e, "verify")
            return
        commit = np.zeros(self.n_slots, np.int64)
        emits: Dict[int, List[int]] = {}
        for i, slot in enumerate(spec_slots):
            req = self._running[slot]
            sp = req.params
            out, e = accept_greedy(
                drafts[i], logits_np[i],
                sp.max_new_tokens - len(req.out_tokens), sp.eos_token)
            req.spec_proposed += k
            req.spec_accepted += e - 1
            self.spec_proposed += k
            self.spec_accepted += e - 1
            self.spec_iters += 1
            commit[slot] = e
            emits[slot] = out
        for slot in list(emits):
            req = self._running[slot]
            try:
                self.pool.ensure_spec_capacity(slot, int(commit[slot]))
            except PagePoolExhausted as e:
                n_acc = int(commit[slot])
                commit[slot] = 0
                del emits[slot]
                self.fail_resident(req, PagePoolExhausted(
                    f"request {req.request_id}: decode page pool "
                    f"exhausted committing {n_acc} accepted token(s) "
                    f"after {len(req.out_tokens)} tokens ({e.needed} "
                    f"page(s) needed, {e.free_pages} free)",
                    needed=e.needed, free_pages=e.free_pages,
                    request_id=req.request_id,
                    iteration=self.iterations),
                    outcome="no_free_pages")
        try:
            self.pool.spec_commit(sk, sv, commit)
        except Exception as e:  # noqa: BLE001 — victim containment
            self._spec_fail(list(emits), e, "commit")
            return
        alive = [s for s in emits if s in self._running]
        spec.rollback(alive, commit[alive])
        if alive:
            self.spec_tokens += int(commit[alive].sum())
        for slot in alive:
            req = self._running[slot]
            for tok in emits[slot]:
                self._emit(req, tok)
                if req.done:
                    break

    # -- per-request mechanics (as in serve/engine.py) ---------------------

    def _sample_for(self, req: Request, logits) -> int:
        sp = req.params
        tok = _sample(logits, req.generator, sp.temperature, sp.top_k,
                      sp.top_p)
        return int(tok[0].item())

    def _emit(self, req: Request, tok: int) -> None:
        now = time.monotonic()
        i = len(req.out_tokens)
        req.out_tokens.append(tok)
        if req.first_token_t is None:
            req.first_token_t = now
        req.last_token_t = now
        self._cur_tokens[req.slot] = tok
        self.tokens_emitted += 1
        if req.on_token is not None:
            try:
                req.on_token(tok, i)
            except Exception:  # noqa: BLE001 — a user callback must
                pass           # never take down the decode loop
        sp = req.params
        if (len(req.out_tokens) >= sp.max_new_tokens
                or (sp.eos_token is not None and tok == sp.eos_token)):
            self._retire(req)

    def _free_slot(self, req: Request) -> None:
        if req.slot is not None:
            self.pool.release(req.slot)
            if self._spec is not None:
                self._spec.release(req.slot)
            self._running.pop(req.slot, None)
            self._free.append(req.slot)
            req.slot = None

    def _retire(self, req: Request) -> None:
        # the terminal state is the router's to set (its exactly-once
        # gate keys on req.done); this side only releases
        req.retire_iteration = self.iterations
        self._free_slot(req)
        self.router.finish_ok(req)

    def fail_resident(self, req: Request, exc: Exception,
                      outcome: str) -> None:
        """Fail a decode-resident request: release its slot and pages,
        then route the typed error through the router's finish path."""
        req.retire_iteration = self.iterations
        self._free_slot(req)
        self.router.fail(req, exc, outcome=outcome)

    def stats(self) -> dict:
        out = {"iterations": self.iterations,
               "tokens_emitted": self.tokens_emitted,
               "active_slots": len(self._running),
               "pending_handoffs": len(self._pending),
               "decode_steps": self.pool.decode_steps,
               "prefill_admits": dict(self.pool.admits),   # stays {}
               "pages": self.pool.page_stats()}
        if self._spec is not None:
            out["spec"] = {
                "draft_len": self._spec.cfg.draft_len,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                    if self.spec_proposed else None),
                "tokens_per_iteration": (self.spec_tokens / self.spec_iters
                                         if self.spec_iters else None),
                "spec_tokens": self.spec_tokens,
                "verify_steps": self.pool.verify_steps,
                "draft_decode_steps": self._spec.pool.decode_steps}
        return out
