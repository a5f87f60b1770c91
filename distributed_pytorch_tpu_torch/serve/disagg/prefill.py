"""The prefill half of the disaggregated split (``serve/disagg/``).

Counterpart of ``distributed_pytorch_tpu/serve/disagg/prefill.py``. One
loop, one job: pop an admitted request, compute its prompt's KV (with
radix prefix reuse, so a shared system prompt is computed once and every
later request prefills only its tail; at >= ``DPX_FLASH_MIN_SEQ`` keys a
flash model runs the CUDA flash forward), then extract the pages, encode
the handoff frame at the configured wire width and hand it to the
transport. Prefill never decodes: a long prompt takes this engine's
time, and the decode loop's token cadence (TPOT) is out of its reach.

The engine owns a single-slot :class:`~..pages.PagedSlotPool` whose
prefix index persists across requests: pages released after extraction
stay resident at refcount zero, so the radix hit accounting
(``prefix_hit_pages`` / ``prefill_tokens_saved``) works as in the
monolithic paged engine.

On the card the loop runs on a CUDA stream of its own, created at
:meth:`PrefillEngine.start` after the work the building thread queued:
a prefill never queues ahead of a decode step on one stream. The
extract's copy to the host orders this stream; nothing but the
read-only weights is shared with the decode loop.

A severed transport or a crash in this loop reaches
:meth:`~.router.DisaggEngine.on_prefill_dead`, which fails only the
requests still on the prefill side of the handoff, typed
``PrefillEngineDied``; decode-resident streams never hear of it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

from ..pages import PagedSlotPool
from ..types import RUNNING, AdmissionRejected, PagePoolExhausted
from . import frames


def loop_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream for one engine loop, ordered after everything the
    calling thread's current stream has queued (the weights and pools it
    built); None on the CPU."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def on_stream(stream) -> contextlib.AbstractContextManager:
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class PrefillEngine:
    """The prefill loop: admit -> tail prefill (radix reuse) -> extract
    pages -> encode frame -> send. Fed by the router's scheduler."""

    def __init__(self, model, router, transport, *, buckets,
                 page_len: int, n_pages: int, prefix_share: bool,
                 bits: Optional[int], kv_dtype: str = "f32"):
        self.model = model
        self.router = router
        self.transport = transport
        self.buckets = buckets
        self.bits = bits
        # one prefill slot: admission is the work, one prompt at a time;
        # the radix index carries the prefix residency across requests
        self.pool = PagedSlotPool(model, 1, max(buckets),
                                  page_len=page_len, n_pages=n_pages,
                                  prefix_share=prefix_share,
                                  kv_dtype=kv_dtype)
        self.iterations = 0
        self._cond = threading.Condition()
        self._stop = False
        self._active = None           # the request being prefilled
        self._stream = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stream = loop_stream(self.model.device)
        self._thread = threading.Thread(target=self._loop,
                                        name="dpx-torch-serve-prefill",
                                        daemon=True)
        self._thread.start()

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def stop(self, wait: bool = True) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if (wait and self._thread is not None
                and self._thread is not threading.current_thread()):
            # the loop exits at its next iteration boundary
            self._thread.join()
            self._thread = None

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        with torch.inference_mode(), on_stream(self._stream):
            self._serve()

    def _serve(self) -> None:
        sched = self.router.scheduler
        while True:
            with self._cond:
                # untimed wait is safe: submit and stop both notify
                # under this lock
                while not self._stop and not len(sched):
                    self._cond.wait()
                if self._stop:
                    return
            self.iterations += 1
            try:
                for req in sched.expired(time.monotonic()):
                    self.router.fail_queued_deadline(req)
                req = sched.pop()
                if req is None:
                    continue
                self._active = req
                req.state = RUNNING
                req.stage = "prefill"
                self._prefill_one(req)
                self._active = None
            except Exception as e:  # noqa: BLE001 — a severed transport
                # or a prefill crash (CUDA error, codec bug) fails only
                # the prefill-side requests, typed; decode keeps serving.
                # The active request stays in drain_requests() until the
                # router has failed it
                self.router.on_prefill_dead(e)
                self._active = None
                return

    def _prefill_one(self, req) -> None:
        # queue_ms ends when the prompt is claimed; the prefill compute
        # lands in the decomposition's prefill_ms span (serve/metrics)
        req.admit_t = time.monotonic()
        req.admit_iteration = self.iterations
        try:
            logits, n_hit, offset = self.pool.admit(req.prompt, 0,
                                                    self.buckets)
        except PagePoolExhausted as e:
            # a single slot with LRU-evictable residency: only a pool
            # smaller than the prompt lands here (submit bounds it)
            exc = AdmissionRejected(
                f"request {req.request_id}: prefill page pool exhausted "
                f"({e.needed} page(s) needed, {e.free_pages} free)",
                reason="no_free_pages", request_id=req.request_id)
            exc.__cause__ = e
            self.router.fail(req, exc, outcome="no_free_pages")
            return
        req.prefix_hit_pages = n_hit
        req.prefill_tokens_saved = offset
        logits = logits[0].to(torch.float32).cpu().numpy()
        if (self.pool.quant_bits is not None
                and self.pool.quant_bits == self.bits):
            # matched pool and wire widths: the frame carries the pool's
            # resident codes and scales as they are
            length, kqs, vqs = self.pool.extract_quantized(0)
            self.pool.release(0)
            frame, kv_bytes = frames.encode_frame_quantized(
                req.request_id, length, logits, kqs, vqs, self.bits)
        else:
            length, ks, vs = self.pool.extract(0)
            self.pool.release(0)
            frame, kv_bytes = frames.encode_frame(
                req.request_id, length, logits, ks, vs, self.bits)
        req.handoff_bytes = kv_bytes
        # the handoff stage begins before the send: if the transport
        # dies inside it, the victim is already in the in-flight set
        # (on_prefill_dead finds it) and the timeout sweep has its start
        req.stage = "handoff"
        req.handoff_send_t = time.monotonic()
        self.router.enter_handoff(req)
        self.transport.send(frame, kv_bytes)

    def drain_requests(self):
        """The request on this engine's side (the active prefill, if
        any): the router adds it to the prefill-death victims."""
        req = self._active
        return [req] if req is not None else []

    def stats(self) -> dict:
        return {"iterations": self.iterations,
                "prefill_admits": dict(self.pool.admits),
                "decode_steps": self.pool.decode_steps,   # stays 0
                "pages": self.pool.page_stats()}
