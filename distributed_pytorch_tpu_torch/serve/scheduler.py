"""Admission scheduling: a bounded priority queue with deadlines.

The port's copy of ``distributed_pytorch_tpu/serve/scheduler.py``: FCFS
within a priority class (heap ordered by (priority, arrival sequence)),
bounded so a burst fails fast with a typed ``AdmissionRejected``;
queued requests past their deadline are swept by the engine loop.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import List, Optional

from .types import AdmissionRejected, Request


class AdmissionScheduler:
    """Thread-safe bounded admission queue (FCFS + priority)."""

    def __init__(self, max_queue: int = 64):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._heap: List[tuple] = []    # (priority, seq, Request)
        self._seq = 0
        self._front = 0                 # decreasing: requeue-at-front seqs
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def submit(self, req: Request) -> None:
        """Enqueue or raise a typed rejection (bounded queue)."""
        with self._lock:
            if len(self._heap) >= self.max_queue:
                raise AdmissionRejected(
                    f"admission queue full ({self.max_queue} pending); "
                    f"request {req.request_id} rejected",
                    reason="queue_full", request_id=req.request_id)
            heapq.heappush(self._heap,
                           (req.params.priority, self._seq, req))
            self._seq += 1

    def requeue(self, req: Request) -> None:
        """Put a just-popped request back at the FRONT of its priority
        class (the paged pool's back-pressure: admission found no pages
        this iteration, so the request retries after a retirement frees
        some). Bypasses ``max_queue``: the request was admitted to the
        queue once already."""
        with self._lock:
            self._front -= 1
            heapq.heappush(self._heap,
                           (req.params.priority, self._front, req))

    def pop(self) -> Optional[Request]:
        """Highest-priority (then oldest) request, or None."""
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def expired(self, now: Optional[float] = None) -> List[Request]:
        """Remove and return queued requests whose deadline has passed."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dead = [e for e in self._heap
                    if e[2].deadline_t is not None and now >= e[2].deadline_t]
            if dead:
                live = [e for e in self._heap if e not in dead]
                heapq.heapify(live)
                self._heap = live
            return [e[2] for e in dead]

    def drain(self) -> List[Request]:
        """Remove and return everything (engine shutdown)."""
        with self._lock:
            out = [e[2] for e in self._heap]
            self._heap = []
            return out
