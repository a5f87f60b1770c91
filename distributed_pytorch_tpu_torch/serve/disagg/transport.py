"""Handoff transports: how encoded frames travel prefill -> decode.

The port's copy of ``distributed_pytorch_tpu/serve/disagg/transport.py``.
A transport is ``send`` / ``recv`` / ``abort`` plus a ``CommStats`` that
books the KV wire bytes under ``handoff_send``. :class:`LocalTransport`
is a same-process queue between the two engines' loops (threads): the
testing and single-host shape, and the one ``DisaggEngine`` builds by
default. The frame crosses as host bytes, so no tensor is shared
between the two loops' CUDA streams.

Not ported yet: ``HostCommTransport``, the frame pipe between two OS
processes over the native host comm group (it needs the port's host
comm, ROADMAP.md Queue A item 5), and the fault-injection hooks of
``send`` / ``recv`` (item 6).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ...utils.profiler import CommStats


class TransportSevered(RuntimeError):
    """The handoff channel is gone (peer death, abort). Internal signal:
    the engine layer converts it into the typed ``HandoffError``
    vocabulary with request and engine attribution
    (``serve/disagg/router.py``); it never reaches a caller raw."""


class LocalTransport:
    """Same-process frame queue between the prefill and decode loops."""

    #: recv(0) is a true non-blocking poll: the decode loop may drain the
    #: transport between tokens (what ``DisaggEngine`` requires).
    pollable = True

    def __init__(self):
        self._q: "queue.Queue[bytes]" = queue.Queue()
        self._severed = threading.Event()
        self.stats = CommStats()
        self.frames_sent = 0
        self.frames_recv = 0

    def send(self, frame: bytes, kv_bytes: int) -> None:
        """Enqueue one encoded frame, booking its KV wire bytes under
        ``handoff_send``."""
        if self._severed.is_set():
            raise TransportSevered("handoff transport severed")
        with self.stats.timed("handoff_send", kv_bytes):
            self._q.put(frame)
        self.frames_sent += 1

    def recv(self, timeout_s: float = 0.0) -> Optional[bytes]:
        """One frame, or None when nothing arrives within ``timeout_s``
        (0: a non-blocking poll). Raises :class:`TransportSevered` once
        the channel is severed and drained: frames already in flight are
        still delivered, like bytes buffered in a socket."""
        try:
            frame = self._q.get(timeout=timeout_s) if timeout_s > 0 \
                else self._q.get_nowait()
        except queue.Empty:
            if self._severed.is_set():
                raise TransportSevered(
                    "handoff transport severed") from None
            return None
        self.frames_recv += 1
        return frame

    def abort(self) -> None:
        """Sever the channel now (engine teardown): senders fail at once,
        receivers after draining what was already in flight."""
        self._severed.set()

    @property
    def severed(self) -> bool:
        return self._severed.is_set()
