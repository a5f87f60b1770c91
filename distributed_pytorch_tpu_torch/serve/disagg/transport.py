"""Handoff transports: how encoded frames travel prefill -> decode.

The port's copy of ``distributed_pytorch_tpu/serve/disagg/transport.py``.
A transport is ``send`` / ``recv`` / ``abort`` plus a ``CommStats`` that
books the KV wire bytes under ``handoff_send``. :class:`LocalTransport`
is a same-process queue between the two engines' loops (threads): the
testing and single-host shape, and the one ``DisaggEngine`` builds by
default. The frame crosses as host bytes, so no tensor is shared
between the two loops' CUDA streams.

:class:`HostCommTransport` is the frame pipe between two OS processes
over a 2-rank native host group (``runtime/native.py`` ``HostComm``).

Both transports fire the fault ops ``handoff_send`` / ``handoff_recv``
(``runtime/faults.py``), only when a fault is armed, inside
``chaos.call_with_retry``: no byte is in flight at the hook, so a
``flaky`` fault is retried with a ``comm_retry`` event per retry, and a
``drop_conn`` severs this transport.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from ...runtime import chaos as _chaos
from ...runtime import faults
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
        if faults.armed():
            _chaos.call_with_retry(
                lambda: faults.on_comm_op("handoff_send", comm=self),
                op="handoff_send")
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
        # the frame is already in hand: retrying the hook alone is safe
        if faults.armed():
            _chaos.call_with_retry(
                lambda: faults.on_comm_op("handoff_recv", comm=self),
                op="handoff_recv")
        self.frames_recv += 1
        return frame

    def abort(self) -> None:
        """Sever the channel now (engine teardown): senders fail at once,
        receivers after draining what was already in flight."""
        self._severed.set()

    @property
    def severed(self) -> bool:
        return self._severed.is_set()


class HostCommTransport:
    """Frame pipe over a 2-rank :class:`~...runtime.native.HostComm`:
    the prefill process is rank ``src``, and a frame travels as a length
    broadcast followed by the payload broadcast. A receive blocks under
    the native per-op deadline (``DPX_COMM_TIMEOUT_MS``), so a wedged or
    dead peer becomes a typed failure, never a hang: the channel raises
    :class:`TransportSevered` with the comm's ``CommPeerDied`` /
    ``CommTimeout`` as ``__cause__``, or, while :meth:`expect` names the
    request waiting, a deadline raises the request-attributed
    ``HandoffTimeout``.

    It is the cross-process handoff protocol, driven from each rank
    process's own loop. It is not pollable (a broadcast cannot return
    "nothing yet"), so ``DisaggEngine`` refuses it at construction; a
    receiver thread feeding a local queue is the way to plug it into the
    engine."""

    pollable = False

    def __init__(self, comm, src: int = 0):
        if comm.world != 2:
            raise ValueError(
                f"HostCommTransport needs a 2-rank group (prefill + "
                f"decode), got world={comm.world}")
        self.comm = comm
        self.src = src
        self.stats = CommStats()
        self.frames_sent = 0
        self.frames_recv = 0
        self._expected: Optional[int] = None

    def expect(self, request_id: Optional[int]) -> None:
        """Name the request the next :meth:`recv` waits for: its
        deadline then raises ``HandoffTimeout(request_id=...)`` instead
        of a bare :class:`TransportSevered`. ``None`` clears it."""
        self._expected = request_id

    def send(self, frame: bytes, kv_bytes: int) -> None:
        """Send one encoded frame (from rank ``src``), booking its KV
        wire bytes under ``handoff_send``."""
        from ...runtime.native import CommError
        if faults.armed():
            _chaos.call_with_retry(
                lambda: faults.on_comm_op("handoff_send",
                                          rank=self.comm.rank, comm=self),
                op="handoff_send", rank=self.comm.rank)
        try:
            with self.stats.timed("handoff_send", kv_bytes):
                self.comm.broadcast(np.array([len(frame)], np.int64),
                                    src=self.src)
                self.comm.broadcast(np.frombuffer(frame, np.uint8).copy(),
                                    src=self.src)
        except CommError as e:
            raise TransportSevered(f"handoff send failed: {e}") from e
        self.frames_sent += 1

    def recv(self, timeout_s: float = 0.0) -> Optional[bytes]:
        """Receive one frame, blocking (``timeout_s`` is accepted for
        the transport interface; the native deadline governs)."""
        from ...runtime.native import CommError, CommTimeout
        if faults.armed():
            _chaos.call_with_retry(
                lambda: faults.on_comm_op("handoff_recv",
                                          rank=self.comm.rank, comm=self),
                op="handoff_recv", rank=self.comm.rank)
        hdr = np.zeros(1, np.int64)
        try:
            self.comm.broadcast(hdr, src=self.src)
            buf = np.zeros(int(hdr[0]), np.uint8)
            self.comm.broadcast(buf, src=self.src)
        except CommError as e:
            if isinstance(e, CommTimeout) and self._expected is not None:
                from ..types import HandoffTimeout
                raise HandoffTimeout(
                    f"request {self._expected}: no handoff frame within "
                    f"the comm deadline ({e.deadline_ms} ms) on the "
                    f"cross-process transport",
                    request_id=self._expected,
                    deadline_ms=float(e.deadline_ms),
                    engine="transport",
                    iteration=self.frames_recv) from e
            raise TransportSevered(f"handoff recv failed: {e}") from e
        self._expected = None
        self.frames_recv += 1
        return buf.tobytes()

    def abort(self) -> None:
        """Tear the comm's links down: the peer fails typed at once."""
        self.comm.abort()

    @property
    def severed(self) -> bool:
        return False
