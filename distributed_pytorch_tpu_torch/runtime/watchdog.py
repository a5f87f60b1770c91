"""Fail-fast supervision of rank processes.

Counterpart of ``distributed_pytorch_tpu/runtime/watchdog.py:39-214``
(``WorkerFailure``, ``ProcessSupervisor``). The reference's failure story
is manual: a crashed rank leaves its peers blocked in a collective until
someone kills them by hand (reference ``README.md:121-125``). Here the
first abnormal exit ends the run: the surviving ranks are terminated
after a grace period and the parent raises :class:`WorkerFailure` with
the failing rank's traceback. A join may also carry a deadline, after
which every rank still running is terminated.
"""

from __future__ import annotations

import queue as _queue
import time
from typing import List, Optional, Sequence

_POLL_S = 0.05
# survivors of a failure report their own errors within this window (a
# peer's closed connection fails their collective) before the sweep
_SETTLE_S = 5.0


class WorkerFailure(RuntimeError):
    """A rank process exited abnormally, or the join's deadline passed.

    ``rank`` is the first rank that reported an exception (``None`` when
    none did, e.g. a hard kill), or on a deadline the lowest rank still
    running; when ranks of a host group reported typed comm failures
    blaming a peer that never reported itself (it died without a word),
    ``rank`` is that peer. ``op`` and ``kind`` name the collective in
    flight and the ``CommError`` subclass the ranks raised (``None`` for
    other failures); ``exitcode`` is the first abnormal exit code
    (``None`` on a deadline)."""

    def __init__(self, msg: str, *, rank: Optional[int] = None,
                 exitcode: Optional[int] = None, op: Optional[str] = None,
                 kind: Optional[str] = None):
        super().__init__(msg)
        self.rank = rank
        self.exitcode = exitcode
        self.op = op
        self.kind = kind


class ProcessSupervisor:
    """Fail-fast join over a set of rank processes.

    ``err_q`` receives ``(rank, traceback, meta)`` from every rank that
    raised, ``meta`` the ``{"kind", "op", "peer"}`` of a typed comm
    failure or ``None``.
    After a failure the survivors get a few seconds to report their own
    errors, then the sweep: SIGTERM, and SIGKILL after ``grace_s``."""

    def __init__(self, procs: Sequence, err_q=None, grace_s: float = 5.0):
        self.procs = list(procs)
        self.err_q = err_q
        self.grace_s = grace_s
        self._reports: List = []    # what the ranks queued, in order

    def _first_failure(self) -> Optional[int]:
        for p in self.procs:
            if p.exitcode is not None and p.exitcode != 0:
                return p.exitcode
        return None

    def _collect_ready(self) -> None:
        """Read the reports already queued, while their writers live: a
        rank blocked writing a report into a full pipe is never
        terminated mid-write, which would leave the supervisor waiting
        on the rest of the message."""
        if self.err_q is None:
            return
        while True:
            try:
                self._reports.append(self.err_q.get_nowait())
            except _queue.Empty:
                return

    def _drain_errors(self) -> List:
        if self.err_q is not None:
            while True:
                # a bounded get: a report a dying child never finished
                # writing cannot hang the supervisor
                try:
                    self._reports.append(self.err_q.get(timeout=0.25))
                except _queue.Empty:
                    break
        return list(self._reports)

    def terminate_all(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + self.grace_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(self.grace_s)

    def join(self, timeout_s: Optional[float] = None) -> None:
        """Block until every rank exits; raise :class:`WorkerFailure` on
        the first abnormal exit, or when ``timeout_s`` passes first
        (after terminating the ranks still running)."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while any(p.exitcode is None for p in self.procs):
            self._collect_ready()
            if self._first_failure() is not None:
                break
            if deadline is not None and time.monotonic() > deadline:
                running = [r for r, p in enumerate(self.procs)
                           if p.exitcode is None]
                self.terminate_all()
                reports = "".join(f"\nrank {r}:\n{tb}"
                                  for r, tb, _ in self._drain_errors())
                raise WorkerFailure(
                    f"ranks {running} still running after {timeout_s} s; "
                    f"all ranks were terminated{reports}", rank=running[0])
            time.sleep(_POLL_S)

        code = self._first_failure()
        if code is None:
            return
        settle = time.monotonic() + _SETTLE_S
        while (time.monotonic() < settle
               and any(p.exitcode is None for p in self.procs)):
            self._collect_ready()
            time.sleep(_POLL_S)
        self.terminate_all()
        failures = self._drain_errors()
        if failures:
            rank, tb, _ = failures[0]
            metas = [(r, m) for r, _, m in failures if m]
            op = next((m["op"] for _, m in metas if m.get("op")), None)
            kind = next((m["kind"] for _, m in metas), None)
            reporters = {r for r, _, _ in failures}
            silent = sorted({m["peer"] for _, m in metas
                             if m.get("peer", -1) >= 0} - reporters)
            if silent:
                raise WorkerFailure(
                    f"worker rank {silent[0]} died during op {op!r} ({kind} "
                    f"reported by ranks {sorted(r for r, _ in metas)}); "
                    f"first report (rank {rank}):\n{tb}", rank=silent[0],
                    exitcode=code, op=op, kind=kind)
            raise WorkerFailure(f"worker process (rank {rank}) failed:\n{tb}",
                                rank=rank, exitcode=code, op=op, kind=kind)
        raise WorkerFailure(
            f"worker process exited abnormally (exit code {code}); "
            "remaining workers were terminated", exitcode=code)
