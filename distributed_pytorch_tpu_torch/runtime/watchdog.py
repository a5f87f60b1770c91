"""Failure detection for rank processes.

Counterpart of ``distributed_pytorch_tpu/runtime/watchdog.py``. The
reference's failure story is manual: a crashed rank leaves its peers
blocked in a collective until someone kills them by hand, and its
leftover workers are found with ``ps`` (reference
``README.md:121-125``). Here:

- :class:`ProcessSupervisor`: the first abnormal exit ends the run; the
  surviving ranks are terminated after a grace period and the parent
  raises :class:`WorkerFailure` with the failing rank's traceback. A
  join may carry a deadline, after which every rank still running is
  terminated.
- :class:`Heartbeat` / :class:`HeartbeatMonitor`: each rank stamps a
  file per step; the monitor names the ranks whose stamp went stale (a
  wedged collective, a stalled host), which liveness alone cannot see.
- :func:`kill_orphan_workers`: every rank carries its launch's tag in
  ``DPX_WORKER_TAG``; the killer finds the tagged processes of launches
  whose launcher is gone, through ``/proc``, and terminates them.
"""

from __future__ import annotations

import os
import queue as _queue
import signal
import time
from typing import Dict, List, Optional, Sequence

WORKER_TAG_ENV = "DPX_WORKER_TAG"

# Launch tags of the multiprocess runs in flight in this process
# (registered by launch_multiprocess): kill_orphan_workers spares them by
# default. A caller in another process passes ``tag`` / ``exclude_tag``.
_ACTIVE_TAGS: set = set()


def register_active_tag(tag: str) -> None:
    _ACTIVE_TAGS.add(tag)


def unregister_active_tag(tag: str) -> None:
    _ACTIVE_TAGS.discard(tag)


def active_tags() -> frozenset:
    """Launch tags of the runs in flight that this process owns."""
    return frozenset(_ACTIVE_TAGS)

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


# ---------------------------------------------------------------------------
# progress heartbeats
# ---------------------------------------------------------------------------


class StalledWorker(RuntimeError):
    """One or more ranks stopped emitting progress beacons."""


class Heartbeat:
    """Worker-side progress beacon: ``beat(step)`` atomically rewrites
    ``<dir>/rank<r>.hb`` with ``<timestamp> <step>``. Call it once per
    training step (cost: one tiny file rename)."""

    def __init__(self, directory: str, rank: int):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"rank{rank}.hb")
        self._tmp = self.path + ".tmp"

    def beat(self, step: int = 0) -> None:
        with open(self._tmp, "w") as f:
            f.write(f"{time.time()} {step}")
        os.replace(self._tmp, self.path)


class HeartbeatMonitor:
    """Launcher-side staleness check over a heartbeat directory.

    ``stalled(timeout_s)`` returns the ranks whose last beacon is older
    than ``timeout_s`` (ranks that never beat are only counted once they
    have had ``timeout_s`` since the monitor started, so slow-starting
    workers aren't false positives). ``assert_alive`` raises
    :class:`StalledWorker`."""

    def __init__(self, directory: str, world_size: int):
        self.directory = directory
        self.world_size = world_size
        self.start_time = time.time()

    def last_beats(self) -> Dict[int, float]:
        out = {}
        for rank in range(self.world_size):
            path = os.path.join(self.directory, f"rank{rank}.hb")
            try:
                with open(path) as f:
                    out[rank] = float(f.read().split()[0])
            except (OSError, ValueError, IndexError):
                pass
        return out

    def stalled(self, timeout_s: float) -> List[int]:
        now = time.time()
        beats = self.last_beats()
        out = []
        for rank in range(self.world_size):
            last = beats.get(rank, self.start_time)
            # wall stamps written by other processes' beat(): their
            # monotonic clocks do not align with this one
            if now - last > timeout_s:
                out.append(rank)
        return out

    def assert_alive(self, timeout_s: float) -> None:
        bad = self.stalled(timeout_s)
        if bad:
            raise StalledWorker(
                f"ranks {bad} have not emitted a heartbeat in {timeout_s}s")


# ---------------------------------------------------------------------------
# orphan cleanup
# ---------------------------------------------------------------------------


def _proc_environ(pid: int) -> Dict[str, str]:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    env = {}
    for entry in raw.split(b"\0"):
        if b"=" in entry:
            k, _, v = entry.partition(b"=")
            env[k.decode(errors="replace")] = v.decode(errors="replace")
    return env


def _launcher_pid(tag: str) -> Optional[int]:
    """Launch tags are ``<launcher_pid>-<microsecond timestamp>``
    (runtime/multiprocess.py); recover the launcher pid, or None for a
    foreign/unparseable tag."""
    head, _, _ = tag.partition("-")
    return int(head) if head.isdigit() else None


def find_tagged_workers(tag: Optional[str] = None,
                        exclude_tag: Optional[str] = None,
                        exclude_active: bool = True,
                        require_dead_launcher: bool = True) -> List[int]:
    """PIDs of live ORPHANED processes carrying ``DPX_WORKER_TAG`` in
    their environment — optionally only a specific ``tag``, always sparing
    the tags of runs this process currently has in flight unless
    ``exclude_active=False``. A worker only counts as orphaned when the
    launcher pid encoded in its tag is no longer alive — otherwise a
    cleanup call in one job would shoot down a concurrent job's live
    workers (``_ACTIVE_TAGS`` is per-process and cannot see them). Pass
    ``require_dead_launcher=False`` to force-match live runs too. Returns
    ``[]`` on platforms without ``/proc``."""
    excluded = set(_ACTIVE_TAGS) if exclude_active else set()
    if exclude_tag is not None:
        excluded.add(exclude_tag)
    pids = []
    me = os.getpid()
    try:
        entries = os.listdir("/proc")
    except OSError:
        return []
    for entry in entries:
        if not entry.isdigit() or int(entry) == me:
            continue
        env = _proc_environ(int(entry))
        t = env.get(WORKER_TAG_ENV)
        if t is None or t in excluded:
            continue
        if tag is not None and t != tag:
            continue
        if require_dead_launcher:
            lp = _launcher_pid(t)
            if lp is not None and lp != me and _alive(lp):
                continue  # launcher still running: not an orphan
        pids.append(int(entry))
    return pids


def kill_orphan_workers(tag: Optional[str] = None,
                        exclude_tag: Optional[str] = None,
                        exclude_active: bool = True,
                        require_dead_launcher: bool = True,
                        grace_s: float = 3.0) -> List[int]:
    """Terminate leftover tagged worker processes (SIGTERM, then SIGKILL
    after ``grace_s``). Returns the PIDs acted on. Runs launched by this
    process that are still in flight are spared by default, and so are
    workers whose launcher process (encoded in the tag) is still alive —
    concurrent jobs in other processes are not orphans. Pass
    ``require_dead_launcher=False`` to kill a live run by explicit tag.

    The reference's manual recovery (find the orphaned spawn workers with
    ``ps`` and kill them, ``README.md:121-125``) as one call."""
    pids = find_tagged_workers(tag=tag, exclude_tag=exclude_tag,
                               exclude_active=exclude_active,
                               require_dead_launcher=require_dead_launcher)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if not any(_alive(pid) for pid in pids):
            break
        time.sleep(0.05)
    for pid in pids:
        if _alive(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    return pids


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False
