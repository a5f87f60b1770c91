"""Checkpoint manager: interval, retention and an async save.

Counterpart of ``distributed_pytorch_tpu/ckpt/manager.py`` for the
single-file format (``sharded=False``). A save is staged in three parts:

1. **snapshot (control thread, synchronous)**: the model's parameters
   and the optimizer state are copied to fresh host tensors in the JAX
   layout (``utils.checkpoint.jax_params`` / ``jax_opt_state``) before
   ``save()`` returns. The port updates parameters in place, so the
   next step may overwrite them at once: nothing of the device state is
   kept.
2. **serialize and write (IO thread with ``async_save``)**: file IO
   only, no collective.
3. **commit (control thread, deferred)**: at the next ``save()`` or
   ``wait()``: barrier, the primary renames the staged directory into
   place and applies retention, barrier.

The primary writes and every rank reads; ``save()``, ``wait()`` and
``restore_latest()`` are collective calls that every rank makes in the
same order. ``sharded=True`` raises ``NotImplementedError`` (ROADMAP.md
Queue A item 5); the trace spans and fault marks of the JAX manager
wait for the observability slice (Queue A item 6).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .errors import CkptError


class _Pending:
    """One staged save awaiting commit."""

    def __init__(self, step: int, tmp: str, extra):
        self.step = step
        self.tmp = tmp
        self.extra = extra
        self.io_stats: Dict[str, Any] = {}


class CheckpointManager:
    """Save every ``interval`` steps, keep the newest ``keep``; with
    ``async_save`` the write runs on a background thread and the commit
    waits for the next ``save()``/``wait()``. Call ``wait()`` (or leave
    the context manager) before reading the checkpoint back or exiting.
    """

    def __init__(self, ckpt_dir: str, interval: int = 1,
                 keep: Optional[int] = 3, async_save: bool = False,
                 sharded: bool = False):
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if sharded:
            raise NotImplementedError(
                "sharded=True (format 2: every rank writes the shards it "
                "owns) is not ported yet (ROADMAP.md Queue A item 5)")
        self.ckpt_dir = ckpt_dir
        self.interval = max(int(interval), 1)
        self.keep = keep
        self.async_save = async_save
        self.sharded = False
        self._ctl_thread = threading.current_thread()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[_Pending] = None
        self._save_seq = 0
        #: per committed save: step, snapshot_s (the control thread's
        #: host copy), duration_s (the write), bytes
        self.saves: List[Dict[str, Any]] = []

    def _topo(self):
        from ..runtime import context
        return context.get_rank(), context.get_world_size()

    def _barrier(self) -> None:
        if threading.current_thread() is not self._ctl_thread:
            raise CkptError(
                "checkpoint collective (barrier) attempted off the "
                "manager's control thread — async IO threads must never "
                "run collectives", rank=self._topo()[0])
        from ..comm.collectives import barrier
        barrier()

    def should_save(self, step: int) -> bool:
        return step % self.interval == 0

    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict[str, Any]] = None, force: bool = False
             ) -> bool:
        """Stage a save if the policy says so (or ``force``); returns
        True iff staged. ``params``: the model, or a JAX-layout tree.
        Sync mode commits before returning; async mode returns after
        the host snapshot."""
        if not force and not self.should_save(step):
            return False
        self._finish_pending()
        json.dumps(extra or {})  # reject unserializable extras up front
        rank, _ = self._topo()
        t0 = time.perf_counter()
        job = None
        if rank == 0:
            from ..utils.checkpoint import _as_tree
            p_tree, o_tree = _as_tree(params, opt_state)

            def job():
                return self._io_full(tmp, step, p_tree, o_tree, extra)
        tmp = self._prepare_tmp(step, rank)
        pend = _Pending(step, tmp, extra)
        pend.io_stats["snapshot_s"] = time.perf_counter() - t0
        self._pending = pend
        if job is not None:
            if self.async_save:
                self._thread = threading.Thread(
                    target=self._run_io, args=(job, pend),
                    name="ckpt-io", daemon=True)
                self._thread.start()
            else:
                self._run_io(job, pend)
        if not self.async_save:
            self._finish_pending()
        return True

    def _prepare_tmp(self, step: int, rank: int) -> str:
        from ..utils import checkpoint as _ck
        self._save_seq += 1
        tmp = _ck._step_dir(self.ckpt_dir, step) + f".tmp.{self._save_seq}"
        if rank == 0:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            _ck._sweep_stale(self.ckpt_dir, keep_old_for=step)
            os.makedirs(tmp, exist_ok=True)
        self._barrier()
        return tmp

    def _run_io(self, job, pend: _Pending) -> None:
        try:
            pend.io_stats.update(job() or {})
        except BaseException as e:  # noqa: BLE001 — raised on the control thread
            self._error = e

    def _io_full(self, tmp: str, step: int, params, opt_state, extra
                 ) -> Dict[str, Any]:
        from ..utils import checkpoint as _ck
        t0 = time.perf_counter()
        nbytes = _ck._write_full(tmp, step, params, opt_state, extra)
        return {"bytes": nbytes, "shards": 1,
                "duration_s": time.perf_counter() - t0}

    def _join_io(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self._pending = None  # a failed write must never commit
            raise err

    def _finish_pending(self) -> None:
        self._join_io()
        if self._pending is None:
            return
        pend, self._pending = self._pending, None
        rank, world = self._topo()
        self._barrier()  # the primary's files are durable
        if rank == 0:
            from ..utils import checkpoint as _ck
            from ..utils.logging import append_event
            _ck._commit_full(self.ckpt_dir, pend.step, pend.tmp,
                             keep=self.keep)
            self.saves.append(dict(pend.io_stats, step=pend.step))
            append_event(
                "ckpt_save", step=pend.step, rank=rank, world=world,
                sharded=False, async_save=self.async_save,
                bytes=pend.io_stats.get("bytes"),
                shards=pend.io_stats.get("shards"),
                io_s=round(pend.io_stats.get("duration_s", 0.0), 6),
                snapshot_s=round(pend.io_stats.get("snapshot_s", 0.0), 6))
        self._barrier()  # the commit is visible on every rank

    def wait(self) -> None:
        """Join in-flight IO and commit the pending step (collective)."""
        self._finish_pending()

    def restore_latest(self, like_params=None, like_opt_state=None):
        """The latest checkpoint, or None when the directory is empty."""
        from ..utils import checkpoint as _ck
        self.wait()
        if _ck.latest_step(self.ckpt_dir) is None:
            return None
        return _ck.restore_checkpoint(self.ckpt_dir,
                                      like_params=like_params,
                                      like_opt_state=like_opt_state)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False
