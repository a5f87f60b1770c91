"""Checkpoint manager: interval, retention and an async save.

Counterpart of ``distributed_pytorch_tpu/ckpt/manager.py``. A save is
staged in three parts:

1. **snapshot (control thread, synchronous)**: what the save writes is
   copied to fresh host tensors before ``save()`` returns. The port
   updates parameters in place, so the next step may overwrite them at
   once: nothing of the device state is kept.
2. **serialize and write (IO thread with ``async_save``)**: file IO
   only, no collective; a barrier attempted off the control thread is a
   typed :class:`~.errors.CkptError`.
3. **commit (control thread, deferred)**: at the next ``save()`` or
   ``wait()``: barrier, the committing rank merges and renames the
   staged directory into place and applies retention, barrier. A write
   that failed raises there and is never committed.

``sharded=False`` writes the single-file format 1
(``utils/checkpoint.py``): the primary writes the model and its state in
the JAX layout. ``sharded=True`` writes format 2 (``ckpt/writer.py``):
every rank is a writer and writes only the shards it owns under
``param_specs`` / ``opt_specs`` (spec trees of the JAX layout, from
``parallel.fsdp.shard_layouts`` or a front-door step's ``state_specs``)
on a mesh of ``axis_sizes``; its snapshot copies this rank's owned
pieces alone from the device (a ZeRO-3 parameter's local shard, never
the whole parameter). ``save()``, ``wait()`` and ``restore_latest()``
are collective calls that every rank makes in the same order. The trace
spans and fault marks of the JAX manager wait for the observability
slice (Queue A item 6).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from . import writer as _writer
from .errors import CkptError
from .reader import ReadStats, Target  # noqa: F401  (re-exported)


#: Phase trace: (phase, thread name) of the recent save phases, so a
#: test can pin which thread ran each; bounded.
_trace: Deque[Tuple[str, str]] = collections.deque(maxlen=256)
_trace_lock = threading.Lock()


def trace_log() -> List[Tuple[str, str]]:
    """Recent phases executed: ('d2h'|'io'|'barrier'|'commit', thread)."""
    return list(_trace)


def clear_trace() -> None:
    with _trace_lock:
        _trace.clear()


def _mark(phase: str) -> None:
    with _trace_lock:
        _trace.append((phase, threading.current_thread().name))


class _Pending:
    """One staged save awaiting commit."""

    def __init__(self, step: int, tmp: str, plan, extra):
        self.step = step
        self.tmp = tmp
        self.plan = plan          # sharded: the writer's plan
        self.extra = extra
        self.io_stats: Dict[str, Any] = {}


class CheckpointManager:
    """Save every ``interval`` steps, keep the newest ``keep``; with
    ``async_save`` the write runs on a background thread and the commit
    waits for the next ``save()``/``wait()``. ``sharded=True`` for the
    every-rank-writes-its-shards format driven by ``param_specs``. Call
    ``wait()`` (or leave the context manager) before reading the
    checkpoint back or exiting.
    """

    def __init__(self, ckpt_dir: str, interval: int = 1,
                 keep: Optional[int] = 3, async_save: bool = False,
                 sharded: bool = False, param_specs: Any = None,
                 opt_specs: Any = None,
                 axis_sizes: Optional[Dict[str, int]] = None):
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if sharded and param_specs is None:
            raise ValueError("sharded=True needs param_specs (the spec "
                             "tree from parallel/)")
        self.ckpt_dir = ckpt_dir
        self.interval = max(int(interval), 1)
        self.keep = keep
        self.async_save = async_save
        self.sharded = sharded
        self.param_specs = param_specs
        self.opt_specs = opt_specs
        self.axis_sizes = axis_sizes
        self._ctl_thread = threading.current_thread()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[_Pending] = None
        self._save_seq = 0
        #: per committed save: step, snapshot_s (the control thread's
        #: host copy), duration_s (the write), bytes; sharded also
        #: shards and moved_bytes (pieces an owner did not hold)
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
        _mark("barrier")
        from ..comm.collectives import barrier
        barrier()

    def should_save(self, step: int) -> bool:
        return step % self.interval == 0

    def _resolved_axes(self) -> Dict[str, int]:
        if self.axis_sizes is not None:
            return dict(self.axis_sizes)
        from ..runtime import context
        return {"dp": context.get_world_size()}

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
        rank, world = self._topo()
        t0 = time.perf_counter()
        _mark("d2h")
        job, plan = None, None
        if self.sharded:
            plan = self._plan(params, opt_state, world)
        elif rank == 0:
            from ..utils.checkpoint import _as_tree
            p_tree, o_tree = _as_tree(params, opt_state)

            def job():
                return self._io_full(tmp, step, p_tree, o_tree, extra)
        tmp = self._prepare_tmp(step, rank)
        pend = _Pending(step, tmp, plan, extra)
        if self.sharded:
            pend.io_stats.update(_writer.snapshot_owned(plan, rank, world))

            def job():
                return self._io_sharded(tmp, rank, plan)
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

    def _plan(self, params, opt_state, world):
        """The writer's plan of the JAX-layout trees (live tensors,
        nothing copied yet)."""
        from ..utils import checkpoint as _ck
        if isinstance(params, torch.nn.Module):
            model = params
            p_tree = _ck.jax_params(model, lambda t: t)
            o_tree = (_ck.jax_opt_state(opt_state, model, lambda t: t)
                      if opt_state is not None else None)
        else:
            model, p_tree, o_tree = None, params, opt_state
        specs: Dict[str, Any] = {"params": self.param_specs}
        trees: Dict[str, Any] = {"params": p_tree}
        if o_tree is not None:
            o_specs = self.opt_specs
            if o_specs is None:
                o_specs = jax_opt_state_specs(o_tree, self.param_specs,
                                              p_tree)
            elif model is not None:
                o_specs = _jax_layout_specs(o_specs, model)
            specs["opt_state"] = o_specs
            trees["opt_state"] = o_tree
        return _writer.plan_trees(trees, specs, self._resolved_axes(),
                                  world)

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
        _mark("io")
        try:
            pend.io_stats.update(job() or {})
        except BaseException as e:  # noqa: BLE001 — raised on the control thread
            self._error = e

    def _io_sharded(self, tmp: str, rank: int, plan) -> Dict[str, Any]:
        stats = _writer.write_shards(tmp, rank, plan)
        for meta in plan.values():
            meta["pieces"] = None  # commit needs layouts only; free now
        return stats

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
        self._barrier()  # every writer's files are durable
        if rank == 0:
            from ..utils import checkpoint as _ck
            from ..utils.logging import append_event
            _mark("commit")
            if self.sharded:
                _writer.commit(self.ckpt_dir, pend.step, pend.tmp,
                               pend.plan, pend.extra, self._resolved_axes(),
                               world, keep=self.keep)
            else:
                _ck._commit_full(self.ckpt_dir, pend.step, pend.tmp,
                                 keep=self.keep)
            append_event(
                "ckpt_save", step=pend.step, rank=rank, world=world,
                sharded=self.sharded, async_save=self.async_save,
                bytes=pend.io_stats.get("bytes"),
                shards=pend.io_stats.get("shards"),
                io_s=round(pend.io_stats.get("duration_s", 0.0), 6),
                snapshot_s=round(pend.io_stats.get("snapshot_s", 0.0), 6))
        self.saves.append(dict(pend.io_stats, step=pend.step))
        self._barrier()  # the commit is visible on every rank

    def wait(self) -> None:
        """Join in-flight IO and commit the pending step (collective)."""
        self._finish_pending()

    def restore_latest(self, like_params=None, like_opt_state=None,
                       target=None):
        """The latest checkpoint, or None when the directory is empty."""
        from ..utils import checkpoint as _ck
        self.wait()
        if _ck.latest_step(self.ckpt_dir) is None:
            return None
        return _ck.restore_checkpoint(self.ckpt_dir,
                                      like_params=like_params,
                                      like_opt_state=like_opt_state,
                                      target=target)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False


# ---------------------------------------------------------------------------
# Optimizer-state spec trees in the JAX layout
# ---------------------------------------------------------------------------

def _shape_of(x):
    import numpy as np
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def jax_opt_state_specs(o_tree, param_specs, p_tree):
    """The spec tree of a JAX-layout optimizer state (the JAX package's
    ``opt_state_specs`` with ``params``): a subtree with the params
    tree's keys and leaf shapes takes ``param_specs``, a NamedTuple
    recurses field by field, everything else replicates."""
    from ..parallel.tensor import P
    from ..utils import checkpoint as _ck
    p_keys, p_leaves, _ = _ck._flatten(p_tree)
    p_shapes = [_shape_of(x) for x in p_leaves]

    def conv(node):
        keys, leaves, _ = _ck._flatten(node)
        if keys == p_keys and [_shape_of(x) for x in leaves] == p_shapes:
            return param_specs
        if _ck._is_namedtuple(node):
            return type(node)(*(conv(v) for v in node))
        return _ck._map_with_keys(node, lambda _, __: P())

    return conv(o_tree)


def _jax_layout_specs(o_specs, model):
    """A port-structured optimizer spec tree (``parallel.fsdp
    .opt_state_specs``: per-parameter lists of specs) in the JAX layout
    (each list as the JAX param tree, through ``convert
    .jax_param_slots``); a tree already in the JAX layout passes."""
    from ..convert import jax_param_slots
    from ..parallel.tensor import P
    from ..utils import checkpoint as _ck
    tree = jax_param_slots(model)
    n = len(list(model.parameters()))

    def conv(node):
        if isinstance(node, list) and len(node) == n and all(
                isinstance(x, P) for x in node):
            return _ck._map_with_keys(tree, lambda _, s: node[s.index])
        if _ck._is_namedtuple(node):
            return type(node)(*(conv(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node

    return conv(o_specs)
