"""One OS process per rank: the ``mp.spawn`` of the reference.

Counterpart of ``distributed_pytorch_tpu/runtime/multiprocess.py:87-169``.
``launch_multiprocess`` spawns ``worker_fn(rank, nprocs, *args)`` in
``nprocs`` processes, each told where to rendezvous (``DPX_MASTER_ADDR``,
``DPX_MASTER_PORT``, a free port) and what it owns
(``DPX_MULTIPROC_ACCEL``): by default rank r owns ``cuda:r`` and the
group speaks NCCL, which runs no two ranks on one device; with
``device="cpu"`` the ranks hold CPU tensors and speak gloo. With
``backend="host"`` (or ``DPX_BACKEND=host`` in the parent) the ranks make
the native TCP group of ``native/dpxhost.cpp`` instead, on the same
devices. Like ``join=True`` (reference
``distributed.py:51-52``), the first failing rank's traceback is raised
in the parent, and the other ranks are terminated rather than left
blocked in a collective; a rank's typed comm failure reaches the parent
with its op and the peer it blames.

A failing rank leaves deterministically with exit code 1: its traceback
goes on the queue (and to stderr), its group is torn down while the
interpreter is still whole (a host group's links aborted, so its peers
fail typed at once), the queue is flushed, and the process ends with
``os._exit(1)`` (a ``SystemExit`` keeps its code, and one of 0 or
``None`` is a clean exit, with nothing queued). Each rank carries the
launch's tag in ``DPX_WORKER_TAG`` (``<launcher pid>-<us>``) for
``watchdog.kill_orphan_workers``. Re-raising instead
would leave the teardown of a live gloo group to interpreter
finalization, which can abort the process (SIGABRT) in place of exit 1.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time
import traceback
from typing import Callable, Optional

import torch

from . import context
from . import env as _env
from .launcher import find_free_port
from .watchdog import (WORKER_TAG_ENV, ProcessSupervisor, WorkerFailure,
                       register_active_tag, unregister_active_tag)


def _failure_meta(exc: BaseException) -> Optional[dict]:
    """The attribution of a typed comm failure, else ``None``."""
    from .native import CommError
    if isinstance(exc, CommError):
        return {"kind": type(exc).__name__, "op": exc.op, "peer": exc.peer}
    return None


#: characters of a traceback a failing rank queues for the parent (its
#: stderr gets all of it): a report must fit the pipe with room for the
#: other ranks', or its writer blocks until the parent reads
REPORT_CHARS = 8192


def _bounded(tb: str) -> str:
    """``tb`` cut to :data:`REPORT_CHARS`: its head and its tail (where
    the exception is) around a note of what was cut."""
    if len(tb) <= REPORT_CHARS:
        return tb
    head, tail = REPORT_CHARS // 4, REPORT_CHARS * 3 // 4
    return (f"{tb[:head]}\n[... {len(tb) - head - tail} characters cut; "
            f"the rank's stderr has them ...]\n{tb[-tail:]}")


def _worker_shim(rank: int, world_size: int, rank_env: dict,
                 worker_fn: Callable, args: tuple, err_q) -> None:
    try:
        for name, value in rank_env.items():
            _env.set(name, value)
        worker_fn(rank, world_size, *args)
    except BaseException as exc:
        if isinstance(exc, SystemExit) and exc.code in (0, None):
            code = 0                  # a rank that ends on purpose
        else:
            tb = traceback.format_exc()
            err_q.put((rank, _bounded(tb), _failure_meta(exc)))
            sys.stderr.write(tb)
            code = exc.code if isinstance(exc, SystemExit) and isinstance(
                exc.code, int) else 1
        try:
            context.abort_process_group()
        finally:
            err_q.close()
            err_q.join_thread()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
    if context.is_initialized():
        context.destroy_process_group()


def launch_multiprocess(worker_fn: Callable, nprocs: int, *args,
                        device: Optional[str] = None,
                        timeout_s: Optional[float] = None,
                        backend: Optional[str] = None) -> None:
    """Run ``worker_fn(rank, nprocs, *args)`` in ``nprocs`` processes.

    ``worker_fn`` and ``args`` are pickled (``spawn``), so the function
    is a module-level one. ``device``: ``None`` or ``"cuda"`` gives rank
    r ``cuda:r`` and needs ``nprocs`` visible cards; ``"cpu"`` makes CPU
    ranks over gloo. ``backend``: ``None`` reads ``DPX_BACKEND``;
    ``"host"`` makes the native group on the same devices and passes
    ``DPX_BACKEND=host`` on to the ranks. ``timeout_s`` bounds the
    whole run: past it every rank is terminated and
    :class:`WorkerFailure` raised, as on the first abnormal exit."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if backend is None:
        backend = _env.get("DPX_BACKEND")
    if backend not in (None, "", "host"):
        raise ValueError(f"backend must be None or 'host', got {backend!r}")
    host = backend == "host"
    accel = "cuda" if device is None else torch.device(device).type
    if accel not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if accel == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(
            f"{nprocs} ranks need {nprocs} CUDA devices, one each (NCCL "
            f"runs no two ranks on one device); "
            f"{torch.cuda.device_count()} visible: pass device='cpu' for "
            "CPU ranks over gloo")
    rank_env = {"DPX_MULTIPROC_ACCEL": accel, "DPX_MASTER_ADDR": "127.0.0.1",
                # a host group takes base + rank and the hierarchical
                # ring's sub-groups the ports past them (comm/hier.py)
                "DPX_MASTER_PORT": (find_free_port(3 * nprocs + 2) if host
                                    else find_free_port()),
                "DPX_BACKEND": "host" if host else ""}
    # the launch's tag, in each rank's environment from its first
    # instruction on: kill_orphan_workers finds the ranks of a launcher
    # that died by it, and spares this launch while it lives
    tag = f"{os.getpid()}-{int(time.time() * 1e6)}"
    child_env = {WORKER_TAG_ENV: tag}
    ctx = mp.get_context("spawn")
    err_q = ctx.Queue()
    procs = []
    register_active_tag(tag)
    try:
        try:
            for rank in range(nprocs):
                saved = _env.snapshot(child_env)
                try:
                    _env.apply_overrides(child_env)
                    p = ctx.Process(target=_worker_shim,
                                    args=(rank, nprocs, rank_env, worker_fn,
                                          args, err_q), daemon=False)
                    p.start()
                    procs.append(p)
                finally:
                    _env.restore(saved)
        except BaseException:
            # ranks already started must not wait for peers that never
            # came
            ProcessSupervisor(procs, err_q).terminate_all()
            raise
        try:
            ProcessSupervisor(procs, err_q).join(timeout_s)
        except WorkerFailure as e:
            from ..utils.logging import append_event
            append_event("worker_failure", rank=e.rank, exitcode=e.exitcode,
                         world=nprocs, op=e.op, kind=e.kind)
            # flight recorder (obs/trace.py): spans this supervisor
            # traced ship with the failure; a no-op when its ring is
            # empty (each rank process ships its own from its typed
            # error path)
            from ..obs import trace as _dpxtrace
            _dpxtrace.on_typed_failure(e)
            raise
    finally:
        unregister_active_tag(tag)
