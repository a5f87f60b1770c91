"""One OS process per rank: the ``mp.spawn`` of the reference.

Counterpart of ``distributed_pytorch_tpu/runtime/multiprocess.py:87-169``.
``launch_multiprocess`` spawns ``worker_fn(rank, nprocs, *args)`` in
``nprocs`` processes, each told where to rendezvous (``DPX_MASTER_ADDR``,
``DPX_MASTER_PORT``, a free port) and what it owns
(``DPX_MULTIPROC_ACCEL``): by default rank r owns ``cuda:r`` and the
group speaks NCCL, which runs no two ranks on one device; with
``device="cpu"`` the ranks hold CPU tensors and speak gloo. Like
``join=True`` (reference ``distributed.py:51-52``), the first failing
rank's traceback is raised in the parent, and the other ranks are
terminated rather than left blocked in a collective.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
from typing import Callable, Optional

import torch

from . import context
from . import env as _env
from .launcher import find_free_port
from .watchdog import ProcessSupervisor, WorkerFailure


def _worker_shim(rank: int, world_size: int, rank_env: dict,
                 worker_fn: Callable, args: tuple, err_q) -> None:
    try:
        for name, value in rank_env.items():
            _env.set(name, value)
        worker_fn(rank, world_size, *args)
    except BaseException:
        err_q.put((rank, traceback.format_exc()))
        raise
    if context.is_initialized():
        context.destroy_process_group()


def launch_multiprocess(worker_fn: Callable, nprocs: int, *args,
                        device: Optional[str] = None,
                        timeout_s: Optional[float] = None) -> None:
    """Run ``worker_fn(rank, nprocs, *args)`` in ``nprocs`` processes.

    ``worker_fn`` and ``args`` are pickled (``spawn``), so the function
    is a module-level one. ``device``: ``None`` or ``"cuda"`` gives rank
    r ``cuda:r`` and needs ``nprocs`` visible cards; ``"cpu"`` makes CPU
    ranks over gloo. ``timeout_s`` bounds the whole run: past it every
    rank is terminated and :class:`WorkerFailure` raised, as on the
    first abnormal exit."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
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
                "DPX_MASTER_PORT": find_free_port()}
    ctx = mp.get_context("spawn")
    err_q = ctx.Queue()
    procs = []
    try:
        for rank in range(nprocs):
            p = ctx.Process(target=_worker_shim,
                            args=(rank, nprocs, rank_env, worker_fn, args,
                                  err_q), daemon=False)
            p.start()
            procs.append(p)
    except BaseException:
        # ranks already started must not wait for peers that never came
        ProcessSupervisor(procs, err_q).terminate_all()
        raise
    try:
        ProcessSupervisor(procs, err_q).join(timeout_s)
    except WorkerFailure as e:
        from ..utils.logging import append_event
        append_event("worker_failure", rank=e.rank, exitcode=e.exitcode,
                     world=nprocs)
        raise
