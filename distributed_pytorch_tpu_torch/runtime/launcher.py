"""``launch``, the entry point of a run (reference ``distributed.py:32-58``).

Counterpart of ``distributed_pytorch_tpu/runtime/launcher.py:38-71``,
with the reference's three branches on the number of visible cards:

* ``world > 1``: one process per card through
  :func:`~.multiprocess.launch_multiprocess`; rank r owns ``cuda:r``;
* ``world == 1``: ``worker_fn(0, 1, *args)`` in this process, no group;
* ``world == 0`` (no card): ``worker_fn(0, 0, *args)``, the reference's
  CPU branch; the worker then asks for the CPU explicitly.

Worker exceptions reach the caller in every branch.
"""

from __future__ import annotations

import socket
from contextlib import closing
from typing import Callable

from . import context


def launch(worker_fn: Callable, *args) -> None:
    """Run ``worker_fn(rank, world_size, *args)`` on the visible cards."""
    world_size = context.device_count()
    if world_size > 1:
        from .multiprocess import launch_multiprocess
        launch_multiprocess(worker_fn, world_size, *args)
    elif world_size == 1:
        worker_fn(0, 1, *args)
    else:
        worker_fn(0, 0, *args)


def _bindable(port: int) -> bool:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("", port))
        except OSError:
            return False
        return True


def find_free_port(span: int = 1) -> int:
    """A TCP port the kernel reports free (reference ``distributed.py:
    32-37``), for the group's rendezvous; with ``span`` > 1, the first
    of ``span`` consecutive free ports (a native host group's rank r
    listens on ``port + r``). The ports are released before the ranks
    bind them, so another process can take one in between: the
    rendezvous then fails and the run raises."""
    for _ in range(64):
        with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            port = s.getsockname()[1]
        if span == 1:
            return port
        if port + span <= 65536 and all(
                _bindable(p) for p in range(port, port + span)):
            return port
    raise RuntimeError(f"no {span} consecutive free TCP ports found")
