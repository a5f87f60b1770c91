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


def find_free_port() -> int:
    """A TCP port the kernel reports free (reference ``distributed.py:
    32-37``), for the group's rendezvous. The port is released before
    rank 0 binds it, so another process can take it in between: rank 0
    then fails with "address already in use" and the run raises."""
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]
