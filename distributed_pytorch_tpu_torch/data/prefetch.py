"""Background-thread device prefetching for the input pipeline.

Counterpart of ``distributed_pytorch_tpu/data/prefetch.py``
(``device_prefetch``, ``PrefetchLoader``). A worker thread pulls the
next batches from the loader (which reads and collates them), and puts
them on a bounded queue already on their way to the device, so batch
assembly and the host-to-device copy overlap the running step.

On the card the worker pins each collated batch (page-locked host
memory), issues its copy on a ``torch.cuda.Stream`` of its own with
``non_blocking=True`` and records an event behind it. The consumer makes
its current stream wait on that event (the step's kernels then start
after the copy, without blocking the host) and calls ``record_stream``
so the caching allocator does not hand the batch's memory to another
tensor while the step still reads it. On the CPU the same code runs
with plain copies.

``close()`` stops the worker and drops the batches still queued; a
training loop that breaks out early calls it (the JAX example's
``--steps`` break). An exception in the worker is raised in the
consumer at the position where it happened.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Iterable

import torch

from ..runtime.context import map_tensors
from ..runtime.device import DeviceLike

_STOP = object()


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


class DevicePrefetcher:
    """Iterator over ``iterable``'s batches, ``size`` of them prefetched
    onto ``device``. ``host_s`` / ``batches``: the worker's wall seconds
    (loader read, collation, pinning, issuing the copy, and its waits
    for the interpreter lock) and the batches it made."""

    def __init__(self, iterable: Iterable, size: int,
                 device: torch.device):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.device = device
        self.host_s = 0.0
        self.batches = 0
        self._cuda = device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=device) if self._cuda
                        else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._closed = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._work,
                                        args=(iter(iterable),),
                                        name="dpx-prefetch", daemon=True)
        self._thread.start()

    # -- worker ------------------------------------------------------------

    def _put(self, item) -> bool:
        """A bounded put that gives up once the consumer has closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _place(self, batch):
        if not self._cuda:
            return map_tensors(lambda t: t.to(self.device), batch), None
        pinned = map_tensors(lambda t: t.pin_memory(), batch)
        with torch.cuda.stream(self._stream):
            dev = map_tensors(
                lambda t: t.to(self.device, non_blocking=True), pinned)
        event = torch.cuda.Event()
        event.record(self._stream)
        return dev, event

    def _work(self, it) -> None:
        ctx = (torch.cuda.device(self.device) if self._cuda
               else contextlib.nullcontext())
        try:
            with ctx:
                while not self._closed.is_set():
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    item = self._place(batch)
                    self.host_s += time.perf_counter() - t0
                    self.batches += 1
                    if not self._put(item):
                        return
            self._put(_STOP)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            self._put(_Failed(e))

    # -- consumer ----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        # the worker always ends with _STOP or the failure, so this
        # wait is bounded by the loader's own progress
        item = self._q.get()
        if item is _STOP:
            self.close()
            raise StopIteration
        if isinstance(item, _Failed):
            self.close()
            raise item.exc
        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            map_tensors(lambda t: t.record_stream(cur), batch)
        return batch

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker and drop the queued device batches."""
        self._done = True
        self._closed.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        while True:         # a put that raced the flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


def _resolve(place: DeviceLike) -> torch.device:
    if place is None:
        from ..runtime.context import get_device
        return get_device()
    return torch.device(place)


def device_prefetch(iterable: Iterable, size: int = 2,
                    place: DeviceLike = None) -> DevicePrefetcher:
    """Iterate ``iterable`` with ``size`` batches prefetched onto the
    device ``place`` (default: this rank's device, ``get_device()``,
    which raises without a card). Batches are nests of tensors (what
    ``DataLoader`` yields)."""
    return DevicePrefetcher(iterable, size, _resolve(place))


class PrefetchLoader:
    """A ``DataLoader`` wrapper yielding device-resident batches each
    epoch; keeps the loader's ``set_epoch`` and ``len``."""

    def __init__(self, loader, size: int = 2, place: DeviceLike = None):
        self.loader = loader
        self.size = size
        self.place = place

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self) -> DevicePrefetcher:
        return device_prefetch(self.loader, self.size, self.place)

    def __len__(self) -> int:
        return len(self.loader)
