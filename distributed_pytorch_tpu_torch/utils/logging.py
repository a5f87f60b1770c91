"""Primary-only output (reference ``distributed.py:94-95, 185-187``),
structured events, and a line-JSON metrics logger.

Counterpart of ``distributed_pytorch_tpu/utils/logging.py`` and its
``MetricsLogger``, which writes records to a file and/or stdout, one
JSON object per line, under one lock: the serving engine logs from its
own thread while the submitting thread may log or close concurrently.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Dict, Optional

from ..obs import trace as _dpxtrace
from ..runtime import context
from ..runtime import env as _env

_event_lock = threading.Lock()


def append_event(event: str, path: Optional[str] = None, **fields: Any
                 ) -> bool:
    """Append one ``{"event": ..., "time": ...}`` line to ``path``
    (default ``$DPX_METRICS_LOG``); a no-op when neither is set. Returns
    whether a line was written. Each record is one ``O_APPEND`` write,
    so the lines of many rank processes sharing one file stay whole;
    an unwritable file is not an error (the callers are failure paths,
    which must go on to raise what failed). The stamp is
    ``obs.trace.wall_now()``: within one process event times never go
    backwards, even when the system clock steps."""
    path = path or _env.get("DPX_METRICS_LOG")
    if not path:
        return False
    rec = {"event": event, "time": _dpxtrace.wall_now(), **fields}
    data = (json.dumps(rec, default=str) + "\n").encode()
    try:
        with _event_lock:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
        return True
    except OSError:
        return False


def is_primary() -> bool:
    """True on rank 0 (reference ``distributed.py:94-95``)."""
    return context.get_rank() == 0


def print_primary(*args, **kwargs) -> None:
    """``print`` on the primary only (reference ``distributed.py:
    185-187``)."""
    if is_primary():
        print(*args, **kwargs)


class MetricsLogger:
    """Structured metrics: line-JSON to a file and/or stdout. The file is
    opened on the primary only; ``log`` writes there (and echoes) on the
    primary only, ``event`` on every rank."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._lock = threading.Lock()
        self._fh = (open(path, "a") if path is not None and is_primary()
                    else None)

    def log(self, step: int, **metrics: Any) -> None:
        """One ``{"step": ..., "time": ..., **metrics}`` record, on the
        primary only (numbers such as numpy scalars write as floats)."""
        if not is_primary():
            return
        rec: Dict[str, Any] = {"step": step, "time": _dpxtrace.wall_now(),
                               **metrics}
        line = json.dumps(rec, default=float)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
            if self.echo:
                sys.stdout.write(line + "\n")

    def event(self, event: str, **fields: Any) -> None:
        """Structured non-step event (e.g. ``serve_request``), written on
        every rank: off the primary it is appended to the file as one
        write (``append_event``), since the primary may not live to
        write a failure."""
        rec: Dict[str, Any] = {"event": event,
                               "time": _dpxtrace.wall_now(), **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
            elif self.path is not None:
                append_event(event, path=self.path, **fields)
            if self.echo:
                sys.stdout.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
