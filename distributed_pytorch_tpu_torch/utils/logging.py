"""Line-JSON metrics logger (the port's copy of ``MetricsLogger``).

Records go to a file and/or stdout, one JSON object per line, under one
lock: the serving engine logs from its own thread while the submitting
thread may log or close concurrently. The port runs one process, so
there is no primary-rank filter yet, and only events are written: the
per-step ``log`` of training records arrives with the training slice.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Structured metrics: line-JSON to a file and/or stdout."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._lock = threading.Lock()
        self._fh = open(path, "a") if path is not None else None

    def event(self, event: str, **fields: Any) -> None:
        """Structured non-step event (e.g. ``serve_request``)."""
        rec: Dict[str, Any] = {"event": event, "time": time.time(), **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
            if self.echo:
                sys.stdout.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
