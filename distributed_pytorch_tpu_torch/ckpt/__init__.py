"""Checkpoint management of the port: the typed errors, the manager
(interval, retention, async save) over the single-file format 1 of
``utils/checkpoint.py``, and the sharded format 2 with its resharding
restore (``layout``, ``manifest``, ``writer``, ``reader``):
``CheckpointManager(sharded=True)`` is the one-flag switch."""

from . import errors, integrity, layout, manager, manifest, reader, writer
from .errors import (CkptCorrupt, CkptError, CkptIncomplete,
                     CkptShapeMismatch)
from .integrity import crc32c
from .manager import CheckpointManager, clear_trace, trace_log
from .reader import ReadStats, Target, restore_sharded

__all__ = ["CheckpointManager", "CkptCorrupt", "CkptError",
           "CkptIncomplete", "CkptShapeMismatch", "ReadStats", "Target",
           "clear_trace", "crc32c", "errors", "integrity", "layout",
           "manager", "manifest", "reader", "restore_sharded",
           "trace_log", "writer"]
