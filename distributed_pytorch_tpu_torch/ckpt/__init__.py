"""Checkpoint management of the port: the typed errors and the
interval, retention and async-save manager over the single-file format
of ``utils/checkpoint.py``. The sharded format (format 2) is not ported
yet (ROADMAP.md Queue A items 5-6)."""

from .errors import (CkptCorrupt, CkptError, CkptIncomplete,
                     CkptShapeMismatch)
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "CkptCorrupt", "CkptError",
           "CkptIncomplete", "CkptShapeMismatch"]
