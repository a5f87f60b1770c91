"""Typed checkpoint failures.

The port's copy of ``distributed_pytorch_tpu/ckpt/errors.py``. Every
failure a save or restore can observe maps to one of three classes,
each carrying its attribution (which step, which rank observed it,
which ``file:member``), so callers act on types and fields, not on
message strings:

* :class:`CkptCorrupt`       — bytes exist but fail their integrity check;
* :class:`CkptIncomplete`    — bytes are missing: no or truncated
  manifest, a tree file or npz member absent;
* :class:`CkptShapeMismatch` — bytes are fine but do not fit the request:
  the template's leaves or shapes disagree with the stored ones.

``FileNotFoundError`` stays reserved for "nothing is checkpointed here"
(the resume-or-fresh-start branch of a training script).
"""

from __future__ import annotations


class CkptError(RuntimeError):
    """A checkpoint save or restore failed; ``step``, ``rank`` and
    ``shard`` (``file:member``) attribute it where known."""

    def __init__(self, msg: str, *, step: int = -1, rank: int = -1,
                 shard: str = ""):
        super().__init__(msg)
        self.step = step
        self.rank = rank
        self.shard = shard


class CkptCorrupt(CkptError):
    """Stored bytes failed their integrity check."""


class CkptIncomplete(CkptError):
    """A required piece of the checkpoint is missing or truncated."""


class CkptShapeMismatch(CkptError):
    """The checkpoint does not fit the template it is restored into."""
