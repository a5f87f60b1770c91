"""CRC32C, the checksum of the KV-page handoff frames and of every
checkpoint shard.

The port's copy of ``distributed_pytorch_tpu/ckpt/integrity.py``. The
value comes from the repo's host library (``runtime/native.py``, built
from ``native/dpxhost.cpp``), the same function the JAX package's wire
frames and checkpoint shards are stamped with. :func:`crc32c_sw` is the
plain table version, kept only to hold the native value against: it
loops over bytes in Python, about a megabyte a second.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..runtime import native

_CRC_POLY = 0x82F63B78  # CRC32C, reflected (dpxhost.cpp kCrcPoly)

_table: Optional[np.ndarray] = None


def _crc_table() -> np.ndarray:
    global _table
    if _table is None:
        t = np.empty(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (_CRC_POLY ^ (c >> 1)) if (c & 1) else (c >> 1)
            t[i] = c
        _table = t
    return _table


def crc32c_sw(buf) -> int:
    """Table-driven CRC32C in Python, bit-identical to the native value."""
    data = np.frombuffer(memoryview(buf), dtype=np.uint8) \
        if not isinstance(buf, np.ndarray) \
        else np.ascontiguousarray(buf).view(np.uint8).ravel()
    t = _crc_table()
    c = 0xFFFFFFFF
    for b in data.tobytes():
        c = int(t[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(buf) -> int:
    """CRC32C of a bytes-like buffer or a C-contiguous array, from the
    host library (built at first use; a failed build raises)."""
    return native.crc32c(buf)


def array_crc32c(a) -> int:
    """CRC32C over an array's C-order raw bytes (the shard checksum): a
    numpy array, or a tensor (a ``bfloat16`` one over its raw bytes,
    ``view(torch.uint8)``). Equal to the JAX package's value for the
    same bytes."""
    import torch
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous().reshape(-1)
        return crc32c(t.view(torch.uint8).numpy())
    return crc32c(np.ascontiguousarray(a))
