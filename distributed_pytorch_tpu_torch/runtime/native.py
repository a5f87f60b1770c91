"""The port's ctypes layer over the repo's host library
(``native/dpxhost.cpp``).

The JAX package binds the same source through its own loader, which the
port cannot import. Here ``g++`` compiles ``native/dpxhost.cpp`` with the
flags of ``native/Makefile`` into ``build/torch_native/`` at the repo
root, keyed by a hash of the source and the flags, and ``ctypes`` loads
it; nothing is built at import, the first call builds. A build failure
raises: there is no silent fallback to a slower path.

Bound so far: ``dpx_crc32c``, the CRC32C (Castagnoli) of the handoff
frames (hardware sse4.2 where the CPU has it, a bit-identical table
otherwise).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dpxhost.cpp"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fno-math-errno", "-fPIC", "-std=c++17", "-shared")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"dpxhost-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/dpxhost.cpp`` unless the hashed library exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the port's host "
                           "library is built from native/dpxhost.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded host library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dpx_crc32c.restype = ctypes.c_uint32
            lib.dpx_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
        return _lib


def crc32c(buf) -> int:
    """CRC32C of a bytes-like buffer or a numpy array (its C-order
    bytes)."""
    lib = load_library()
    if not isinstance(buf, np.ndarray):
        buf = np.frombuffer(memoryview(buf), dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    if buf.nbytes == 0:
        return int(lib.dpx_crc32c(None, 0))
    return int(lib.dpx_crc32c(buf.ctypes.data_as(ctypes.c_void_p),
                              buf.nbytes))
