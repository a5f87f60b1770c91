"""Build a CUDA source of the port into a shared library and load it.

Route (b) of the port's kernel build: ``nvcc`` compiles one ``csrc/*.cu``
file with a plain C interface for ``sm_90a`` (wgmma needs the ``a``) into
``build/torch_kernels/`` at the repo root, keyed by a hash of the source,
every ``csrc/*.cuh`` header it may include and the flags, and ``ctypes``
loads it. Nothing is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def library_path(source: str, csrc: Path = CSRC,
                 defines: Tuple[str, ...] = ()) -> Path:
    """Where the library built from ``csrc/<source>`` (with the ``-D``
    ``defines``) lives: the name changes with the source, with any shared
    header and with the flags, so an edited header never loads a stale
    library."""
    digest = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + _flags(defines)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(f"-D{d}" for d in defines)


def build(source: str, defines: Tuple[str, ...] = ()) -> str:
    """Compile ``csrc/<source>`` unless the hashed library exists;
    returns the compiler's report (empty when nothing was built).
    ``defines`` (``NAME=VALUE``) override a source's compile-time tile
    constants; the port runs with none."""
    out = library_path(source, defines=defines)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *_flags(defines), "-o", str(tmp),
         str(CSRC / source)],
        capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stderr


def load(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _loaded.get((source, defines))
        if lib is None:
            build(source, defines)
            lib = _loaded[(source, defines)] = ctypes.CDLL(
                str(library_path(source, defines=defines)))
        return lib
