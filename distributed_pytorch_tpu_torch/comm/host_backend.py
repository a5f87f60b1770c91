"""The collectives of the helper API over the native host process group.

Counterpart of ``distributed_pytorch_tpu/comm/host_backend.py:62-290``:
while a :class:`~..runtime.native.HostComm` is live (``DPX_BACKEND=host``),
``comm/collectives.py`` routes every collective here. Each rank holds its
own tensor, and the reference's quirks are kept as on the
torch.distributed door: ``reduce`` leaves non-root buffers alone,
``gather`` gives non-root ranks zeros.

Tensors in, tensors out: a CPU or CUDA tensor is copied to a contiguous
host buffer, the native op runs on it, and the result goes back to the
input's device and dtype, in place where the torch.distributed door works
in place (``all_reduce``, ``reduce`` on rank 0, ``broadcast``,
``sync_params``). Reductions run at float32 or float64 (bf16 / f16 sum in
float32; integers and bools in float64, exact); the byte-moving ops move
each dtype's own bytes.

Wire formats: every collective moves exact bytes by default.
``all_reduce`` and ``sync_params`` also take ``wire="quant"`` (the block
int8 ring of ``comm/wire.py``; its width from ``DPX_WIRE_WIDTH``),
``"q4"`` (nibble-packed) and ``"adaptive"`` (width per bucket from the
observed dynamic range, with hysteresis). Under ``DPX_HIER_RING=L`` the
quantized reduce runs the two-level ring (``comm/hier.py``). ``max`` /
``min``, integer payloads, ``reduce`` and ``gather`` stay exact.

A failed op raises the typed :class:`~..runtime.native.CommError`
family, re-exported here with the sanitizer's ``CollectiveMismatch``.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np
import torch

from ..runtime import env as _env
from ..runtime.native import (CommCorrupt, CommError,  # noqa: F401
                              CommPeerDied, CommTimeout)
from . import wire as _wire
from .sanitizer import CollectiveMismatch  # noqa: F401

#: Wire formats a lossy-tolerant collective accepts.
WIRE_FORMATS = ("exact", "quant", "q4", "adaptive")

_warned_widths = set()


def _check_wire(wire: str) -> str:
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire must be one of {WIRE_FORMATS}, got {wire!r}")
    return wire


def resolve_wire_width(wire: str):
    """A wire format as a width: ``None`` (exact), 8, 4 or
    ``"adaptive"``. ``"quant"`` defers to ``DPX_WIRE_WIDTH``; a value
    that is none of 8|4|adaptive falls back to 8, with one warning per
    value."""
    _check_wire(wire)
    if wire == "exact":
        return None
    if wire == "q4":
        return 4
    if wire == "adaptive":
        return "adaptive"
    w = str(_env.get("DPX_WIRE_WIDTH") or "8").strip().lower()
    if w == "adaptive":
        return "adaptive"
    if w in ("4", "8"):
        return int(w)
    if w not in _warned_widths:
        _warned_widths.add(w)
        print(f"# DPX_WIRE_WIDTH={w!r} not one of 8|4|adaptive — "
              f"falling back to the q8 wire", file=sys.stderr)
    return 8


def _chooser_for(comm, size: int) -> "_wire.WidthChooser":
    """The comm's adaptive width chooser for buckets of ``size``
    elements, one per size so that call sites reducing different tensors
    do not share one hysteresis state. Each is fed the reduced bucket,
    bit-identical on every rank, so all ranks' choosers agree."""
    chs = getattr(comm, "_width_choosers", None)
    if chs is None:
        chs = comm._width_choosers = {}
    ch = chs.get(size)
    if ch is None:
        ch = chs[size] = _wire.WidthChooser()
    return ch


def _quant_allreduce(comm, work: np.ndarray, wire: str) -> np.ndarray:
    """A flat f32 sum bucket over the quantized ring, in place: width
    from the wire format (adaptive: the per-size chooser), two-level
    when ``DPX_HIER_RING`` names a local world that divides this one."""
    width = resolve_wire_width(wire)
    chooser = _chooser_for(comm, work.size) if width == "adaptive" \
        else None
    quant_ring(comm, work, chooser.width if chooser is not None else width)
    if chooser is not None:
        chooser.observe(work)
    return work


def quant_ring(comm, flat: np.ndarray, bits: int,
               hidden: bool = False) -> np.ndarray:
    """A flat f32 sum bucket over the ``bits``-wide quantized ring, in
    place: two-level when ``DPX_HIER_RING`` names a local world that
    divides this one. ``hidden`` books the time as overlapped."""
    local_world = int(_env.get("DPX_HIER_RING"))
    if local_world > 1 and comm.world % local_world == 0:
        from .hier import hier_ring
        hier_ring(comm, local_world).allreduce(flat, bits=bits,
                                               hidden=hidden)
    elif bits == 4:
        comm.allreduce_q4(flat, hidden=hidden)
    else:
        comm.allreduce_q8(flat, hidden=hidden)
    return flat


# -- tensors across the host boundary -------------------------------------

def _to_np(t: torch.Tensor) -> np.ndarray:
    """The tensor's values as a host numpy array (bf16 as float32)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)
    return t.contiguous().numpy()


def _to_bytes_np(t: torch.Tensor) -> np.ndarray:
    """The tensor's own bytes as a host numpy array (bf16 viewed as
    int16), for the ops that only move bytes."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_np(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    out = torch.from_numpy(np.ascontiguousarray(arr))
    if like.dtype == torch.bfloat16 and out.dtype == torch.int16:
        out = out.view(torch.bfloat16)         # bf16 bytes moved as int16
    return out.to(device=like.device, dtype=like.dtype)


def _write(tensor: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    with torch.no_grad():
        tensor.copy_(_from_np(arr, tensor).reshape(tensor.shape))
    return tensor


def _is_exact_kind(t: torch.Tensor) -> bool:
    """Integers and bools: summed in float64, never quantized."""
    return not (t.is_floating_point() or t.is_complex())


# -- the collectives -------------------------------------------------------

def all_reduce(comm, tensor: torch.Tensor, op: str = "sum",
               wire: str = "exact") -> torch.Tensor:
    """``sum``, ``avg``, ``max`` or ``min`` over the ranks, in place on
    every rank. A quantized ``wire`` applies to float sum / avg only."""
    if op not in ("sum", "avg", "max", "min"):
        raise ValueError(f'"{op}" is an invalid reduce operation!')
    _check_wire(wire)
    x = _to_np(tensor)
    if op in ("max", "min"):
        work = x.copy() if x.dtype == np.float32 else x.astype(np.float64)
        return _write(tensor, comm.allreduce(work, op=op))
    if wire != "exact" and not _is_exact_kind(tensor) and comm.world > 1:
        work = _quant_allreduce(comm, x.astype(np.float32, copy=True), wire)
        if op == "avg":
            work = work / comm.world
        return _write(tensor, work)
    exact_kind = _is_exact_kind(tensor)
    work = x.astype(np.float64) if exact_kind else x.copy()
    comm.allreduce(work)
    if op == "avg":
        work = work / comm.world
        if exact_kind:                 # the quotient truncated toward 0
            work = np.trunc(work)
    return _write(tensor, work)


def reduce(comm, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A rooted sum into rank 0's tensor, in place; other ranks' tensors
    stay as they were."""
    if op != "sum":
        raise ValueError(f'"{op}" is an invalid reduce operation!')
    x = _to_np(tensor)
    if x.dtype == np.float32:
        out = comm.reduce(x.copy())
    else:
        # other dtypes: an exact f64 sum over the ring
        out = comm.allreduce(x.astype(np.float64))
    if comm.rank == 0:
        _write(tensor, out)
    return tensor


def all_gather(comm, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's tensor stacked ``(world, *shape)`` on every rank."""
    stacked = comm.all_gather(_to_bytes_np(tensor))
    return _from_np(stacked, tensor)


def gather(comm, tensor: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's tensor in rank order on rank 0; the zeros the other
    ranks allocated elsewhere."""
    out = comm.gather(_to_bytes_np(tensor))
    if out is None:
        return [torch.zeros_like(tensor) for _ in range(comm.world)]
    return [_from_np(a, tensor) for a in out]


def broadcast(comm, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s tensor on every rank, in place."""
    return _write(tensor, comm.broadcast(_to_bytes_np(tensor).copy(),
                                         src=src))


def _broadcast_quant(comm, x: np.ndarray, bits: int) -> np.ndarray:
    """Rank 0's f32 array broadcast as one quantized frame (``[scales]
    [payload]``, nibble-packed at q4). Every rank, rank 0 included,
    adopts the dequantized value, so the result is bit-identical."""
    n = x.size
    nb = _wire.num_blocks(n)
    frame = np.empty(_wire.quant_wire_bytes(n, bits=bits), np.uint8)
    if comm.rank == 0:
        q, scales = _wire.quantize_blocks(x.astype(np.float32).ravel(),
                                          bits=bits)
        frame[:4 * nb] = scales.view(np.uint8)
        frame[4 * nb:] = (_wire.pack_nibbles(q) if bits == 4
                          else q.view(np.uint8))
    comm.broadcast(frame, src=0)
    scales = frame[:4 * nb].view(np.float32)
    q = (_wire.unpack_nibbles(frame[4 * nb:], n) if bits == 4
         else frame[4 * nb:].view(np.int8))
    return _wire.dequantize_blocks(q, scales).reshape(x.shape) \
        .astype(x.dtype)


def sync_params(comm, params: Sequence[torch.Tensor],
                wire: str = "exact") -> list:
    """Rank 0's values of ``params`` on every rank, in place.

    A quantized ``wire`` ships each float32 tensor as one quantized frame
    that every rank, rank 0 included, adopts: the params stay
    bit-identical across ranks and move by at most one quantization step.
    ``"adaptive"``: rank 0 picks each tensor's width from its dynamic
    range and broadcasts the verdicts first, in one message. Other
    dtypes broadcast exact."""
    width = resolve_wire_width(wire)
    params = list(params)
    quantizable = [i for i, p in enumerate(params)
                   if width is not None and p.dtype == torch.float32
                   and comm.world > 1]
    widths = {}
    if quantizable and width == "adaptive":
        verdicts = np.zeros(len(quantizable), np.uint8)
        if comm.rank == 0:
            for j, i in enumerate(quantizable):
                frac = _wire.block_outlier_frac(_to_np(params[i]))
                verdicts[j] = (4 if frac <= _wire.Q4_MAX_OUTLIER_FRAC
                               else 8)
        comm.broadcast(verdicts, src=0)
        widths = {i: int(verdicts[j]) for j, i in enumerate(quantizable)}
    elif quantizable:
        widths = {i: width for i in quantizable}
    for i, p in enumerate(params):
        if i in widths:
            _write(p, _broadcast_quant(comm, _to_np(p), widths[i]))
        else:
            broadcast(comm, p, src=0)
    return params


def barrier(comm) -> None:
    comm.barrier()
