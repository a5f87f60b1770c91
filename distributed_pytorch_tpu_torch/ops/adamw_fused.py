"""Fused AdamW: the hand-written multi-tensor CUDA kernel of the port's
``optim.adamw`` (``csrc/adamw_fused.cu``), its plain version and its
counts.

``optim.adamw`` hands every parameter on a CUDA device to the kernel and
runs the CPU ones through its ``torch._foreach_*`` chain, which computes
the same float32 arithmetic in sixteen passes over memory where the
kernel makes one.

- :func:`split` sorts a step's tensors. Each CUDA parameter becomes a row
  of four plain contiguous tensors for the kernel: a DTensor gives its
  local shard (its gradient first laid out as the parameter), a strided
  view goes through a contiguous copy that :func:`launch` writes back.
  The CPU ones are left to the chain. It raises on a CUDA parameter the
  kernel cannot take (:func:`fusable`).
- :func:`launch` runs the kernel on ``torch.cuda.current_stream()``
  (built at first use): one launch per device and dtype pair and per
  640 tensors.
- :func:`adamw_reference` is the plain version: the kernel's arithmetic,
  in its order, on one parameter of any device. The tests hold it to the
  ``_foreach`` chain on the CPU, and the kernel to the chain on the card.
- ``LAUNCHES`` counts the kernel's launches; ``ELEMENTS`` the elements
  the kernel updated (``"fused"``, a DTensor's local shard) and those
  left to the ``_foreach`` chain (``"foreach"``, CPU tensors), so a run
  shows how often the kernel engages.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from . import _build

KERNEL_SOURCE = "adamw_fused.cu"
#: What the kernel takes for a parameter and its gradient, by the code
#: the C entry reads (the moments are always float32)
DTYPES = (torch.float32, torch.bfloat16)

#: Launches of the kernel, and the elements updated by it and by the
#: ``_foreach`` chain (under a lock: engine threads may update at once)
LAUNCHES = {"adamw_multi_tensor_apply": 0}
ELEMENTS = {"fused": 0, "foreach": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for counts in (LAUNCHES, ELEMENTS):
            for name in counts:
                counts[name] = 0


def _count(launches: int = 0, fused: int = 0, foreach: int = 0) -> None:
    with _count_lock:
        LAUNCHES["adamw_multi_tensor_apply"] += launches
        ELEMENTS["fused"] += fused
        ELEMENTS["foreach"] += foreach


def count_foreach(params: Sequence[torch.Tensor]) -> None:
    """Count ``params``' elements as updated by the ``_foreach`` chain."""
    _count(foreach=sum(p.numel() for p in params))


def hyper(*, lr, b1, b2, eps, weight_decay, c1, c2) -> Tuple[float, ...]:
    """The kernel's float32 constants in its argument order (b1, 1 - b1,
    b2, 1 - b2, 1 - lr * wd, lr, 1 / c1, 1 / c2, eps): each the Python
    scalar the ``_foreach`` chain passes, rounded to float32 as the op
    rounds it; the reciprocals of the bias corrections in float32, as
    torch's CUDA division by a Python scalar forms them."""
    f32 = np.float32
    return tuple(float(f32(x)) for x in (
        b1, 1 - b1, b2, 1 - b2, 1.0 - lr * weight_decay, lr,
        f32(1) / f32(c1), f32(1) / f32(c2), eps))


@torch.no_grad()
def adamw_reference(param, grad, mu, nu, *, lr, b1, b2, eps, weight_decay,
                    c1, c2) -> None:
    """One AdamW step on one parameter in place, the kernel's arithmetic
    in its order: float32 throughout, each product, sum, quotient and
    root rounded on its own. Written in torch's ops on the chain's
    scalars, it rounds as the chain does on each device: on the card a
    division by a Python scalar (``/ c1``, ``/ c2``) is a product with
    its float32 reciprocal, as in the kernel; on the CPU it divides."""
    gf = grad.to(torch.float32)
    mu.mul_(b1).add_(gf * (1 - b1))
    nu.mul_(b2).add_(gf * gf * (1 - b2))
    pf = param.to(torch.float32) * (1.0 - lr * weight_decay)
    param.copy_(pf - mu / c1 * lr / ((nu / c2).sqrt() + eps))


def fusable(param, grad, mu, nu) -> bool:
    """Whether the kernel takes these four tensors, once a DTensor is its
    local shard and a strided view a contiguous copy: of one CUDA device
    and one shape, the parameter and gradient float32 or bfloat16, the
    moments float32."""
    return (param.is_cuda and param.dtype in DTYPES
            and grad.dtype in DTYPES
            and mu.dtype == torch.float32 and nu.dtype == torch.float32
            and all(t.device == param.device and t.shape == param.shape
                    for t in (grad, mu, nu)))


def _locals(param, grad, mu, nu):
    """The four tensors' local shards where the parameter is a DTensor:
    the gradient laid out as the parameter first (a DTensor reduction
    comes back partial), the moments as they are, which ``optim.adamw``
    lays out as the parameter. Raises where the layouts disagree."""
    if not isinstance(param, DTensor):
        if any(isinstance(t, DTensor) for t in (grad, mu, nu)):
            raise ValueError("fused AdamW: a plain parameter with a "
                             "DTensor gradient or moment")
        return param, grad, mu, nu
    mesh, pl = param.device_mesh, tuple(param.placements)
    if isinstance(grad, DTensor) and tuple(grad.placements) != pl:
        grad = grad.redistribute(mesh, pl)
    for t in (grad, mu, nu):
        if (not isinstance(t, DTensor) or t.device_mesh != mesh
                or tuple(t.placements) != pl):
            raise ValueError(
                f"fused AdamW: a DTensor parameter in {pl} with a state "
                f"not laid out as it: {type(t).__name__} "
                f"{getattr(t, 'placements', None)}")
    return tuple(t.to_local() for t in (param, grad, mu, nu))


def split(grads, params, mu, nu):
    """``(groups, back, rest)``. ``groups``: the kernel's rows ``(p, g,
    mu, nu)`` of plain contiguous CUDA tensors by (device, parameter
    dtype, gradient dtype), empty ones left out. ``back``: the ``(dst,
    copy)`` pairs of the strided tensors a row holds a contiguous copy
    of, for :func:`launch` to write back. ``rest``: the CPU entries, in
    order, as lists (grads, params, mu, nu)."""
    groups, back, rest = {}, [], ([], [], [], [])
    for g, p, m, v in zip(grads, params, mu, nu):
        if not p.is_cuda:
            for out, x in zip(rest, (g, p, m, v)):
                out.append(x)
            continue
        ts = _locals(p, g, m, v)
        if not fusable(*ts):
            p, g, m, v = ts
            raise ValueError(
                "the fused AdamW kernel takes tensors of one CUDA device "
                "and shape, parameter and gradient float32 or bfloat16, "
                f"moments float32; got {p.dtype} {tuple(p.shape)} on "
                f"{p.device}, gradient {g.dtype} {tuple(g.shape)} on "
                f"{g.device}, moments {m.dtype}/{v.dtype}")
        if not ts[0].numel():
            continue
        row = tuple(t.contiguous() for t in ts)
        back += [(t, c) for i, (t, c) in enumerate(zip(ts, row))
                 if i != 1 and c is not t]
        groups.setdefault((row[0].device, row[0].dtype, row[1].dtype),
                          []).append(row)
    return groups, back, rest


def _library():
    lib = _build.load(KERNEL_SOURCE)
    fn = lib.dpx_adamw_multi_tensor_apply
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int] + [ctypes.c_float] * 9
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return lib


@torch.no_grad()
def launch(groups, back=(), **kw) -> None:
    """One AdamW step by the kernel over :func:`split`'s ``groups``, in
    place, on each device's current stream, then ``back``'s copies
    written back; ``kw`` as :func:`hyper`."""
    if not groups:
        return
    fn = _library().dpx_adamw_multi_tensor_apply
    consts = hyper(**kw)
    for (device, p_dtype, g_dtype), rows in groups.items():
        table = (ctypes.c_longlong * (5 * len(rows)))(*[
            x for p, g, m, v in rows for x in (
                p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                p.numel())])
        launches = ctypes.c_int(0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(table, len(rows), DTYPES.index(p_dtype),
                    DTYPES.index(g_dtype), *consts, stream,
                    ctypes.byref(launches))
        if rc != 0:
            raise RuntimeError(f"fused AdamW launch failed with "
                               f"{_error(rc)}")
        # the kernel wrote through raw pointers: tell autograd, as an
        # in-place op would
        torch.autograd.graph.increment_version(
            [t for p, _, m, v in rows for t in (p, m, v)])
        _count(launches=launches.value,
               fused=sum(p.numel() for p, _, _, _ in rows))
    for dst, copy in back:
        dst.copy_(copy)


def _error(rc: int) -> str:
    """The C entry's nonzero return code in words."""
    return {-1: "an unsupported dtype",
            -2: "more than 2^31 work items in one launch"}.get(
                rc, f"CUDA error {rc}")
