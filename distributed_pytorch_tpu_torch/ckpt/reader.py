"""Resharding checkpoint reader: restore onto any topology.

The port's copy of ``distributed_pytorch_tpu/ckpt/reader.py``. A
format-2 checkpoint records global shapes and the shard decomposition it
was written with, so the target topology is free:

* **Full assembly** (default): every leaf rebuilt to its global shape
  from the shards that cover it.
* **Slice restore** (``target=``): the caller gives its coordinates on a
  new mesh (``dp=r`` of ``M``) and gets, per leaf, its own slice,
  reading only the members that overlap it.
* **Into a live model** (``like_params=`` a module): every parameter,
  and every tensor of ``like_opt_state``, is filled in place with the
  region this rank holds: a ZeRO-3 (FSDP2) parameter's local shard, a
  replicated one's whole leaf; each reads only the members that overlap
  its region.

Every member read is CRC32C-checked against the manifest before its
bytes reach a tensor; failures raise the typed :mod:`.errors` with the
step and ``file:member``. Reads are collective-free.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

from . import manifest as _mf
from .errors import CkptCorrupt, CkptError, CkptIncomplete, CkptShapeMismatch
from .integrity import array_crc32c
from .layout import full_request, intersect, local_slices, spec_leaves


@dataclasses.dataclass
class ReadStats:
    """What a restore touched: the files, members and bytes read."""
    files: Set[str] = dataclasses.field(default_factory=set)
    members: int = 0
    bytes: int = 0


@dataclasses.dataclass
class Target:
    """A reader's coordinates on its (new) topology: ``specs`` per tree
    name (spec trees of the JAX layout), the new mesh ``axis_sizes``
    (``{"dp": 2}``) and this rank's ``coords`` (``{"dp": 1}``)."""
    specs: Dict[str, Any]
    axis_sizes: Dict[str, int]
    coords: Dict[str, int]


class _ShardFiles:
    """Lazily opened npz handles, one per shard file."""

    def __init__(self, step_dir: str, step: int, rank: int):
        self.step_dir = step_dir
        self.step = step
        self.rank = rank
        self._open: Dict[str, Any] = {}

    def member(self, fname: str, member: str, crc: int,
               stats: Optional[ReadStats]) -> np.ndarray:
        z = self._open.get(fname)
        if z is None:
            path = os.path.join(self.step_dir, fname)
            if not os.path.exists(path):
                raise CkptIncomplete(
                    f"step {self.step}: shard file {fname!r} missing",
                    step=self.step, rank=self.rank, shard=fname)
            try:
                z = np.load(path)
            except Exception as e:
                raise CkptCorrupt(
                    f"step {self.step}: shard file {fname!r} unreadable "
                    f"({e})", step=self.step, rank=self.rank,
                    shard=fname) from e
            self._open[fname] = z
        try:
            arr = z[member]
        except KeyError as e:
            raise CkptIncomplete(
                f"step {self.step}: member {member!r} missing from "
                f"{fname!r}", step=self.step, rank=self.rank,
                shard=f"{fname}:{member}") from e
        except Exception as e:
            # zipfile's own CRC, or a torn npy header
            raise CkptCorrupt(
                f"step {self.step}: member {member!r} of {fname!r} "
                f"unreadable ({e})", step=self.step, rank=self.rank,
                shard=f"{fname}:{member}") from e
        if array_crc32c(arr) != crc:
            raise CkptCorrupt(
                f"step {self.step}: shard {fname}:{member} failed CRC32C",
                step=self.step, rank=self.rank,
                shard=f"{fname}:{member}")
        if stats is not None:
            stats.files.add(fname)
            stats.members += 1
            stats.bytes += int(arr.nbytes)
        return arr

    def close(self) -> None:
        for z in self._open.values():
            z.close()
        self._open.clear()


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def read_leaf(lmeta: Dict[str, Any], request, files: _ShardFiles,
              stats: Optional[ReadStats], step: int,
              rank: int) -> torch.Tensor:
    """The region ``request`` (slices of the global leaf) of one manifest
    leaf as a CPU tensor, assembled from the members that overlap it."""
    shape = tuple(lmeta["shape"])
    raw = bool(lmeta.get("raw"))
    req_shape = tuple(s.stop - s.start for s in request)
    if raw:
        item = _itemsize(lmeta["dtype"])
        dst = np.empty(req_shape + (item,), np.uint8)
    else:
        dst = np.empty(req_shape, np.dtype(lmeta["dtype"]))
    covered = 0
    for sh, smeta in zip(_mf.leaf_shards(lmeta), lmeta["shards"]):
        ov = intersect(sh, request)
        if ov is None:
            continue
        src_sl, dst_sl = ov
        arr = files.member(smeta["file"], smeta["member"],
                           int(smeta["crc32c"]), stats)
        want = sh.shape + ((item,) if raw else ())
        if raw:
            if arr.size != int(np.prod(want, dtype=np.int64)):
                raise CkptShapeMismatch(
                    f"step {step}: shard {smeta['member']} holds "
                    f"{arr.size} bytes, manifest says {sh.shape} of "
                    f"{lmeta['dtype']}", step=step, rank=rank,
                    shard=f"{smeta['file']}:{smeta['member']}")
            arr = arr.reshape(want)
        elif arr.shape != sh.shape:
            raise CkptShapeMismatch(
                f"step {step}: shard {smeta['member']} has shape "
                f"{arr.shape}, manifest says {sh.shape}", step=step,
                rank=rank, shard=f"{smeta['file']}:{smeta['member']}")
        dst[dst_sl] = arr[src_sl]
        covered += int(np.prod([s.stop - s.start for s in dst_sl],
                               dtype=np.int64))
    if covered != int(np.prod(req_shape, dtype=np.int64)):
        raise CkptIncomplete(
            f"step {step}: leaf {lmeta['key']!r} request {request} only "
            f"{covered} of {int(np.prod(req_shape))} elements covered by "
            f"saved shards", step=step, rank=rank)
    if raw:
        t = torch.from_numpy(np.ascontiguousarray(dst))
        return t.view(getattr(torch, lmeta["dtype"])).reshape(req_shape)
    return torch.from_numpy(dst)


def read_tree(step_dir: str, manifest: Dict[str, Any], name: str,
              template=None, target: Optional[Target] = None,
              stats: Optional[ReadStats] = None, rank: int = -1):
    """One tree (``params``, ``opt_state``) of a format-2 checkpoint, or
    None when it was never saved: in ``template``'s structure (a
    JAX-layout tree whose keys are the stored keys) or rebuilt from the
    stored key paths."""
    from ..utils import checkpoint as _ck

    entry = manifest["trees"].get(name)
    if entry is None:
        return None
    step = int(manifest.get("step", -1))
    leaves_meta = entry["leaves"]
    if target is not None and target.specs.get(name) is not None:
        spec_list = spec_leaves(target.specs[name])
        if len(spec_list) != len(leaves_meta):
            raise CkptShapeMismatch(
                f"target spec tree has {len(spec_list)} leaves, checkpoint "
                f"tree has {len(leaves_meta)}", step=step, rank=rank)
    else:
        spec_list = [None] * len(leaves_meta)
    files = _ShardFiles(step_dir, step, rank)
    out = []
    try:
        for lmeta, tspec in zip(leaves_meta, spec_list):
            shape = tuple(lmeta["shape"])
            request = (full_request(shape) if target is None else
                       local_slices(shape, tspec, target.axis_sizes,
                                    target.coords))
            out.append(read_leaf(lmeta, request, files, stats, step, rank))
    finally:
        files.close()
    keys = [m["key"] for m in leaves_meta]
    if template is not None:
        t_keys, _, _ = _ck._flatten(template)
        if len(t_keys) != len(out):
            raise CkptShapeMismatch(
                f"step {step}: checkpoint tree {name!r} has {len(out)} "
                f"leaves but template has {len(t_keys)}", step=step,
                rank=rank)
        stored = dict(zip(keys, out))
        missing = sorted(set(t_keys) - set(stored))
        if missing:
            raise CkptShapeMismatch(
                f"step {step}: checkpoint tree {name!r} lacks the "
                f"template's leaves {missing[:5]}", step=step, rank=rank)
        return _ck._map_with_keys(template, lambda key, _: stored[key])
    return _ck._nest(keys, out, entry.get("seq_prefixes") or [])


@torch.no_grad()
def _fill_tree(step_dir: str, manifest: Dict[str, Any], name: str, tree,
               stats: Optional[ReadStats], rank: int):
    """Fill ``tree``'s tensors (JAX-layout views of live tensors, plain
    or DTensor) in place with the regions this rank holds; returns the
    tree with every other leaf (a step count) replaced by its stored
    value."""
    from ..utils import checkpoint as _ck
    from .writer import local_piece

    entry = manifest["trees"].get(name)
    step = int(manifest.get("step", -1))
    if entry is None:
        raise CkptIncomplete(f"step {step}: checkpoint has no {name!r} "
                             "tree", step=step, rank=rank)
    by_key = {m["key"]: m for m in entry["leaves"]}
    keys, leaves, _ = _ck._flatten(tree)
    if len(keys) != len(by_key):
        raise CkptShapeMismatch(
            f"step {step}: checkpoint tree {name!r} has {len(by_key)} "
            f"leaves but template has {len(keys)}", step=step, rank=rank)
    files = _ShardFiles(step_dir, step, rank)
    values = {}
    try:
        for key, leaf in zip(keys, leaves):
            lmeta = by_key.get(key)
            if lmeta is None:
                raise CkptShapeMismatch(
                    f"step {step}: checkpoint tree {name!r} lacks the "
                    f"template's leaf {key!r}", step=step, rank=rank)
            shape = tuple(lmeta["shape"])
            if tuple(np.shape(leaf) if not isinstance(leaf, torch.Tensor)
                     else leaf.shape) != shape:
                raise CkptShapeMismatch(
                    f"step {step}: checkpoint leaf {name}/{key} is "
                    f"{shape}, the template's {tuple(np.shape(leaf))}",
                    step=step, rank=rank)
            loc = local_piece(leaf)
            data = read_leaf(lmeta, tuple(slice(a, b) for a, b in loc.box),
                             files, stats, step, rank)
            if isinstance(loc.view, torch.Tensor):
                loc.view.copy_(data.to(device=loc.view.device,
                                       dtype=loc.view.dtype))
            else:
                values[key] = data.numpy()
    finally:
        files.close()
    return _ck._map_with_keys(
        tree, lambda key, leaf: values.get(key, leaf))


@torch.no_grad()
def _restore_into(step_dir: str, manifest: Dict[str, Any], model,
                  like_opt_state, stats: ReadStats, rank: int):
    """Fill ``model``'s parameters and ``like_opt_state``'s tensors in
    place; returns ``(model, opt_state)`` (the state rebuilt with its
    stored step counts)."""
    from ..utils import checkpoint as _ck

    _fill_tree(step_dir, manifest, "params",
               _ck.jax_params(model, lambda t: t), stats, rank)
    if like_opt_state is None:
        return model, None
    jt = _fill_tree(step_dir, manifest, "opt_state",
                    _ck.jax_opt_state(like_opt_state, model, lambda t: t),
                    stats, rank)
    return model, _ck._with_restored_scalars(like_opt_state, jt)


def restore_dir(step_dir: str, manifest: Dict[str, Any], *,
                like_params=None, like_opt_state=None,
                target: Optional[Target] = None,
                stats: Optional[ReadStats] = None, rank: int = -1):
    """Restore a resolved, loaded format-2 step directory
    (collective-free) and emit the ``ckpt_restore`` event: the engine
    behind :func:`restore_sharded` and the format dispatch of
    ``utils.checkpoint.restore_checkpoint``. With a module as
    ``like_params`` its parameters (and ``like_opt_state``'s tensors)
    are filled in place and ``Checkpoint.params`` is the module."""
    from ..utils import checkpoint as _ck
    from ..utils.logging import append_event

    t0 = time.perf_counter()
    step = int(manifest.get("step", -1))
    missing = [k for k in ("mesh", "trees") if k not in manifest]
    if missing:
        raise CkptIncomplete(f"step {step}: format-2 manifest lacks "
                             f"{missing}", step=step, rank=rank)
    own = stats if stats is not None else ReadStats()
    if isinstance(like_params, torch.nn.Module):
        if target is not None:
            raise ValueError("target= slices a template-free restore; a "
                             "module restores the region each of its "
                             "tensors holds")
        params, opt_state = _restore_into(step_dir, manifest, like_params,
                                          like_opt_state, own, rank)
    else:
        params = read_tree(step_dir, manifest, "params",
                           template=like_params, target=target, stats=own,
                           rank=rank)
        opt_state = read_tree(step_dir, manifest, "opt_state",
                              template=like_opt_state, target=target,
                              stats=own, rank=rank)
    append_event("ckpt_restore", step=step, rank=rank, sharded=True,
                 bytes=own.bytes, shards=own.members,
                 duration_s=round(time.perf_counter() - t0, 6),
                 resharded=target is not None,
                 saved_axes=manifest["mesh"]["axes"],
                 target_axes=(target.axis_sizes if target else None))
    return _ck.Checkpoint(step=step, params=params, opt_state=opt_state,
                          extra=manifest.get("extra") or {})


def restore_sharded(ckpt_dir: str, step: Optional[int] = None, *,
                    like_params=None, like_opt_state=None,
                    target: Optional[Target] = None,
                    stats: Optional[ReadStats] = None,
                    rank: int = -1):
    """Read a format-2 checkpoint (collective-free); returns a
    ``utils.checkpoint.Checkpoint``. ``target`` opts into slice restore,
    ``stats`` collects what was read. ``FileNotFoundError`` when nothing
    is checkpointed, the typed :mod:`.errors` when what is there cannot
    be trusted, :class:`CkptError` for a format-1 directory (restore
    those through ``utils.checkpoint.restore_checkpoint``)."""
    from ..utils import checkpoint as _ck

    if step is None:
        step = _ck.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    d = _ck._resolve_step_dir(ckpt_dir, step)
    if d is None:
        raise FileNotFoundError(
            f"no complete checkpoint for step {step} under {ckpt_dir!r}")
    manifest = _mf.load(d, step=step, rank=rank)
    if manifest.get("format") != _mf.FORMAT:
        raise CkptError(
            f"step {step} is a format-{manifest.get('format')} "
            "(single-replica) checkpoint; restore it via "
            "utils.checkpoint.restore_checkpoint", step=step, rank=rank)
    return restore_dir(d, manifest, like_params=like_params,
                       like_opt_state=like_opt_state, target=target,
                       stats=stats, rank=rank)
