"""Sharded checkpoint writer: each rank writes only the shards it owns.

The port's copy of ``distributed_pytorch_tpu/ckpt/writer.py``, in the
same two halves, so the manager can run them on different threads:

* :func:`snapshot_owned` (control thread): copies the pieces this rank
  owns from the device to fresh host tensors, and nothing else. The
  trees hold the live tensors in the JAX layout (a Linear W read as its
  transposed view), plain or DTensor: a DTensor leaf contributes only
  its ``to_local()`` piece, never a ``full_tensor()``. Where an owner
  does not hold its piece (on a ``dp x tp`` mesh the grid's linear
  index and the mesh's rank order can differ), the pieces move in one
  ``all_gather`` of every misplaced piece's bytes, here on the control
  thread, before the write.
* :func:`write_shards` (IO thread, no collective): the owned pieces as
  one ``shard_r<rank>.npz`` with a CRC32C per member, then the manifest
  fragment as the durability marker.
* :func:`commit` (control thread, committing rank): merges the fragments
  into the manifest and runs the two-rename commit of
  ``utils/checkpoint.py``.

A plain (non-DTensor) leaf is the whole array, equal on every rank; a
DTensor leaf may be sharded or replicated over any mesh of ``Shard`` and
``Replicate`` placements. Each saved shard must lie whole in some rank's
piece: save by specs no coarser than the live layout (the layout's own,
or finer), else :class:`~.errors.CkptError` names the shard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import manifest as _mf
from .errors import CkptError
from .integrity import array_crc32c
from .layout import is_raw, tree_layout

Box = Tuple[Tuple[int, int], ...]


# ---------------------------------------------------------------------------
# This rank's piece of a leaf
# ---------------------------------------------------------------------------

class Local(NamedTuple):
    """This rank's piece of one leaf: ``view`` (a tensor or array holding
    the global region ``box``) and whether the leaf is a DTensor (else
    every rank holds all of it)."""
    view: Any
    box: Box
    distributed: bool


def _chunk(lo: int, hi: int, k: int, c: int) -> Tuple[int, int]:
    """Piece ``c`` of ``[lo, hi)`` cut in ``k``, by ``torch.chunk``'s rule
    (DTensor's ``Shard``)."""
    size = -(-(hi - lo) // k)
    a = min(lo + c * size, hi)
    return a, min(a + size, hi)


def local_piece(leaf) -> Local:
    """``leaf`` as this rank's :class:`Local`."""
    from torch.distributed.tensor import DTensor
    from ..runtime import context
    if isinstance(leaf, DTensor):
        box = [(0, int(n)) for n in leaf.shape]
        coord = leaf.device_mesh.get_coordinate()
        for m, pl in enumerate(leaf.placements):
            if pl.is_replicate():
                continue
            if not pl.is_shard() or type(pl).__name__ != "Shard":
                raise CkptError(
                    f"a checkpoint leaf with placement {pl} has no "
                    "hyperrectangular local piece (Shard and Replicate "
                    "only)", rank=context.get_rank())
            d = pl.dim
            box[d] = _chunk(*box[d], leaf.device_mesh.size(m), coord[m])
        local = leaf.to_local()
        if tuple(local.shape) != tuple(b - a for a, b in box):
            raise CkptError(f"local piece {tuple(local.shape)} does not "
                            f"match its placements' box {box}",
                            rank=context.get_rank())
        return Local(local, tuple(box), True)
    if isinstance(leaf, torch.Tensor):
        return Local(leaf, tuple((0, int(n)) for n in leaf.shape), False)
    arr = np.asarray(leaf)
    return Local(arr, tuple((0, int(n)) for n in arr.shape), False)


def _inside(offsets: Box, box: Box) -> bool:
    return all(a >= lo and b <= hi for (a, b), (lo, hi) in zip(offsets, box))


def _rel(offsets: Box, box: Box) -> Tuple[slice, ...]:
    return tuple(slice(a - lo, b - lo) for (a, b), (lo, _) in
                 zip(offsets, box))


def _host(piece) -> Any:
    """A fresh host copy of a tensor (or array) piece."""
    if isinstance(piece, torch.Tensor):
        out = torch.empty(piece.shape, dtype=piece.dtype)
        out.copy_(piece.detach())
        return out
    return np.array(piece)


def _all_boxes(locals_: List[Local], world: int) -> List[List[Box]]:
    """Every rank's box of every leaf: ``boxes[rank][leaf]``. One
    ``all_gather`` of the boxes of the DTensor leaves (a plain leaf's box
    is the whole leaf on every rank); none at world 1."""
    if world == 1 or not any(loc.distributed for loc in locals_):
        return [[loc.box for loc in locals_] for _ in range(world)]
    from ..comm.collectives import all_gather
    from ..runtime import context
    nd = max([len(loc.box) for loc in locals_] + [1])
    enc = torch.zeros((len(locals_), nd, 2), dtype=torch.int64)
    for i, loc in enumerate(locals_):
        for d, (a, b) in enumerate(loc.box):
            enc[i, d, 0], enc[i, d, 1] = a, b
    rows = all_gather(enc.reshape(-1).to(context.get_device())).cpu().reshape(
        world, len(locals_), nd, 2)
    return [[tuple((int(rows[r, i, d, 0]), int(rows[r, i, d, 1]))
                   for d in range(len(loc.box)))
             if loc.distributed else loc.box
             for i, loc in enumerate(locals_)] for r in range(world)]


# ---------------------------------------------------------------------------
# Plan, snapshot, write, commit
# ---------------------------------------------------------------------------

def plan_trees(trees: Dict[str, Any], specs: Dict[str, Any],
               axis_sizes: Dict[str, int], writer_world: int
               ) -> Dict[str, Dict[str, Any]]:
    """The deterministic save plan: tree name -> layouts and leaves
    (``specs[name]`` None: every leaf whole). Every rank computes the
    same plan; the committer recomputes none of it from other ranks."""
    meta: Dict[str, Dict[str, Any]] = {}
    for name, tree in trees.items():
        if tree is None:
            continue
        layouts, leaves, seq = tree_layout(tree, specs.get(name),
                                           axis_sizes, writer_world)
        raw = [is_raw(lay.dtype) for lay in layouts]
        meta[name] = {"layouts": layouts, "arrays": leaves, "raw": raw,
                      "seq_prefixes": seq}
    return meta


def snapshot_owned(plan: Dict[str, Dict[str, Any]], rank: int,
                   world: int) -> Dict[str, int]:
    """Cut this rank's owned shard pieces out of the plan's leaves into
    host copies (control thread: the synchronous part of an async save)
    and drop the references to the live tensors. Collective when some
    owner does not hold its piece (one ``all_gather``; every rank calls
    this in the same order). Returns ``{"moved_bytes": ...}``, the bytes
    of the pieces that crossed ranks."""
    names = sorted(plan)
    flat = [(name, l_idx, lay, leaf)
            for name in names
            for l_idx, (lay, leaf) in enumerate(
                zip(plan[name]["layouts"], plan[name]["arrays"]))]
    locals_ = [local_piece(leaf) for _, _, _, leaf in flat]
    boxes = _all_boxes(locals_, world)
    pieces: Dict[str, Dict[int, list]] = {name: {} for name in names}
    moves = []                  # (flat index, lin, src, dst)
    for i, (name, l_idx, lay, _) in enumerate(flat):
        loc = locals_[i]
        mine = [(lin, sh) for lin, sh in enumerate(lay.shards)
                if sh.writer == rank and _inside(sh.offsets, loc.box)]
        if mine:
            # one copy from the device of the region this rank's pieces
            # span; the pieces are views of it (made contiguous by the
            # write, off this thread)
            span = tuple((min(sh.offsets[d][0] for _, sh in mine),
                          max(sh.offsets[d][1] for _, sh in mine))
                         for d in range(len(loc.box)))
            host = _host(loc.view[_rel(span, loc.box)])
            pieces[name][l_idx] = [(lin, host[_rel(sh.offsets, span)])
                                   for lin, sh in mine]
        for lin, sh in enumerate(lay.shards):
            if _inside(sh.offsets, boxes[sh.writer][i]):
                continue
            src = next((r for r in range(world)
                        if _inside(sh.offsets, boxes[r][i])), None)
            if src is None:
                raise CkptError(
                    f"no rank holds shard {sh.offsets} of leaf "
                    f"{lay.key!r}", rank=rank)
            moves.append((i, lin, src, sh.writer))
    moved = _exchange(flat, locals_, moves, pieces, rank, world)
    for name in names:
        plan[name]["pieces"] = pieces[name]
        plan[name]["arrays"] = None    # owned host copies only from here
    return {"moved_bytes": moved}


def _piece_bytes(piece) -> torch.Tensor:
    t = piece if isinstance(piece, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(piece))
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _exchange(flat, locals_, moves, pieces, rank: int, world: int) -> int:
    """Move each misplaced piece from its source rank to its owner: every
    rank packs the pieces it sources into one uint8 buffer (padded to
    the largest), one ``all_gather``, each owner cuts out its pieces.
    Returns the bytes moved (0 without moves; no collective then)."""
    if not moves:
        return 0
    from ..comm.collectives import all_gather

    def nbytes(i, lin):
        lay, loc = flat[i][2], locals_[i]
        n = int(np.prod(lay.shards[lin].shape, dtype=np.int64))
        return n * (loc.view.element_size()
                    if isinstance(loc.view, torch.Tensor)
                    else loc.view.itemsize)

    sizes = [0] * world
    for i, lin, src, _ in moves:
        sizes[src] += nbytes(i, lin)
    device = next((loc.view.device for loc in locals_
                   if isinstance(loc.view, torch.Tensor)
                   and loc.distributed), torch.device("cpu"))
    buf = torch.zeros(max(sizes), dtype=torch.uint8, device=device)
    off = 0
    for i, lin, src, _ in moves:
        if src != rank:
            continue
        loc, sh = locals_[i], flat[i][2].shards[lin]
        b = _piece_bytes(loc.view[_rel(sh.offsets, loc.box)])
        buf[off:off + b.numel()] = b.to(device)
        off += b.numel()
    rows = all_gather(buf)
    offs = [0] * world
    for i, lin, src, dst in moves:
        n = nbytes(i, lin)
        if dst == rank:
            name, l_idx, lay, _ = flat[i]
            view = locals_[i].view
            raw = rows[src, offs[src]:offs[src] + n].cpu().clone()
            shape = lay.shards[lin].shape
            if isinstance(view, torch.Tensor):
                piece = raw.view(view.dtype).reshape(shape)
            else:
                piece = raw.numpy().view(view.dtype).reshape(shape)
            pieces[name].setdefault(l_idx, []).append((lin, piece))
        offs[src] += n
    for entries in pieces.values():
        for lst in entries.values():
            lst.sort(key=lambda e: e[0])
    return sum(nbytes(i, lin) for i, lin, _, _ in moves)


def _member(piece, raw: bool) -> np.ndarray:
    """A host piece as the array ``np.savez`` stores: raw dtypes as their
    uint8 bytes, flat (dtype and shape live in the manifest)."""
    if isinstance(piece, torch.Tensor):
        t = piece.contiguous()
        if raw:
            return t.reshape(-1).view(torch.uint8).numpy()
        return t.numpy()
    # not ascontiguousarray, which makes a 0-d piece (1,)
    return np.asarray(piece, order="C")


def write_shards(tmp_dir: str, rank: int,
                 plan: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Write this rank's owned pieces and its fragment into ``tmp_dir``
    (after :func:`snapshot_owned`). Returns ``{"bytes", "shards",
    "duration_s"}``. File IO and CRC only: safe on a background thread."""
    t0 = time.perf_counter()
    members: Dict[str, np.ndarray] = {}
    frag: Dict[str, Dict[str, int]] = {}
    total = 0
    for t_idx, (name, meta) in enumerate(sorted(plan.items())):
        for l_idx, shards in sorted(meta["pieces"].items()):
            raw = meta["raw"][l_idx]
            for lin, piece in shards:
                m = _mf.member_name(t_idx, l_idx, lin)
                arr = _member(piece, raw)
                members[m] = arr
                frag[m] = {"crc32c": array_crc32c(arr),
                           "nbytes": int(arr.nbytes)}
                total += arr.nbytes
    path = os.path.join(tmp_dir, _mf.shard_file(rank))
    np.savez(path, **members)
    _mf.write_fragment(tmp_dir, rank, frag)  # last: durability marker
    return {"bytes": total, "shards": len(members),
            "duration_s": time.perf_counter() - t0}


def commit(ckpt_dir: str, step: int, tmp_dir: str,
           plan: Dict[str, Dict[str, Any]],
           extra: Optional[Dict[str, Any]],
           axis_sizes: Dict[str, int], writer_world: int,
           keep: Optional[int] = None) -> Tuple[str, Dict[str, Any]]:
    """Merge the fragments into the manifest, then the two-rename commit.
    Control thread, one rank, after every fragment is durable."""
    from ..utils import checkpoint as _ck

    tree_meta = {
        name: {"layouts": meta["layouts"], "raw": meta["raw"],
               "seq_prefixes": meta["seq_prefixes"]}
        for name, meta in plan.items()}
    man = _mf.merge(tmp_dir, step, extra, axis_sizes, writer_world,
                    tree_meta)
    mpath = os.path.join(tmp_dir, _mf.MANIFEST)
    with open(mpath, "w") as f:
        json.dump(man, f)
        f.flush()
        os.fsync(f.fileno())
    final = _ck._commit_full(ckpt_dir, step, tmp_dir, keep=keep)
    return final, man
