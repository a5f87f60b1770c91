"""Checkpoint manifest, format 2 (sharded): schema, merge and load.

The port's copy of ``distributed_pytorch_tpu/ckpt/manifest.py``, on the
same JSON. One ``manifest.json`` per committed step is the only source
of truth a restore trusts: the mesh axis sizes at save time, each leaf's
layout, and the shard -> file map with a CRC32C and byte count per
member. Its existence defines completeness (the two-rename commit of
``utils/checkpoint.py`` makes it appear at once).

During a save every writer rank lands a *fragment*,
``manifest_r<rank>.json``, listing the members it wrote with their
checksums, by file IO alone. The committing rank merges the fragments
against the deterministic layout; a missing fragment or member is
:class:`~.errors.CkptIncomplete` naming the writer rank.

Schema (format 2)::

    {"format": 2, "step": N, "extra": {...},
     "mesh": {"axes": {"dp": 4}, "writer_world": W},
     "trees": {
       "params": {
         "seq_prefixes": [...],
         "leaves": [
           {"key": "blocks/0/fc1/w", "shape": [64, 256],
            "dtype": "float32", "raw": false,   # true: stored as u8 bytes
            "spec": [null, "dp"], "grid": [1, 4],
            "shards": [
              {"index": [0, 0], "offsets": [[0, 64], [0, 64]],
               "file": "shard_r0.npz", "member": "t0_l3_s0",
               "crc32c": 123456, "nbytes": 16384, "writer": 0},
              ...]}, ...]}, ...}}
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .errors import CkptError, CkptIncomplete
from .layout import LeafLayout, Shard

MANIFEST = "manifest.json"
FORMAT = 2


def fragment_name(rank: int) -> str:
    return f"manifest_r{rank}.json"


def shard_file(rank: int) -> str:
    return f"shard_r{rank}.npz"


def member_name(tree_idx: int, leaf_idx: int, shard_lin: int) -> str:
    return f"t{tree_idx}_l{leaf_idx}_s{shard_lin}"


def write_fragment(tmp_dir: str, rank: int,
                   members: Dict[str, Dict[str, int]]) -> None:
    """Atomically write this rank's fragment (member -> crc32c, nbytes),
    last, after its shard file: the rank's durability marker."""
    path = os.path.join(tmp_dir, fragment_name(rank))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rank": rank, "members": members}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _leaf_entry(tree_idx: int, leaf_idx: int, layout: LeafLayout,
                raw: bool, frags: Dict[int, Dict[str, Dict[str, int]]],
                step: int) -> Dict[str, Any]:
    shards = []
    for lin, sh in enumerate(layout.shards):
        member = member_name(tree_idx, leaf_idx, lin)
        frag = frags.get(sh.writer)
        if frag is None:
            raise CkptIncomplete(
                f"step {step}: writer rank {sh.writer} left no manifest "
                f"fragment (shard {member} unaccounted)", step=step,
                shard=f"{shard_file(sh.writer)}:{member}")
        meta = frag.get(member)
        if meta is None:
            raise CkptIncomplete(
                f"step {step}: shard {member} missing from rank "
                f"{sh.writer}'s fragment", step=step,
                shard=f"{shard_file(sh.writer)}:{member}")
        shards.append({"index": list(sh.index),
                       "offsets": [list(o) for o in sh.offsets],
                       "file": shard_file(sh.writer), "member": member,
                       "crc32c": int(meta["crc32c"]),
                       "nbytes": int(meta["nbytes"]),
                       "writer": sh.writer})
    return {"key": layout.key, "shape": list(layout.shape),
            "dtype": layout.dtype, "raw": raw,
            "spec": [list(s) if isinstance(s, (list, tuple)) else s
                     for s in layout.spec],
            "grid": list(layout.grid), "shards": shards}


def merge(tmp_dir: str, step: int, extra: Optional[Dict[str, Any]],
          axis_sizes: Dict[str, int], writer_world: int,
          tree_meta: Dict[str, Any]) -> Dict[str, Any]:
    """The global manifest from the per-rank fragments in ``tmp_dir``.
    ``tree_meta``: tree name -> ``{"layouts", "raw", "seq_prefixes"}``.
    An absent fragment or member raises :class:`CkptIncomplete`, so a
    writer that died mid-save is never committed."""
    frags: Dict[int, Dict[str, Dict[str, int]]] = {}
    for rank in range(max(writer_world, 1)):
        path = os.path.join(tmp_dir, fragment_name(rank))
        if os.path.exists(path):
            with open(path) as f:
                frags[rank] = json.load(f)["members"]
    trees = {}
    for t_idx, (name, meta) in enumerate(sorted(tree_meta.items())):
        leaves = [
            _leaf_entry(t_idx, l_idx, lay, raw, frags, step)
            for l_idx, (lay, raw) in enumerate(
                zip(meta["layouts"], meta["raw"]))]
        trees[name] = {"seq_prefixes": list(meta["seq_prefixes"]),
                       "leaves": leaves}
    return {"format": FORMAT, "step": step, "extra": extra or {},
            "mesh": {"axes": {k: int(v) for k, v in axis_sizes.items()},
                     "writer_world": int(writer_world)},
            "trees": trees}


def load(step_dir: str, step: int = -1, rank: int = -1) -> Dict[str, Any]:
    """Read and check a manifest: absent or unparseable is
    :class:`CkptIncomplete` (a torn write), an unknown format
    :class:`CkptError`."""
    path = os.path.join(step_dir, MANIFEST)
    if not os.path.exists(path):
        raise CkptIncomplete(
            f"no manifest under {step_dir!r} (incomplete checkpoint)",
            step=step, rank=rank)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CkptIncomplete(
            f"step {step}: manifest at {path!r} is truncated/unparseable "
            f"({e})", step=step, rank=rank) from e
    fmt = manifest.get("format")
    if fmt not in (1, FORMAT):
        raise CkptError(f"step {step}: unknown manifest format {fmt!r}",
                        step=step, rank=rank)
    return manifest


def leaf_shards(entry: Dict[str, Any]) -> List[Shard]:
    """A manifest leaf's shard list as layout objects."""
    return [Shard(index=tuple(s["index"]),
                  offsets=tuple(tuple(o) for o in s["offsets"]),
                  writer=int(s["writer"]))
            for s in entry["shards"]]
