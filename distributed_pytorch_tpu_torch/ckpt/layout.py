"""Shard layout: spec trees -> per-leaf shard grids and slices.

The port's copy of ``distributed_pytorch_tpu/ckpt/layout.py``. A
:class:`LeafLayout` records, for one leaf of a JAX-layout tree, how its
global array decomposes into hyperrectangular shards: the per-dimension
shard grid (from the spec's axis names and the mesh axis sizes), each
shard's ``[start, stop)`` offsets, and which *writer* (rank process)
owns it. Restore onto another topology is geometry: :func:`intersect`
maps any requested slice of the global array onto the saved shards that
overlap it.

A spec is the port's ``parallel.tensor.P`` (a tuple that means what
``PartitionSpec`` means: per dimension ``None``, an axis name or a tuple
of names) or ``None`` (replicated). Everything here is deterministic
from ``(shapes, specs, axis_sizes, writer_world)``, so both sides of a
save and a restore recompute the same layout without communicating.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .errors import CkptShapeMismatch


def _spec_entry_axes(entry) -> Tuple[str, ...]:
    """Axis names a spec entry shards one dimension over: None -> (),
    'dp' -> ('dp',), ('dp', 'tp') -> both."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def dim_partitions(spec, shape: Sequence[int],
                   axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """Number of shards along each dimension of ``shape`` under ``spec``.
    Axis names absent from ``axis_sizes`` count as size 1; a dimension
    the shards do not divide raises :class:`CkptShapeMismatch`."""
    entries = list(spec) if spec is not None else []
    grid = []
    for d, n in enumerate(shape):
        parts = 1
        if d < len(entries):
            for ax in _spec_entry_axes(entries[d]):
                parts *= int(axis_sizes.get(ax, 1))
        if parts > 1 and n % parts != 0:
            # dpxlint: disable=DPX004 planning-time error on the calling rank; no shard exists yet
            raise CkptShapeMismatch(
                f"dim {d} of shape {tuple(shape)} not divisible by "
                f"{parts} (spec {spec!r}, axes {axis_sizes})")
        grid.append(max(parts, 1))
    return tuple(grid)


@dataclasses.dataclass
class Shard:
    """One hyperrectangular piece of a leaf."""
    index: Tuple[int, ...]                # grid coordinates, one per dim
    offsets: Tuple[Tuple[int, int], ...]  # [start, stop) per dim
    writer: int                           # owning writer rank at save time

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.offsets)

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.offsets)


@dataclasses.dataclass
class LeafLayout:
    """How one leaf decomposes into shards."""
    key: str                  # escaped '/'-joined key path
    shape: Tuple[int, ...]
    dtype: str                # numpy dtype name (bfloat16 included)
    spec: Tuple[Any, ...]     # per-dim axis name(s) or None, JSON-ready
    grid: Tuple[int, ...]
    shards: List[Shard]

    @property
    def nshards(self) -> int:
        return len(self.shards)


def _json_spec(spec, ndim: int) -> Tuple[Any, ...]:
    entries = list(spec) if spec is not None else []
    out = []
    for d in range(ndim):
        axes = _spec_entry_axes(entries[d]) if d < len(entries) else ()
        out.append(None if not axes else
                   (axes[0] if len(axes) == 1 else list(axes)))
    return tuple(out)


def leaf_layout(key: str, shape: Sequence[int], dtype: str, spec,
                axis_sizes: Dict[str, int], writer_world: int
                ) -> LeafLayout:
    """Enumerate the shard grid of one leaf. Shards are dealt to writers
    round-robin over the grid's row-major linear index modulo
    ``writer_world``: one dimension sharded ``dp=W`` under W writers puts
    shard i on rank i, a replicated leaf on writer 0."""
    shape = tuple(int(n) for n in shape)
    grid = dim_partitions(spec, shape, axis_sizes)
    sizes = tuple(n // g for n, g in zip(shape, grid))
    shards = []
    for lin, idx in enumerate(itertools.product(*(range(g) for g in grid))):
        offs = tuple((i * s, (i + 1) * s) for i, s in zip(idx, sizes))
        shards.append(Shard(index=idx, offsets=offs,
                            writer=lin % max(writer_world, 1)))
    return LeafLayout(key=key, shape=shape, dtype=dtype,
                      spec=_json_spec(spec, len(shape)), grid=grid,
                      shards=shards)


def intersect(shard: Shard, request: Sequence[slice]
              ) -> Optional[Tuple[Tuple[slice, ...], Tuple[slice, ...]]]:
    """Overlap of ``shard`` with a requested global slice: ``(src, dst)``
    (``src`` within the shard's array, ``dst`` within the request's), or
    None when disjoint. Requests are ``slice(start, stop)`` with no
    step."""
    src, dst = [], []
    for (a, b), r in zip(shard.offsets, request):
        lo = max(a, r.start if r.start is not None else 0)
        hi = min(b, r.stop if r.stop is not None else b)
        if lo >= hi:
            return None
        src.append(slice(lo - a, hi - a))
        dst.append(slice(lo - (r.start or 0), hi - (r.start or 0)))
    return tuple(src), tuple(dst)


def full_request(shape: Sequence[int]) -> Tuple[slice, ...]:
    return tuple(slice(0, n) for n in shape)


def local_slices(shape: Sequence[int], spec, axis_sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The global slice a rank at mesh coordinates ``coords`` owns under
    ``spec`` on a mesh of ``axis_sizes`` (axes absent from either count
    as replicated); a coordinate out of its axis's range raises
    :class:`CkptShapeMismatch`."""
    grid = dim_partitions(spec, shape, axis_sizes)
    entries = list(spec) if spec is not None else []
    out = []
    for d, (n, g) in enumerate(zip(shape, grid)):
        size = n // g
        idx = 0
        if d < len(entries):
            for ax in _spec_entry_axes(entries[d]):
                ax_size = int(axis_sizes.get(ax, 1))
                coord = int(coords.get(ax, 0))
                if ax not in axis_sizes:
                    coord = 0
                elif not 0 <= coord < ax_size:
                    # dpxlint: disable=DPX004 planning-time error on the calling rank; no shard exists yet
                    raise CkptShapeMismatch(
                        f"coordinate {coord} out of range for mesh axis "
                        f"{ax!r} of size {ax_size}")
                idx = idx * ax_size + coord
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


# ---------------------------------------------------------------------------
# Tree-level layout
# ---------------------------------------------------------------------------

def is_spec(x) -> bool:
    """A spec-tree leaf: ``None`` or a ``P``."""
    from ..parallel.tensor import P
    return x is None or isinstance(x, P)


def spec_leaves(specs) -> list:
    """The leaves of a spec tree in the order the state trees flatten
    (``utils.checkpoint._flatten``: dict keys sorted, NamedTuple fields
    and sequences in order), ``None`` and each ``P`` a leaf."""
    out = []

    def walk(node):
        if is_spec(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            raise TypeError(f"spec tree leaf {node!r} is not a P or None")

    walk(specs)
    return out


def dtype_name(leaf) -> str:
    """The numpy-style dtype name of a tensor or array leaf (a torch
    ``bfloat16`` is ``"bfloat16"``, as ml_dtypes names it)."""
    import numpy as np
    import torch
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def is_raw(name: str) -> bool:
    """Whether a dtype is stored as raw uint8 bytes: the names numpy has
    no dtype for (the JAX package's ml_dtypes ``kind == "V"`` set)."""
    return name == "bfloat16" or name.startswith("float8")


def tree_layout(tree, specs, axis_sizes: Dict[str, int],
                writer_world: int):
    """Per-leaf layouts of a whole JAX-layout tree: ``(layouts, leaves,
    seq_prefixes)`` with ``layouts[i]`` describing ``leaves[i]`` (a
    tensor, a DTensor or an array; ``specs=None`` is every leaf
    replicated)."""
    from ..utils import checkpoint as _ck

    keys, leaves, seq_prefixes = _ck._flatten(tree)
    if specs is None:
        s_leaves = [None] * len(leaves)
    else:
        s_leaves = spec_leaves(specs)
        if len(s_leaves) != len(leaves):
            raise ValueError(
                f"spec tree has {len(s_leaves)} leaves but state tree "
                f"has {len(leaves)}")
    layouts = [leaf_layout(key, tuple(_shape(x)), dtype_name(x), s,
                           axis_sizes, writer_world)
               for key, x, s in zip(keys, leaves, s_leaves)]
    return layouts, leaves, seq_prefixes


def _shape(x):
    import numpy as np
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
