"""The flat bucket of the sharded weight update (ZeRO-1, arXiv
2004.13336).

Counterpart of ``distributed_pytorch_tpu/optim/sharded/layout.py``. The
parameters, in the port's order (``model.parameters()``), are flattened
into one float32 bucket whose index space is cut into ``world`` equal
segments, one per rank:

* every parameter is zero-padded to a :data:`~...comm.wire.QUANT_BLOCK`
  multiple, so no quantization block spans two parameters;
* the bucket's tail is zero-padded to a multiple of ``pad_multiple``
  (default ``world * block``), so the segments are equal and
  block-aligned: the equal grid of ``reduce_scatter_tensor`` and the
  block grid of the native ring (``comm/wire.py`` ``segment_blocks``)
  are the same grid;
* padding is zeros and stays zeros under an elementwise optimizer.

A parameter whose dtype is narrower than float32 (bf16) holds only what
its dtype can: :meth:`FlatLayout.round_` rounds a span of the bucket
through each parameter's dtype, which is how the sharded step keeps its
gradients and masters equal to what the replicated step sees.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...comm import wire as _wire


class FlatLayout(NamedTuple):
    """How a list of tensors maps onto the flat bucket."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]     # each tensor's first element in the bucket
    sizes: Tuple[int, ...]
    n_padded: int                # bucket length, all padding in
    world: int
    block: int

    @property
    def seg(self) -> int:
        """Elements per rank's segment (equal by construction)."""
        return self.n_padded // self.world

    def span(self, seg_index: int) -> Tuple[int, int]:
        """(lo, hi) element range of segment ``seg_index``."""
        lo = seg_index * self.seg
        return lo, lo + self.seg

    def ring_segment(self, rank: int) -> int:
        """The segment ``rank`` owns after the native ring's
        reduce-scatter: ``(rank + 1) % world`` (``comm/wire.py``
        ``ring_owned_span`` on this equal grid)."""
        return (rank + 1) % self.world

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The tensors as one float32 bucket on the first one's device."""
        out = torch.zeros(self.n_padded, dtype=torch.float32,
                          device=tensors[0].device)
        for t, off, size in zip(tensors, self.offsets, self.sizes):
            out[off:off + size] = t.detach().reshape(-1).to(torch.float32)
        return out

    def flatten_np(self, tensors: Sequence[torch.Tensor]) -> np.ndarray:
        """:meth:`flatten` as a host numpy array (one copy off the
        card)."""
        return self.flatten(tensors).cpu().numpy()

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The bucket as tensors of the layout's shapes and dtypes."""
        return [flat[off:off + size].reshape(shape).to(dtype)
                for shape, dtype, off, size in zip(
                    self.shapes, self.dtypes, self.offsets, self.sizes)]

    @torch.no_grad()
    def unflatten_into(self, flat: torch.Tensor,
                       tensors: Sequence[torch.Tensor]) -> None:
        """Copy the bucket into ``tensors`` in place, each cast to its
        dtype."""
        for t, off, size in zip(tensors, self.offsets, self.sizes):
            t.copy_(flat[off:off + size].reshape(t.shape).to(
                device=t.device, dtype=t.dtype))

    def round_(self, flat_span: torch.Tensor, lo: int = 0) -> torch.Tensor:
        """Round, in place, the elements of ``flat_span`` (the bucket's
        elements ``lo ..``) that belong to a tensor narrower than
        float32 through that tensor's dtype; returns ``flat_span``."""
        hi = lo + flat_span.numel()
        for dtype, off, size in zip(self.dtypes, self.offsets, self.sizes):
            if dtype == torch.float32 or not dtype.is_floating_point:
                continue
            a, b = max(off, lo), min(off + size, hi)
            if a < b:
                part = flat_span[a - lo:b - lo]
                part.copy_(part.to(dtype).to(torch.float32))
        return flat_span


def build_layout(params: Sequence[torch.Tensor], world: int, *,
                 block: int = _wire.QUANT_BLOCK,
                 pad_multiple: Optional[int] = None) -> FlatLayout:
    """The :class:`FlatLayout` of ``params`` for ``world`` ranks.
    ``pad_multiple`` (elements) overrides the ``world * block`` tail
    padding; it must be a multiple of ``world * block``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if pad_multiple is None:
        pad_multiple = world * block
    if pad_multiple % (world * block):
        raise ValueError(
            f"pad_multiple ({pad_multiple}) must be a multiple of "
            f"world*block ({world * block}) so segments stay equal and "
            f"block-aligned")
    params = list(params)
    if not params:
        raise ValueError("cannot build a shard layout for an empty tree")
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for p in params:
        size = int(p.numel())
        shapes.append(tuple(p.shape))
        dtypes.append(p.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size + ((-size) % block)      # each tensor to a block edge
    n_padded = off + ((-off) % pad_multiple)
    return FlatLayout(shapes=tuple(shapes), dtypes=tuple(dtypes),
                      offsets=tuple(offsets), sizes=tuple(sizes),
                      n_padded=n_padded, world=world, block=block)


def lcm_pad_multiple(worlds: List[int],
                     block: int = _wire.QUANT_BLOCK) -> int:
    """The ``pad_multiple`` under which every world in ``worlds`` builds
    the same bucket length (checkpoints portable across worlds)."""
    return math.lcm(*[int(w) for w in worlds]) * block
