"""Sharded sampling, the ``DistributedSampler`` of the reference.

Counterpart of ``distributed_pytorch_tpu/data/sampler.py:28-99`` (the
contract of reference ``distributed.py:105-108``, used with
``set_epoch`` at ``min_DDP.py:82-83``), index for index:

* rank r takes positions ``r, r+W, r+2W, ...`` of the (optionally
  shuffled) index list;
* the list is padded by wrapping from its own start, so every rank gets
  ``ceil(N / W)`` indices (``drop_last`` cuts to ``N // W`` instead);
* ``set_epoch(e)`` reseeds the shuffle with ``default_rng(seed + e)``:
  the same permutation on every rank, another one each epoch.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np

from ..runtime import context


class ShardedSampler:
    """One rank's view of a dataset's indices, equal-sized across ranks."""

    def __init__(self, dataset_size: int, rank: int, world_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world "
                             f"{world_size}")
        self.dataset_size = int(dataset_size)
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        if drop_last and self.dataset_size % world_size != 0:
            self.num_samples = self.dataset_size // world_size
        else:
            self.num_samples = math.ceil(self.dataset_size / world_size)
        self.total_size = self.num_samples * world_size

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for ``epoch`` (``min_DDP.py:82-83``)."""
        self.epoch = int(epoch)

    def global_indices(self) -> np.ndarray:
        """The padded, epoch-shuffled index list every rank shares."""
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(
                self.dataset_size)
        else:
            idx = np.arange(self.dataset_size)
        if not self.drop_last and self.total_size > len(idx):
            reps = math.ceil((self.total_size - len(idx)) / max(len(idx), 1))
            idx = np.concatenate([idx] * (reps + 1))
        return idx[:self.total_size]

    def local_indices(self) -> np.ndarray:
        """This rank's strided share: positions rank, rank + W, ..."""
        return self.global_indices()[self.rank::self.world_size]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples


def data_sampler(dataset, distributed: bool, shuffle: bool,
                 rank: Optional[int] = None, world_size: Optional[int] = None,
                 seed: int = 0) -> Optional[ShardedSampler]:
    """A sampler iff ``distributed``, else ``None`` (reference
    ``distributed.py:105-108``); rank and world default to the live
    group's."""
    if not distributed:
        return None
    r = context.get_rank() if rank is None else rank
    w = context.get_world_size() if world_size is None else world_size
    return ShardedSampler(len(dataset), rank=r, world_size=w,
                          shuffle=shuffle, seed=seed)
