"""Data of the port: seeded datasets, the sharded sampler, the
per-rank loader and device prefetching."""

from .datasets import DummyDataset, SyntheticImages, SyntheticLM
from .loader import DataLoader, default_collate
from .prefetch import DevicePrefetcher, PrefetchLoader, device_prefetch
from .sampler import ShardedSampler, data_sampler

__all__ = ["DataLoader", "DevicePrefetcher", "DummyDataset", "PrefetchLoader",
           "ShardedSampler", "SyntheticImages", "SyntheticLM",
           "data_sampler", "default_collate", "device_prefetch"]
