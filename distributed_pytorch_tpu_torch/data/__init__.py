"""Data of the port: seeded datasets, the sharded sampler and the
per-rank loader."""

from .datasets import DummyDataset, SyntheticImages, SyntheticLM
from .loader import DataLoader, default_collate
from .sampler import ShardedSampler, data_sampler

__all__ = ["DataLoader", "DummyDataset", "ShardedSampler", "SyntheticImages",
           "SyntheticLM", "data_sampler", "default_collate"]
