"""The reference workload's model: a 2-layer MLP with no activation
(``min_DDP.py:41-49``: Linear(in -> hidden) -> Linear(hidden -> classes)).

Counterpart of ``distributed_pytorch_tpu/models/mlp.py``; the JAX
param tree ``{"lin1": {"w", "b"}, "lin2": {"w", "b"}}`` loads with
``convert.from_jax_params``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.core import Linear
from ..runtime.device import DeviceLike, resolve_device


class DummyModel(nn.Module):
    """Linear -> Linear, no activation between (reference
    ``min_DDP.py:44-48``); ``in_dim`` defaults to the scalar feature of
    ``DummyDataset``."""

    def __init__(self, in_dim: int = 1, hidden_dim: int = 32,
                 n_classes: int = 4, *, dtype=torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device),
                  generator=generator)
        self.lin1 = Linear(in_dim, hidden_dim, **kw)
        self.lin2 = Linear(hidden_dim, n_classes, **kw)

    def forward(self, x):
        return self.lin2(self.lin1(x))
