"""Core layers of the port: ``Linear``, ``Embedding``, ``LayerNorm`` and
``gelu`` as ``torch.nn`` modules.

Counterpart of ``distributed_pytorch_tpu/nn/core.py``. Initialization
follows the same schemes (fan-in uniform for Linear weight and bias,
N(0, std) tables, unit/zero LayerNorm) drawn from an explicit
``torch.Generator``; the JAX package draws from ``jax.random``, so the
two give different numbers from one seed and the tests load JAX
weights through ``convert.from_jax_params`` instead.

Layout: ``Linear.weight`` is (out, in), PyTorch's habit, where the JAX
package stores W as (in, out); ``convert.py`` transposes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """Affine map ``x @ W.T + b``; W is (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        bound = 1.0 / math.sqrt(in_dim)
        w = torch.empty(out_dim, in_dim, dtype=dtype, device=device)
        self.weight = nn.Parameter(w.uniform_(-bound, bound,
                                              generator=generator))
        if bias:
            b = torch.empty(out_dim, dtype=dtype, device=device)
            self.bias = nn.Parameter(b.uniform_(-bound, bound,
                                                generator=generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table (vocab, dim) initialized N(0, std)."""

    def __init__(self, vocab: int, dim: int, std: float = 1.0, *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab = vocab
        self.dim = dim
        w = torch.empty(vocab, dim, dtype=dtype, device=device)
        self.weight = nn.Parameter(w.normal_(0.0, std, generator=generator))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with ``scale``/``bias`` parameters
    (the JAX package's names)."""

    def __init__(self, dim: int, eps: float = 1e-5, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, (self.dim,), self.scale, self.bias, self.eps)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
