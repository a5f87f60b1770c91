"""Core layers of the port: ``Linear``, ``Embedding``, ``LayerNorm``,
``Dropout`` and ``Sequential`` as ``torch.nn`` modules, and ``relu`` and
``gelu``.

Counterpart of ``distributed_pytorch_tpu/nn/core.py``. Initialization
follows the same schemes (fan-in uniform for Linear weight and bias,
N(0, std) tables, unit/zero LayerNorm) drawn from an explicit
``torch.Generator``; the JAX package draws from ``jax.random``, so the
two give different numbers from one seed and the tests load JAX
weights through ``convert.from_jax_params`` instead.

Layout: ``Linear.weight`` is (out, in), PyTorch's habit, where the JAX
package stores W as (in, out); ``convert.py`` transposes, and the weight
carries that transpose as its ``optim.jax_perm`` (``adamw_8bit`` blocks
its moments in the JAX layout).

``ops.quant.quantize_tree`` may replace a ``Linear`` / ``Embedding``
weight with int8 buffers (``weight`` is then None); both layers read
their weight through ``ops.quant.resolve_weight``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import resolve_weight
from ..optim import mark_jax_perm


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
        self.weight = mark_jax_perm(nn.Parameter(
            w.uniform_(-bound, bound, generator=generator)), (1, 0))
        if bias:
            b = torch.empty(out_dim, dtype=dtype, device=device)
            self.bias = nn.Parameter(b.uniform_(-bound, bound,
                                                generator=generator))
        else:
            self.register_parameter("bias", None)

    def __setstate__(self, state):
        # a copy (copy.deepcopy, pickle) makes the weight anew, unmarked
        super().__setstate__(state)
        if self.weight is not None:
            mark_jax_perm(self.weight, (1, 0))

    def forward(self, x):
        return F.linear(x, resolve_weight(self), self.bias)


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
        if self.weight is None:
            # int8 table (ops/quant.py): gather the int8 rows, then
            # dequantize them in the model dtype
            dt = self.weight_dtype
            return self.weight_q[ids].to(dt) * self.weight_scale.to(dt)
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


class Dropout(nn.Module):
    """Dropout with an explicit ``torch.Generator``: in training, with
    ``rate > 0`` and a generator, each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``; otherwise the identity
    (the JAX package drops only given ``rng=`` and ``train=True``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate <= 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class Sequential(nn.Module):
    """Named chain of modules: ``layers`` is a sequence of ``(name,
    module)`` pairs, each registered under its name (the JAX package's
    param tree nests under the same names). Keyword arguments of the
    call go to every layer."""

    def __init__(self, layers: Sequence[Tuple[str, nn.Module]]):
        super().__init__()
        self.names = [name for name, _ in layers]
        for name, mod in layers:
            self.add_module(name, mod)

    def forward(self, x, **kwargs):
        for name in self.names:
            x = getattr(self, name)(x, **kwargs)
        return x


def relu(x):
    return F.relu(x)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
