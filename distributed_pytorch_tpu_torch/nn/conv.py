"""Convolution, BatchNorm and pooling for the ResNet-18 rung.

Counterpart of ``distributed_pytorch_tpu/nn/conv.py``. The JAX package
works in NHWC with HWIO kernels; these layers take PyTorch's NCHW with
OIHW weights (``convert.py`` permutes), and ``models/resnet.py`` turns
its NHWC input into NCHW once, at the stem, as a view: for a contiguous
NHWC tensor that view is channels_last memory, which cuDNN's NHWC
convolutions read without a copy.

``BatchNorm2d`` computes its batch statistics itself rather than through
``F.batch_norm``, which refuses a batch of one value per channel
(N * H * W = 1) that the JAX package normalizes, and cannot hold the
float32 running stats of a bfloat16 model. Its running stats are module
buffers: ``mean``, ``var`` (float32) and ``count`` (int32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..optim import mark_jax_perm

from ..runtime import context


class Conv2d(nn.Module):
    """2-D convolution, NCHW, OIHW weight, stride and padding as torch's
    ``Conv2d(padding=p)``. Kaiming-normal init with fan_out =
    ``kernel * kernel * out_ch`` (the torchvision ResNet init)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = False, groups: int = 1, *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_ch, self.out_ch, self.kernel = in_ch, out_ch, kernel
        self.stride, self.padding, self.groups = stride, padding, groups
        std = math.sqrt(2.0 / (kernel * kernel * out_ch))
        w = torch.empty(out_ch, in_ch // groups, kernel, kernel, dtype=dtype,
                        device=device)
        # OIHW here, HWIO in the JAX package
        self.weight = mark_jax_perm(nn.Parameter(
            w.normal_(0.0, std, generator=generator)), (2, 3, 1, 0))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_ch, dtype=dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def __setstate__(self, state):
        # a copy (copy.deepcopy, pickle) makes the weight anew, unmarked
        super().__setstate__(state)
        mark_jax_perm(self.weight, (2, 3, 1, 0))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        groups=self.groups)


class BatchNorm2d(nn.Module):
    """BatchNorm over N, H, W of an NCHW tensor with torch's semantics, as
    the JAX package computes them.

    In training mode (``module.training``) it normalizes with the batch
    mean and the biased batch variance, and updates the running stats
    with ``momentum``: ``mean`` with the batch mean, ``var`` with the
    unbiased variance ``var * n / max(n - 1, 1)``, and ``count`` by one.
    In eval mode it normalizes with the running stats, cast to the
    input's dtype, and changes nothing.

    ``axis_name`` (any name; the port has one data axis) makes it
    SyncBatchNorm: at world > 1 the batch statistics come from ``sum``,
    ``sum(x^2)`` and ``n`` all-reduced over the process group in one
    collective, with ``var = max(E[x^2] - E[x]^2, 0)``, and the backward
    all-reduces their cotangents. At world 1 the same formula runs on
    the local batch (the 0/1/N contract)."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.1,
                 axis_name: Optional[str] = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ch, self.eps, self.momentum = ch, eps, momentum
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(ch, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=dtype, device=device))
        self.register_buffer("mean", torch.zeros(ch, device=device))
        self.register_buffer("var", torch.ones(ch, device=device))
        self.register_buffer("count", torch.zeros((), dtype=torch.int32,
                                                  device=device))

    def _batch_stats(self, x):
        """(mean, var, n) over N, H, W: across the ranks in sync mode at
        world > 1, local otherwise."""
        n = x.shape[0] * x.shape[2] * x.shape[3]
        if self.axis_name is None:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            return mean, var, n
        s = x.sum(dim=(0, 2, 3))
        ss = (x * x).sum(dim=(0, 2, 3))
        world = context.get_world_size()
        if world > 1:
            from torch.distributed.nn.functional import all_reduce
            s, ss = all_reduce(torch.cat([s, ss])).split(self.ch)
            n *= world
        mean = s / n
        # E[x^2] - E[x]^2 can cancel slightly below zero when |mean| >>
        # std: clamped, as torch's SyncBatchNorm and the JAX package do
        return mean, torch.clamp(ss / n - mean * mean, min=0.0), n

    def forward(self, x):
        if self.training:
            mean, var, n = self._batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / max(n - 1, 1)
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
                self.count += 1
        else:
            mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        inv = torch.rsqrt(var + self.eps)
        shape = (1, -1, 1, 1)
        return ((x - mean.view(shape)) * inv.view(shape)
                * self.scale.view(shape) + self.bias.view(shape))


def max_pool(x, window: int, stride: int, padding: int = 0):
    """NCHW max pooling (torch ``MaxPool2d``; padding reads as -inf)."""
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x):
    """NCHW global average pool -> (N, C)."""
    return x.mean(dim=(2, 3))
