"""ResNet-18: the vision rung (BASELINE.md: ResNet-18 on CIFAR-10).

Counterpart of ``distributed_pytorch_tpu/models/resnet.py``: the
torchvision resnet18 structure (7x7/2 stem + max pool, four stages of
two ``BasicBlock``s at 64/128/256/512 channels, stride 2 from the second
stage, global average pool, fc); ``small_input=True`` takes the CIFAR
stem (3x3/1, no max pool). Blocks are named ``s{stage}b{block}`` and
their layers as in the JAX param tree, so ``convert.from_jax_params``
and ``from_jax_state`` load a JAX model's weights and running stats.

The model takes the JAX model's NHWC images and turns them into NCHW
once, at the stem, as a view (channels_last memory, which the weights
share). Whether BatchNorm uses batch statistics follows
``module.training``. ``sync_bn=True`` makes every BatchNorm a
SyncBatchNorm over the process group (``nn/conv.py``); by default each
rank normalizes with its own batch, as torch DDP's BatchNorm does.

The model is built on the card unless ``device`` says otherwise; with no
CUDA device and no explicit device it raises. Parameters take ``dtype``;
the running stats stay float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv import BatchNorm2d, Conv2d, global_avg_pool, max_pool
from ..nn.core import Linear, relu
from ..runtime.device import DeviceLike, resolve_device


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 bn_axis: Optional[str] = None, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                            generator=generator, **kw)
        self.bn1 = BatchNorm2d(out_ch, axis_name=bn_axis, **kw)
        self.conv2 = Conv2d(out_ch, out_ch, 3, stride=1, padding=1,
                            generator=generator, **kw)
        self.bn2 = BatchNorm2d(out_ch, axis_name=bn_axis, **kw)
        self.ds_conv = self.ds_bn = None
        if stride != 1 or in_ch != out_ch:
            self.ds_conv = Conv2d(in_ch, out_ch, 1, stride=stride,
                                  generator=generator, **kw)
            self.ds_bn = BatchNorm2d(out_ch, axis_name=bn_axis, **kw)

    def forward(self, x):
        h = relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        idn = x if self.ds_conv is None else self.ds_bn(self.ds_conv(x))
        return relu(h + idn)


class ResNet18(nn.Module):
    """``forward(x)``: NHWC images (N, H, W, in_ch) -> logits
    (N, n_classes)."""

    def __init__(self, n_classes: int = 10, in_ch: int = 3,
                 small_input: bool = False, sync_bn: bool = False,
                 bn_axis: str = "dp", *, dtype=torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.small_input = small_input
        axis = bn_axis if sync_bn else None
        kw = dict(dtype=dtype, device=device)
        if small_input:
            self.stem = Conv2d(in_ch, 64, 3, stride=1, padding=1,
                               generator=generator, **kw)
        else:
            self.stem = Conv2d(in_ch, 64, 7, stride=2, padding=3,
                               generator=generator, **kw)
        self.bn_stem = BatchNorm2d(64, axis_name=axis, **kw)
        self.block_names = []
        cfg = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for si, (cin, cout, stride) in enumerate(cfg):
            for bi, (a, s) in enumerate(((cin, stride), (cout, 1))):
                name = f"s{si}b{bi}"
                self.add_module(name, BasicBlock(a, cout, s, bn_axis=axis,
                                                 generator=generator, **kw))
                self.block_names.append(name)
        self.fc = Linear(512, n_classes, generator=generator, **kw)
        # the conv weights in the activations' channels_last layout
        self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.stem.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.weight.dtype

    def forward(self, x):
        x = x.to(self.device, self.dtype).permute(0, 3, 1, 2)
        h = relu(self.bn_stem(self.stem(x)))
        if not self.small_input:
            h = max_pool(h, 3, 2, padding=1)
        for name in self.block_names:
            h = getattr(self, name)(h)
        return self.fc(global_avg_pool(h))
