"""ThinResnet — a resnet-34-style audio backbone (port of
``voicepuppet_tpu/models/backbone.py``; ref: voicepuppet/atvgnet/
backbone.py:14-164).

No model of the reference imports it; it is carried, as in the JAX
package, so that every module there has its counterpart.  A 7x7 stem and
a [4,1] max pool, then eleven 3-conv bottleneck blocks (48/96/128/output
channels) whose main paths apply relu after every conv, the last one
included (a quirk of the reference, backbone.py:41-48), the conv blocks
adding a strided 1x1-projection shortcut (backbone.py:83-96), and a mean
over time (backbone.py:160).  NHWC ``[B, T, F, C]`` in, ``[B, F',
output_channels]`` out; NCHW inside.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.models.layers import (SameConv2d, TFBatchNorm,
                                             max_pool_same)


class _ConvBNRelu(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, kernel, stride)
        self.TFBatchNorm_0 = TFBatchNorm(features)

    def forward(self, x, train: bool = False):
        return F.relu(self.TFBatchNorm_0(self.Conv_0(x), train))


class _Block(nn.Module):
    """Three conv + BN + relu; with ``strides`` a conv block whose
    shortcut is a strided 1x1 conv + BN (backbone.py:54-96), else an
    identity block (backbone.py:22-52)."""

    def __init__(self, in_ch: int, filters: Tuple[int, int, int],
                 strides: Optional[Tuple[Tuple[int, int], ...]] = None):
        super().__init__()
        kernels = ((1, 1), (3, 3), (1, 1))
        self.projected = strides is not None
        ch = in_ch
        for i, (f, k, s) in enumerate(zip(filters, kernels,
                                          strides or ((1, 1),) * 3)):
            self.add_module(f"_ConvBNRelu_{i}", _ConvBNRelu(ch, f, k, s))
            ch = f
        if self.projected:
            self.Conv_0 = SameConv2d(in_ch, filters[-1], kernels[-1],
                                     strides[1])
            self.TFBatchNorm_0 = TFBatchNorm(filters[-1])

    def forward(self, x, train: bool = False):
        short = x
        for i in range(3):
            x = getattr(self, f"_ConvBNRelu_{i}")(x, train)
        if self.projected:
            short = self.TFBatchNorm_0(self.Conv_0(short), train)
        return F.relu(x + short)


class ThinResnet(nn.Module):
    # (filters, strides) of the eleven blocks (backbone.py JAX :75-92)
    _DOWN_H = ((1, 1), (2, 1), (1, 1))
    _DOWN_HW = ((1, 1), (2, 2), (1, 1))

    def __init__(self, in_ch: int = 1, output_channels: int = 256):
        super().__init__()
        o = output_channels
        plan = (((48, 48, 96), self._DOWN_H), ((48, 48, 96), None),
                ((96, 96, 128), self._DOWN_H), ((96, 96, 128), None),
                ((96, 96, 128), None), ((128, 128, 128), self._DOWN_HW),
                ((128, 128, 128), self._DOWN_HW), ((128, 128, 128), None),
                ((128, 128, o), self._DOWN_H), ((128, 128, o), None),
                ((128, 128, o), None))
        self._ConvBNRelu_0 = _ConvBNRelu(in_ch, 64, (7, 7))
        ch = 64
        for i, (filters, strides) in enumerate(plan):
            self.add_module(f"_Block_{i}", _Block(ch, filters, strides))
            ch = filters[-1]
        self.num_blocks = len(plan)

    def forward(self, x, train: bool = False):
        x = self._ConvBNRelu_0(x.permute(0, 3, 1, 2), train)
        x = max_pool_same(x, (4, 1), (4, 1))
        for i in range(self.num_blocks):
            x = getattr(self, f"_Block_{i}")(x, train)
        return x.mean(dim=2).permute(0, 2, 1)
