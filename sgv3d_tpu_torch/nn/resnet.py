"""ResNet backbone (torch port of `sgv3d_tpu.nn.resnet`), NCHW.

Image backbones: ResNet-50/101 with a 7x7 stem + maxpool and 4 bottleneck
stages. BEV trunk: ResNet-18 with `base_channels`, 3 stages, strides
(1, 2, 2), no maxpool. Every stage's output is returned.

`fused=True` (serving, bf16, depth >= 50) runs every block after a stage's
first, a stride-1 identity bottleneck, through the fused kernel K3
(`ops.fused_bottleneck`) with BatchNorm folded into its weights. The folds
are made once by `fold()`, after the weights are loaded and moved, and are
not part of the state_dict: its keys are the same with `fused` on or off.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sgv3d_tpu_torch.nn.blocks import BasicBlock, BatchNorm, conv
from sgv3d_tpu_torch.ops.fused_bottleneck import fold_bottleneck, fused_bottleneck

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) bottleneck, pytorch-style stride on 3x3."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.project = stride != 1 or cin != planes * 4
        if self.project:
            self.downsample_conv = conv(cin, planes * 4, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.project else x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 with_maxpool: bool = True, fused: bool = False):
        super().__init__()
        if fused and depth < 50:
            raise ValueError(f"fused identity bottlenecks need a bottleneck "
                             f"ResNet (depth >= 50), not depth {depth}")
        self.with_maxpool = with_maxpool
        self.fused = fused
        self._folded = None     # block name -> FoldedBottleneck, by fold()
        self.stem_conv = conv(in_channels, base_channels, 7, 2, bias=False)
        self.stem_bn = BatchNorm(base_channels)
        use_bottleneck = depth >= 50
        self.stages = []
        c = base_channels
        for stage, (num_blocks, stride) in enumerate(
                zip(STAGE_BLOCKS[depth][:num_stages], strides)):
            planes = base_channels * (2 ** stage)
            names = []
            for b in range(num_blocks):
                s = stride if b == 0 else 1
                name = f"layer{stage + 1}_block{b}"
                if use_bottleneck:
                    setattr(self, name, Bottleneck(c, planes, s))
                    c = planes * 4
                else:
                    setattr(self, name, BasicBlock(c, planes, s))
                    c = planes
                names.append(name)
            self.stages.append(names)

    def fold(self) -> None:
        """Fold the identity bottlenecks' BatchNorms for K3, on the
        parameters' current device."""
        self._folded = {name: fold_bottleneck(getattr(self, name))
                        for names in self.stages for name in names[1:]}

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        if self.with_maxpool:
            x = F.max_pool2d(x, 3, 2, 1)
        if self.fused:
            if self.training or x.dtype != torch.bfloat16 or self._folded is None:
                raise RuntimeError(
                    f"ResNet(fused=True) serves in eval mode on bf16 "
                    f"activations after fold(); training={self.training}, "
                    f"dtype={x.dtype}, folded={self._folded is not None}")
        outs = []
        for names in self.stages:
            for i, name in enumerate(names):
                if self.fused and i > 0:
                    x = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(),
                                         self._folded[name]).permute(0, 3, 1, 2)
                else:
                    x = getattr(self, name)(x)
            outs.append(x)
        return outs
