"""Shared NN building blocks (torch port of `sgv3d_tpu.nn.blocks`).

Modules take and return NCHW tensors (channels_last memory works too).
Submodule names follow the flax parameter paths one for one, so that
`weights.from_flax` is a per-leaf layout rule. Inference only: BatchNorm is
eval-mode, dropout is absent.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sgv3d_tpu_torch.ops.resize import resize_bilinear


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         padding: int | None = None, dilation: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """Conv2d with symmetric padding, default k//2 * dilation (the JAX
    package's explicit torch-convention padding)."""
    if padding is None:
        padding = (kernel // 2) * dilation
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation, bias=bias)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 (2-D or 4-D input) with running stats.

    Holds exactly flax BatchNorm's four tensors (`scale`/`bias` params,
    `mean`/`var` stats) under torch names; no momentum, no batch counter."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.conv = conv(cin, cout, kernel)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """ResNet basic block: two 3x3 convs + identity (or 1x1-projected) skip."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, features, 3, stride, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.downsample_conv = conv(cin, features, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.project else x)
        return F.relu(out + identity)


class Mlp(nn.Module):
    """Two dense layers, always float32: the flax `Mlp` has no dtype, so
    the camera vector's SE gates stay float32 inside a bf16 region."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Camera-aware squeeze-excitation: gates `x` by a transform of `x_se`."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = conv(channels, channels, 1)
        self.conv_expand = conv(channels, channels, 1)

    def forward(self, x, x_se):
        g = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(g)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling with dilations (1, 6, 12, 18) + global
    pooling branch, fused by a 1x1 conv (dropout is inactive at eval)."""

    def __init__(self, cin: int, mid: int):
        super().__init__()
        for i, (k, d) in enumerate([(1, 1), (3, 6), (3, 12), (3, 18)]):
            setattr(self, f"aspp{i + 1}_conv",
                    conv(cin, mid, k, dilation=d, bias=False))
            setattr(self, f"aspp{i + 1}_bn", BatchNorm(mid))
        self.gap_conv = conv(cin, mid, 1, bias=False)
        self.gap_bn = BatchNorm(mid)
        self.proj_conv = conv(5 * mid, mid, 1, bias=False)
        self.proj_bn = BatchNorm(mid)

    def forward(self, x):
        branches = []
        for i in range(1, 5):
            conv_i = getattr(self, f"aspp{i}_conv")
            if conv_i.dilation[0] > 1:
                # NCHW input and weight: in bf16 channels_last cuDNN picks a
                # direct kernel ~40x slower at dilations 12 and 18 (H100:
                # 157 / 138 ms against 3.7 ms at (4, 512, 54, 96))
                y = F.conv2d(x.contiguous(), conv_i.weight.contiguous(), None,
                             1, conv_i.padding, conv_i.dilation)
            else:
                y = conv_i(x)
            branches.append(F.relu(getattr(self, f"aspp{i}_bn")(y)))
        # bilinear upsampling of a 1x1 map is a broadcast
        g = x.mean(dim=(2, 3), keepdim=True)
        g = F.relu(self.gap_bn(self.gap_conv(g)))
        branches.append(g.expand_as(branches[0]))
        out = self.proj_conv(torch.cat(branches, dim=1))
        return F.relu(self.proj_bn(out))


class SABlock(nn.Module):
    """Spatial attention: conv(x) gated by sigmoid(attention_conv(y))."""

    def __init__(self, cin_x: int, cin_y: int, channels: int):
        super().__init__()
        self.attention_conv = conv(cin_y, channels, 3, bias=False)
        self.conv = conv(cin_x, channels, 3, bias=False)

    def forward(self, x, y):
        return self.conv(x) * torch.sigmoid(self.attention_conv(y))


class TaskHead(nn.Module):
    """Two BasicBlocks + ConvBNReLU decoder + 1x1 prediction head. Returns
    (pred, feat) or, with `return_feat=False`, pred alone."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.block1 = BasicBlock(cin, mid)
        self.block2 = BasicBlock(mid, mid)
        self.decoder_out = ConvBNReLU(mid, mid, 3)
        self.head = conv(mid, out, 1)

    def forward(self, x, return_feat: bool = True):
        feat = self.decoder_out(self.block2(self.block1(x)))
        pred = self.head(feat)
        return (pred, feat) if return_feat else pred


class TaskFPN(nn.Module):
    """Upsample the coarse feature x2 (half-pixel bilinear), reduce it, and
    add the fine scale gated by spatial attention on the upsampled map."""

    def __init__(self, cin_coarse: int, cin_fine: int, out: int):
        super().__init__()
        self.reduce_conv = conv(cin_coarse, out, 3)
        self.self_attention = SABlock(cin_fine, out, out)

    def forward(self, feat0, feat1):
        up = resize_bilinear(feat0.permute(0, 2, 3, 1), scale=2)
        up = self.reduce_conv(up.permute(0, 3, 1, 2))
        return up + self.self_attention(feat1, up)


class SeparateTaskBranch(nn.Module):
    """CenterHead separate-head branch: (num_conv-1) ConvBNReLU + final bias
    conv, whose bias starts at `init_bias` (the heatmap) or zero."""

    head_conv = 64

    def __init__(self, cin: int, out_channels: int, num_conv: int = 2,
                 final_kernel: int = 3, init_bias: float | None = None):
        super().__init__()
        self.num_conv = num_conv
        c = cin
        for i in range(num_conv - 1):
            setattr(self, f"conv{i}", ConvBNReLU(c, self.head_conv, final_kernel))
            c = self.head_conv
        self.final = conv(c, out_channels, final_kernel)
        self.init_bias = init_bias
        nn.init.constant_(self.final.bias, init_bias or 0.0)

    def forward(self, x):
        for i in range(self.num_conv - 1):
            x = getattr(self, f"conv{i}")(x)
        return self.final(x)
