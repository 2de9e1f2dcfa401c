"""CenterPoint-style BEV detection head (torch port of
`sgv3d_tpu.heads.bev_head`): a 3-stage ResNet-18 trunk without maxpool, a
SECONDFPN neck, a shared conv and 6 branches per task.

float32 by default (the reference pins the head to float32).
`dtype=torch.bfloat16` is the JAX head's `dtype=bfloat16`, an opt-in
serving approximation: the input is cast to bf16 and the whole head runs
under bf16 autocast, as the image side does. Every flax module of the head
is given the dtype, so every conv, transposed conv and residual add
computes in bf16; BatchNorm computes in float32 and returns the input's
dtype, as flax's `BatchNorm(dtype=bf16)` does. Each task output is cast
back to float32 before decode.
"""
from __future__ import annotations

import torch
from torch import nn

from sgv3d_tpu_torch.config import HeadConfig
from sgv3d_tpu_torch.nn.blocks import ConvBNReLU, SeparateTaskBranch
from sgv3d_tpu_torch.nn.resnet import ResNet
from sgv3d_tpu_torch.nn.second_fpn import SECONDFPN
from sgv3d_tpu_torch.train.profiling import span


class BEVHeightHead(nn.Module):
    def __init__(self, cfg: HeadConfig, dtype: torch.dtype | None = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"BEVHeightHead: dtype {dtype} is neither "
                             f"float32 nor bfloat16")
        self.cfg = cfg
        self.dtype = dtype
        cin = cfg.bev_backbone_in_channels
        base = cfg.bev_backbone_base_channels
        self.trunk = ResNet(18, cin, base, num_stages=3, strides=(1, 2, 2),
                            with_maxpool=False)
        self.neck = SECONDFPN((cin, base, base * 2, base * 4),
                              cfg.bev_neck_out_channels,
                              cfg.bev_neck_upsample_strides)
        self.shared_conv = ConvBNReLU(sum(cfg.bev_neck_out_channels),
                                      cfg.share_conv_channels, 3)
        self.branch_names = []
        for ti, task in enumerate(cfg.tasks):
            heads = [(name, out_ch, num_conv, None)
                     for name, (out_ch, num_conv) in cfg.common_heads]
            heads.append(("heatmap", task.num_classes, 2, cfg.init_bias))
            names = []
            for name, out_ch, num_conv, init_bias in heads:
                setattr(self, f"task{ti}_{name}", SeparateTaskBranch(
                    cfg.share_conv_channels, out_ch, num_conv=num_conv,
                    final_kernel=cfg.final_kernel, init_bias=init_bias))
                names.append(name)
            self.branch_names.append(names)

    def forward(self, bev):
        """bev (B, Y, X, C). Returns a list over tasks of dicts of (B, H, W, c)
        float32 tensors: reg, height, dim, rot, vel, heatmap. Its stages
        are the spans `sgv3d.head.trunk`, `.neck`, `.shared_conv` and
        `.branches` (`train.profiling.span`)."""
        bf16 = self.dtype == torch.bfloat16
        x = bev.to(torch.bfloat16 if bf16 else torch.float32)
        x = x.permute(0, 3, 1, 2).contiguous()
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            with span("head.trunk"):
                feats = self.trunk(x)
            with span("head.neck"):
                x = self.neck([x] + feats)
            with span("head.shared_conv"):
                x = self.shared_conv(x)
            with span("head.branches"):
                return [{name: getattr(self, f"task{ti}_{name}")(x).float()
                         .permute(0, 2, 3, 1) for name in names}
                        for ti, names in enumerate(self.branch_names)]
