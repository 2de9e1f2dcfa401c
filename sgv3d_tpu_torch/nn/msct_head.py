"""MSCThead (torch port of `sgv3d_tpu.nn.msct_head`): the two-scale
multi-task image head of the BSM backbone. NCHW in and out.

Stage one at stride 16 (semantic head, context conv) -> three TaskFPNs up
to stride 8 -> stage two (height-bin head, semantic head, context convs),
with camera-aware SE gates on both scales and ASPP on the coarse one. The
reference's `depth_head0` returns its input unchanged, so it is an identity
here with no module and no weights, as in the JAX package.
"""
from __future__ import annotations

from torch import nn

from sgv3d_tpu_torch.nn.blocks import (
    ASPP, BatchNorm, ConvBNReLU, Mlp, SELayer, TaskFPN, TaskHead, conv)


class MSCThead(nn.Module):
    def __init__(self, cin0: int, cin1: int, mid_channels=(512, 256),
                 depth_channels: int = 90, semantic_channels: int = 7,
                 context_channels: int = 80):
        super().__init__()
        m0, m1 = mid_channels
        self.mlp_bn = BatchNorm(27)
        self.reduce_conv0 = ConvBNReLU(cin0, m0, 3)
        self.reduce_conv1 = ConvBNReLU(cin1, m1, 3)
        self.scale0_mlp = Mlp(27, m0, m0)
        self.scale1_mlp = Mlp(27, m1, m1)
        self.scale0_se = SELayer(m0)
        self.scale1_se = SELayer(m1)
        self.aspp = ASPP(m0, m0)
        self.semantic_head0 = TaskHead(m0, m0, semantic_channels)
        self.context_conv0 = ConvBNReLU(m0, m0, 3)
        self.depth_fpn = TaskFPN(m0, m1, m1)
        self.semantic_fpn = TaskFPN(m0, m1, m1)
        self.context_fpn = TaskFPN(m0, m1, m1)
        self.depth_head1 = TaskHead(m1, m1, depth_channels)
        self.semantic_head1 = TaskHead(m1, m1, semantic_channels)
        self.context_conv1a = ConvBNReLU(m1, m1, 3)
        self.context_conv1b = conv(m1, context_channels, 1)

    def forward(self, feat16, feat8, mlp_input):
        """feat16 (BN, C0, H16, W16), feat8 (BN, C1, H8, W8), mlp_input
        (BN, 27). Returns (depth1 (BN, D, H8, W8), semantic1 (BN, S, H8, W8),
        context1 (BN, Cctx, H8, W8), semantic0 (BN, S, H16, W16)) logits."""
        mlp_input = self.mlp_bn(mlp_input)
        f0 = self.reduce_conv0(feat16)
        f1 = self.reduce_conv1(feat8)
        f0 = self.scale0_se(f0, self.scale0_mlp(mlp_input)[:, :, None, None])
        f1 = self.scale1_se(f1, self.scale1_mlp(mlp_input)[:, :, None, None])
        f0 = self.aspp(f0)

        # stage one, stride 16 (depth_head0 is the identity)
        semantic0, semantic_feat = self.semantic_head0(f0)
        context_feat = self.context_conv0(f0)

        depth_feat = self.depth_fpn(f0, f1)
        semantic_feat = self.semantic_fpn(semantic_feat, f1)
        context_feat = self.context_fpn(context_feat, f1)

        # stage two, stride 8
        depth1 = self.depth_head1(depth_feat, return_feat=False)
        semantic1 = self.semantic_head1(semantic_feat, return_feat=False)
        context1 = self.context_conv1b(self.context_conv1a(context_feat))
        return depth1, semantic1, context1, semantic0
