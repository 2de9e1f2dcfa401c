"""BEVHeight model composition (torch port of `sgv3d_tpu.models.bev_height`,
serving forward only)."""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from sgv3d_tpu_torch.config import ExpConfig
from sgv3d_tpu_torch.heads.bev_head import BEVHeightHead
from sgv3d_tpu_torch.nn.lss_fpn import BSMLSSFPN, LSSFPN


def normalize_images(imgs: torch.Tensor, cfg: ExpConfig) -> torch.Tensor:
    """Normalise raw uint8 images on the device: reverse the channels, then
    (x - mean) / std in float32, as the host-side `imnormalize` does. Float
    input is taken as already normalised."""
    if imgs.dtype != torch.uint8:
        return imgs
    x = torch.flip(imgs.float(), dims=(-1,))
    # per channel with Python scalars: no host-to-device copy, so no wait
    return torch.stack([(x[..., c] - m) / s for c, (m, s)
                        in enumerate(zip(cfg.img_mean, cfg.img_std))], dim=-1)


class BEVHeight(nn.Module):
    def __init__(self, cfg: ExpConfig, use_bf16: bool = False,
                 fused_convs: bool = False):
        super().__init__()
        self.cfg = cfg
        backbone_cls = BSMLSSFPN if cfg.backbone.is_bsm else LSSFPN
        self.backbone = backbone_cls(cfg.backbone, use_bf16, fused_convs)
        self.head = BEVHeightHead(cfg.head)

    def forward(self, sweep_imgs, mats: Mapping[str, torch.Tensor],
                cells=None, pix_keep=None):
        """sweep_imgs (B, S, N, H, W, 3) uint8 or normalised float32.
        Returns (task_preds, aux), as the JAX model does at eval: aux is the
        (assist, assist) pair for BEVHeight, the (semantic0, semantic1)
        logits for SGV3D."""
        sweep_imgs = normalize_images(sweep_imgs, self.cfg)
        bev, aux = self.backbone(sweep_imgs, mats, cells, pix_keep)
        return self.head(bev), aux
