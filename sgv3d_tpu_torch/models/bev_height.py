"""BEVHeight model composition and training losses (torch port of
`sgv3d_tpu.models.bev_height`)."""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from sgv3d_tpu_torch.config import ExpConfig
from sgv3d_tpu_torch.heads.bev_head import BEVHeightHead
from sgv3d_tpu_torch.heads.losses import head_loss
from sgv3d_tpu_torch.heads.targets import get_targets
from sgv3d_tpu_torch.losses.focal import multiclass_focal_loss
from sgv3d_tpu_torch.nn import bev_slabs
from sgv3d_tpu_torch.nn.lss_fpn import BSMLSSFPN, LSSFPN
from sgv3d_tpu_torch.ops.resize import resize_bilinear
from sgv3d_tpu_torch.train.profiling import span


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
    """`head_dtype`: the BEV head's compute dtype (None: float32, the
    reference's; torch.bfloat16: the opt-in serving approximation,
    `heads.bev_head`). `bev_devices` (two or more; the counterpart of the
    JAX model's `bev_sharding`, `train.sharding.bev_sharding`) splits the
    lift's map into that many equal row slabs, slab i on bev_devices[i],
    runs the head over them (`nn.bev_slabs`) and gathers each task's
    outputs in row order to the map's device, so that decode and the
    losses see the map the unsplit head gives."""

    def __init__(self, cfg: ExpConfig, use_bf16: bool = False,
                 fused_convs: bool = False,
                 head_dtype: torch.dtype | None = None,
                 bev_devices=None):
        super().__init__()
        self.cfg = cfg
        backbone_cls = BSMLSSFPN if cfg.backbone.is_bsm else LSSFPN
        self.backbone = backbone_cls(cfg.backbone, use_bf16, fused_convs)
        self.head = BEVHeightHead(cfg.head, dtype=head_dtype)
        self.bev_devices = (None if bev_devices is None or len(bev_devices) < 2
                            else [bev_slabs.canonical_device(d) for d in bev_devices])
        self.head_replicas = None

    def replicate_head(self) -> None:
        """Copy the head's weights once to each bev device, for serving;
        until then (training) each forward moves them by a differentiable
        `.to()`. A later change of the weights is not seen."""
        self.head_replicas = bev_slabs.Replicas(self.head, self.bev_devices)

    def forward(self, sweep_imgs, mats: Mapping[str, torch.Tensor],
                cells=None, pix_keep=None, train: bool = False):
        """sweep_imgs (B, S, N, H, W, 3) uint8 or normalised float32.
        Returns (task_preds, aux), as the JAX model does: aux is the
        (assist, assist) pair for BEVHeight, the (semantic0, semantic1)
        logits for SGV3D, NCHW. `train=True` is the train step's forward
        (all-bin lift with its gradient, `nn.lss_fpn`); BatchNorm and
        dropout follow `module.train()`. The head runs in the span
        `sgv3d.head` (`train.profiling.span`)."""
        sweep_imgs = normalize_images(sweep_imgs, self.cfg)
        bev, aux = self.backbone(sweep_imgs, mats, cells, pix_keep, train=train)
        with span("head"):
            if self.bev_devices is None:
                return self.head(bev), aux
            slabs = bev_slabs.split(bev.permute(0, 3, 1, 2), self.bev_devices,
                                    bev_slabs.total_stride(self.head), self.head_replicas)
            return [{name: bev_slabs.gather(s, bev.device).permute(0, 2, 3, 1)
                     for name, s in task.items()}
                    for task in bev_slabs.head(self.head, slabs)], aux


def downsample_semantic_labels(gt_semantic: torch.Tensor,
                               factor: int) -> torch.Tensor:
    """Max-pool class-id labels to the prediction stride: (B, N, H, W) ->
    (B*N, H/f, W/f) int64."""
    b, n, h, w = gt_semantic.shape
    x = gt_semantic.reshape(b * n, h // factor, factor, w // factor, factor)
    return x.amax(dim=(2, 4)).long()


def semantic_loss(cfg: ExpConfig, aux_preds, gt_semantic: torch.Tensor) -> torch.Tensor:
    """Two-scale semantic focal loss (SGV3D): aux_preds (semantic0
    (BN, S, H16, W16), semantic1 (BN, S, H8, W8)) logits, NCHW;
    gt_semantic (B, N, H, W) class ids at the input resolution."""
    semantic0, semantic1 = aux_preds
    up0 = resize_bilinear(semantic0.float().permute(0, 2, 3, 1), scale=2,
                          align_corners=False)
    labels = downsample_semantic_labels(gt_semantic,
                                        cfg.backbone.downsample_factor // 2)
    loss0 = multiclass_focal_loss(up0, labels)
    loss1 = multiclass_focal_loss(semantic1.float().permute(0, 2, 3, 1), labels)
    return (loss0 + loss1) / 2.0


def embed_loss(aux_preds, gt_embeds: torch.Tensor) -> torch.Tensor:
    """Embedding-distillation aux of the non-BSM BEVHeight: MSE of the
    assist features (BN, 256, h16, w16), NCHW, against gt_embeds
    (B, N, h16, w16, 256), x1000."""
    assist = aux_preds[0].float().permute(0, 2, 3, 1)
    b, n = gt_embeds.shape[:2]
    target = gt_embeds.reshape(b * n, *gt_embeds.shape[2:]).float()
    return ((assist - target) ** 2).mean() * 1000.0


def train_loss(cfg: ExpConfig, preds, aux, gt_boxes, gt_labels,
               gt_semantic=None, gt_embeds=None):
    """Total training loss and its metrics, under the JAX package's names.

    preds: the head's outputs; aux: the backbone's (semantic logits for
    SGV3D, assist features otherwise); gt_boxes (B, K, 9) and gt_labels
    (B, K) with -1 padding; gt_semantic (B, N, H, W) class-id masks (SGV3D
    semantic aux); gt_embeds (B, N, h16, w16, C) (BEVHeight distillation
    aux). Returns (loss, metrics)."""
    targets = get_targets(cfg.head, gt_boxes, gt_labels)
    det_loss, metrics = head_loss(cfg.head, targets, preds)
    metrics["detection_loss"] = det_loss
    total = det_loss
    if cfg.is_train_height and cfg.backbone.is_bsm and gt_semantic is not None:
        sem = semantic_loss(cfg, aux, gt_semantic)
        metrics["semantic_loss"] = sem
        total = total + cfg.semantic_loss_weight * sem
    if (cfg.is_train_height and not cfg.backbone.is_bsm
            and gt_embeds is not None):
        emb = embed_loss(aux, gt_embeds)
        metrics["depth_loss"] = emb
        total = total + emb
    metrics["total_loss"] = total
    return total, metrics
