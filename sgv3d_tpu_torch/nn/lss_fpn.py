"""Image -> BEV backbone LSSFPN (torch port of `sgv3d_tpu.nn.lss_fpn`).

The public layouts are the JAX package's: images (B, S, N, H, W, 3), height
(BN, fH, fW, D), cells (BN, HW, D) for the top-k lift, BEV (B, Y, X, C).
The image backbone, neck and HeightNet (or MSCThead) run in bf16 under
autocast when `use_bf16` is set (on CUDA); geometry, the softmaxes, the
lift and the pooling stay float32. `fused_convs` runs the image ResNet's
identity bottlenecks through the fused kernel K3 (`nn.resnet`).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from sgv3d_tpu_torch import geom
from sgv3d_tpu_torch.config import BackboneConfig
from sgv3d_tpu_torch.nn.blocks import conv
from sgv3d_tpu_torch.nn.height_net import HeightNet
from sgv3d_tpu_torch.nn.msct_head import MSCThead
from sgv3d_tpu_torch.nn.resnet import ResNet
from sgv3d_tpu_torch.nn.second_fpn import SECONDFPN
from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward
from sgv3d_tpu_torch.ops.voxel_pooling import (
    flatten_voxel_index, topk_lift_inputs_hwd)

BG_THRESHOLD = 0.45     # SGV3D keeps a pixel while P(background) <= this


def _frustum_voxels(cfg: BackboneConfig, mats, sweep: int,
                    hwd_layout: bool) -> torch.Tensor:
    """Frustum -> ego points -> int voxel coords, shared by the lift cells
    and the cull's validity mask so that the two never disagree.
    `hwd_layout` orders the frustum (fH, fW, D, 4), the top-k layout."""
    s2e = mats["sensor2ego_mats"]
    frustum = torch.as_tensor(
        geom.make_frustum(cfg.final_dim, cfg.effective_downsample, cfg.d_bound),
        device=s2e.device)
    if hwd_layout:
        frustum = frustum.permute(1, 2, 0, 3)              # (fH, fW, D, 4)
    points = geom.get_geometry(
        frustum,
        s2e[:, sweep],
        mats["sensor2virtual_mats"][:, sweep],
        mats["intrin_mats"][:, sweep],
        mats["ida_mats"][:, sweep],
        mats["reference_heights"][:, sweep],
        mats.get("bda_mat"),
    )
    return geom.geometry_to_voxel(points, cfg.voxel_grid)


def compute_lift_cells(cfg: BackboneConfig, mats, sweep: int = 0) -> torch.Tensor:
    """BEV cell index for every frustum point: (BN, HW, D) int32 for the
    top-k lift, (B, N, D, fH, fW) for the all-bin lift. Depends only on the
    calibration, so a static rig computes it once."""
    b, _, n = mats["sensor2ego_mats"].shape[:3]
    f_h, f_w = cfg.feat_hw
    use_topk = cfg.lift_top_k is not None
    vox = _frustum_voxels(cfg, mats, sweep, hwd_layout=use_topk)
    cell = flatten_voxel_index(vox, cfg.voxel_grid.voxel_num)
    if use_topk:
        return cell.reshape(b * n, f_h * f_w, cfg.num_height_bins)
    return cell


def compute_valid_pixels(cfg: BackboneConfig, mats, sweep: int = 0,
                         margin: int = 1) -> torch.Tensor:
    """(BN, HW) bool: the pixel has a height bin whose voxel lies within the
    BEV grid grown by `margin` voxels on every axis. The margin keeps the
    cull conservative against float32 rounding between devices."""
    b, _, n = mats["sensor2ego_mats"].shape[:3]
    vox = _frustum_voxels(cfg, mats, sweep, hwd_layout=True)
    nums = torch.as_tensor(cfg.voxel_grid.voxel_num, device=vox.device)
    ok = ((vox >= -margin) & (vox < nums + margin)).all(dim=-1)
    return ok.any(dim=-1).reshape(b * n, -1)


def _lift_and_splat(cfg: BackboneConfig, height_prob, tran_feat, mats, sweep,
                    cells=None, pix_keep=None):
    """Geometry + pooling: height_prob (BN, fH, fW, D), tran_feat
    (BN, fH, fW, C) -> (B, Y, X, C) float32. `cells`: precomputed
    `compute_lift_cells` (static rig); `pix_keep`: kept pixels of the
    static-rig cull, paired with culled `cells` (top-k lift only)."""
    b, _, n = mats["sensor2ego_mats"].shape[:3]
    f_h, f_w = cfg.feat_hw
    d = cfg.num_height_bins
    grid = cfg.voxel_grid
    num_y, num_x = int(grid.voxel_num[1]), int(grid.voxel_num[0])
    k = cfg.lift_top_k
    if pix_keep is not None and (k is None or cells is None):
        raise ValueError("pixel culling needs the top-k lift and culled cells")
    cell = cells if cells is not None else compute_lift_cells(cfg, mats, sweep)

    ctx = tran_feat.float().reshape(b * n, f_h * f_w, -1)
    if k is not None:
        hp_hwd = height_prob.float().reshape(b * n, f_h * f_w, d)
        if pix_keep is not None:
            hp_hwd = hp_hwd.index_select(1, pix_keep)
            ctx = ctx.index_select(1, pix_keep)
        hp, cell = topk_lift_inputs_hwd(hp_hwd, cell, k)
    else:
        hp = height_prob.float().permute(0, 3, 1, 2).reshape(b * n, d, f_h * f_w)
        cell = cell.reshape(b * n, d, f_h * f_w)
    bev = lift_splat_forward(hp.contiguous(), ctx.contiguous(),
                             cell.contiguous(), b, num_y * num_x)
    return bev.reshape(b, num_y, num_x, -1)


class LSSFPN(nn.Module):
    """BEVHeight backbone: ResNet + SECONDFPN -> HeightNet -> lift-splat."""

    def __init__(self, cfg: BackboneConfig, use_bf16: bool = False,
                 fused_convs: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_bf16 = use_bf16
        neck_in = sum(cfg.img_neck_out_channels)
        self.img_backbone = ResNet(cfg.resnet_depth, fused=fused_convs)
        self.img_neck = SECONDFPN(cfg.resnet_out_channels,
                                  cfg.img_neck_out_channels, (0.25, 0.5, 1, 2))
        self.height_net = HeightNet(neck_in, cfg.height_net_mid_channels[0],
                                    cfg.output_channels, cfg.num_height_bins)
        self.assist_layer = conv(neck_in, 256, 1)

    def forward(self, sweep_imgs, mats: Mapping[str, torch.Tensor],
                cells=None, pix_keep=None):
        """sweep_imgs (B, S, N, H, W, 3) float32. Returns BEV (B, Y, X, C*S)
        float32 and the (assist, assist) aux pair (unused when serving).
        `cells`/`pix_keep` apply to the key sweep only."""
        cfg = self.cfg
        b, s, n = sweep_imgs.shape[:3]
        mlp_input = geom.camera_mlp_input(
            mats["intrin_mats"][:, 0], mats["ida_mats"][:, 0],
            mats["sensor2ego_mats"][:, 0], mats["bda_mat"])
        maps = []
        for sweep in range(s):
            imgs = sweep_imgs[:, sweep].reshape(b * n, *sweep_imgs.shape[3:])
            with torch.autocast(imgs.device.type, dtype=torch.bfloat16,
                                enabled=self.use_bf16):
                feat = self.img_neck(self.img_backbone(imgs.permute(0, 3, 1, 2)))
                h_logits, context = self.height_net(feat, mlp_input)
                if sweep == 0:
                    assist = self.assist_layer(feat)
            height = torch.softmax(h_logits.float(), dim=1).permute(0, 2, 3, 1)
            maps.append(_lift_and_splat(
                cfg, height, context.permute(0, 2, 3, 1), mats, sweep,
                cells if sweep == 0 else None,
                pix_keep if sweep == 0 else None))
        out = torch.cat(maps, dim=-1) if s > 1 else maps[0]
        return out, (assist, assist)


class BSMLSSFPN(nn.Module):
    """SGV3D backbone: ResNet, two SECONDFPN necks (stride 16 and 8),
    MSCThead, background suppression, lift-splat at stride 8."""

    def __init__(self, cfg: BackboneConfig, use_bf16: bool = False,
                 fused_convs: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_bf16 = use_bf16
        neck = sum(cfg.img_neck_out_channels)
        self.img_backbone = ResNet(cfg.resnet_depth, fused=fused_convs)
        self.img_neck_16 = SECONDFPN(cfg.resnet_out_channels,
                                     cfg.img_neck_out_channels, (0.25, 0.5, 1, 2))
        self.img_neck_8 = SECONDFPN(cfg.resnet_out_channels,
                                    cfg.img_neck_out_channels, (0.5, 1, 2, 4))
        self.height_net = MSCThead(neck, neck, tuple(cfg.height_net_mid_channels),
                                   cfg.num_height_bins, cfg.semantic_channels,
                                   cfg.output_channels)

    def forward(self, sweep_imgs, mats: Mapping[str, torch.Tensor],
                cells=None, pix_keep=None):
        """sweep_imgs (B, S, N, H, W, 3) float32. Returns BEV
        (B, Y, X, (C+S)*S) float32 and the key sweep's (semantic0,
        semantic1) logits, NCHW. `cells`/`pix_keep` apply to the key sweep
        only."""
        cfg = self.cfg
        b, s, n = sweep_imgs.shape[:3]
        mlp_input = geom.camera_mlp_input(
            mats["intrin_mats"][:, 0], mats["ida_mats"][:, 0],
            mats["sensor2ego_mats"][:, 0], mats["bda_mat"])
        maps = []
        for sweep in range(s):
            imgs = sweep_imgs[:, sweep].reshape(b * n, *sweep_imgs.shape[3:])
            with torch.autocast(imgs.device.type, dtype=torch.bfloat16,
                                enabled=self.use_bf16):
                feats = self.img_backbone(imgs.permute(0, 3, 1, 2))
                depth1, semantic1, context1, semantic0 = self.height_net(
                    self.img_neck_16(feats), self.img_neck_8(feats), mlp_input)
            height = torch.softmax(depth1.float(), dim=1).permute(0, 2, 3, 1)
            semantic = torch.softmax(semantic1.float(), dim=1)
            # background suppression: drop pixels with P(background) > thr
            keep = (semantic[:, 0:1] <= BG_THRESHOLD).float()
            tran_feat = torch.cat([context1.float(), semantic], dim=1) * keep
            maps.append(_lift_and_splat(
                cfg, height, tran_feat.permute(0, 2, 3, 1), mats, sweep,
                cells if sweep == 0 else None,
                pix_keep if sweep == 0 else None))
            if sweep == 0:
                aux = (semantic0, semantic1)
        out = torch.cat(maps, dim=-1) if s > 1 else maps[0]
        return out, aux
