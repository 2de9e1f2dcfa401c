"""Image -> BEV backbone LSSFPN (torch port of `sgv3d_tpu.nn.lss_fpn`).

The public layouts are the JAX package's: images (B, S, N, H, W, 3), height
(BN, fH, fW, D), cells (BN, HW, D) for the top-k lift, BEV (B, Y, X, C).
The image backbone, neck and HeightNet (or MSCThead) run in bf16 under
autocast when `use_bf16` is set (on CUDA); geometry, the softmaxes, the
lift and the pooling stay float32. `fused_convs` runs the image ResNet's
identity bottlenecks through the fused kernel K3 (`nn.resnet`).

`train=True` (the train step's forward) pools all height bins through the
autograd function `ops.lift_splat.LiftSplat` (K2 forward, K2b backward on
the card), or with `cfg.train_lift_top_k` the top-k bins picked by
`ops.lift_splat.TopkCells` (K1 with its bins; the picked bins take the
gradient), detaches the BEV maps of past sweeps, and with
`cfg.remat_backbone` recomputes the image ResNet in the backward
(`torch.utils.checkpoint`).

Under a running `torch.profiler` the image side (backbone to HeightNet or
MSCThead) is the span `sgv3d.image` and each sweep's lift (K1 and K2)
`sgv3d.lift` (`train.profiling.span`), holding `sgv3d.lift.topk` (the
top-k pick, K1, with the cells it gathers from the rig's table) and
`sgv3d.lift.splat` (the pooling, K2).
"""
from __future__ import annotations

import contextlib
from typing import Mapping

import torch
import torch.utils.checkpoint
from torch import nn

from sgv3d_tpu_torch import geom
from sgv3d_tpu_torch.config import BackboneConfig
from sgv3d_tpu_torch.nn.blocks import BatchNorm, conv
from sgv3d_tpu_torch.nn.height_net import HeightNet
from sgv3d_tpu_torch.nn.msct_head import MSCThead
from sgv3d_tpu_torch.nn.resnet import ResNet
from sgv3d_tpu_torch.nn.second_fpn import SECONDFPN
from sgv3d_tpu_torch.ops.lift_splat import LiftSplat, lift_splat_forward
from sgv3d_tpu_torch.ops.voxel_pooling import (
    flatten_voxel_index, topk_lift_inputs_hwd)
from sgv3d_tpu_torch.train.profiling import span

BG_THRESHOLD = 0.45     # SGV3D keeps a pixel while P(background) <= this


def background_keep(semantic: torch.Tensor) -> torch.Tensor:
    """SGV3D's background suppression: (BN, 1, H, W) 1.0 where the pixel's
    P(background) (`semantic` (BN, S, H, W) probabilities, channel 0) is at
    most BG_THRESHOLD, else 0.0."""
    return (semantic[:, 0:1] <= BG_THRESHOLD).float()


def _lift_k(cfg: BackboneConfig, train: bool) -> int | None:
    """The active top-k lift knob: `lift_top_k` at eval (the deploy
    default), `train_lift_top_k` in training, where None (the default)
    pools all bins so that gradients reach every height bin."""
    return cfg.train_lift_top_k if train else cfg.lift_top_k


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


def compute_lift_cells(cfg: BackboneConfig, mats, sweep: int = 0,
                       train: bool = False) -> torch.Tensor:
    """BEV cell index for every frustum point: (BN, HW, D) int32 for the
    top-k lift, (B, N, D, fH, fW) for the all-bin lift (`_lift_k(cfg,
    train)` picks). Depends only on the calibration, so a static rig
    computes it once."""
    b, _, n = mats["sensor2ego_mats"].shape[:3]
    f_h, f_w = cfg.feat_hw
    use_topk = _lift_k(cfg, train) is not None
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
                    cells=None, pix_keep=None, train: bool = False):
    """Geometry + pooling: height_prob (BN, fH, fW, D), tran_feat
    (BN, fH, fW, C) -> (B, Y, X, C) float32. `cells`: precomputed
    `compute_lift_cells` (static rig); `pix_keep`: kept pixels of the
    static-rig cull, paired with culled `cells` (top-k lift only).
    `train`: the lift goes through `LiftSplat`, which carries the
    gradient, and a top-k training lift picks through `TopkCells`."""
    b, _, n = mats["sensor2ego_mats"].shape[:3]
    f_h, f_w = cfg.feat_hw
    d = cfg.num_height_bins
    grid = cfg.voxel_grid
    num_y, num_x = int(grid.voxel_num[1]), int(grid.voxel_num[0])
    k = _lift_k(cfg, train)
    if pix_keep is not None and (k is None or cells is None):
        raise ValueError("pixel culling needs the top-k lift and culled cells")
    cell = cells if cells is not None else compute_lift_cells(cfg, mats, sweep,
                                                               train)

    ctx = tran_feat.float().reshape(b * n, f_h * f_w, -1)
    if k is not None:
        with span("lift.topk"):
            hp_hwd = height_prob.float().reshape(b * n, f_h * f_w, d)
            if pix_keep is not None:
                hp_hwd = hp_hwd.index_select(1, pix_keep)
                ctx = ctx.index_select(1, pix_keep)
            hp, cell = topk_lift_inputs_hwd(hp_hwd, cell, k, train)
    else:
        hp = height_prob.float().permute(0, 3, 1, 2).reshape(b * n, d, f_h * f_w)
        cell = cell.reshape(b * n, d, f_h * f_w)
    args = (hp.contiguous(), ctx.contiguous(), cell.contiguous(), b,
            num_y * num_x)
    with span("lift.splat"):
        if train:
            # the backward tiles the uncut fH x fW map in 2-D patches
            bev = LiftSplat.apply(*args, f_w if pix_keep is None else None)
        else:
            bev = lift_splat_forward(*args)
    return bev.reshape(b, num_y, num_x, -1)


@contextlib.contextmanager
def _frozen_running_stats(module: nn.Module):
    """Within the block, the module's train-mode BatchNorms leave their
    running statistics as they are."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.freeze_stats = True
    try:
        yield
    finally:
        for m in bns:
            del m.freeze_stats          # back to the class's False


def _image_features(backbone: nn.Module, imgs, remat: bool):
    """The image ResNet's stage outputs; with `remat`, recomputed in the
    backward instead of kept (`torch.utils.checkpoint`). The recompute
    runs the train-mode BatchNorms again on the same input, so it freezes
    their running statistics: each is updated once a forward, as flax's
    `nn.remat` does."""
    if not remat:
        return backbone(imgs)
    calls = []

    def run(x):
        ctx = _frozen_running_stats(backbone) if calls else contextlib.nullcontext()
        calls.append(1)
        with ctx:
            return tuple(backbone(x))

    return list(torch.utils.checkpoint.checkpoint(run, imgs, use_reentrant=False))


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
                cells=None, pix_keep=None, train: bool = False):
        """sweep_imgs (B, S, N, H, W, 3) float32. Returns BEV (B, Y, X, C*S)
        float32 and the key sweep's (assist, assist) aux pair, NCHW (the
        embedding loss's input). `cells`/`pix_keep` apply to the key sweep
        only; `train` see the module docstring."""
        cfg = self.cfg
        b, s, n = sweep_imgs.shape[:3]
        mlp_input = geom.camera_mlp_input(
            mats["intrin_mats"][:, 0], mats["ida_mats"][:, 0],
            mats["sensor2ego_mats"][:, 0], mats["bda_mat"])
        remat = cfg.remat_backbone and train
        maps = []
        for sweep in range(s):
            # past sweeps feed the BEV map but get no gradient
            with torch.set_grad_enabled(torch.is_grad_enabled() and sweep == 0):
                imgs = sweep_imgs[:, sweep].reshape(b * n, *sweep_imgs.shape[3:])
                with span("image"), torch.autocast(
                        imgs.device.type, dtype=torch.bfloat16, enabled=self.use_bf16):
                    feat = self.img_neck(_image_features(
                        self.img_backbone, imgs.permute(0, 3, 1, 2),
                        remat and sweep == 0))
                    h_logits, context = self.height_net(feat, mlp_input)
                    if sweep == 0:
                        assist = self.assist_layer(feat)
                height = torch.softmax(h_logits.float(), dim=1).permute(0, 2, 3, 1)
                with span("lift"):
                    maps.append(_lift_and_splat(
                        cfg, height, context.permute(0, 2, 3, 1), mats, sweep,
                        cells if sweep == 0 else None,
                        pix_keep if sweep == 0 else None, train))
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
                cells=None, pix_keep=None, train: bool = False):
        """sweep_imgs (B, S, N, H, W, 3) float32. Returns BEV
        (B, Y, X, (C+S)*S) float32 and the key sweep's (semantic0,
        semantic1) logits, NCHW. `cells`/`pix_keep` apply to the key sweep
        only; `train` see the module docstring."""
        cfg = self.cfg
        b, s, n = sweep_imgs.shape[:3]
        mlp_input = geom.camera_mlp_input(
            mats["intrin_mats"][:, 0], mats["ida_mats"][:, 0],
            mats["sensor2ego_mats"][:, 0], mats["bda_mat"])
        remat = cfg.remat_backbone and train
        maps = []
        for sweep in range(s):
            # past sweeps feed the BEV map but get no gradient
            with torch.set_grad_enabled(torch.is_grad_enabled() and sweep == 0):
                imgs = sweep_imgs[:, sweep].reshape(b * n, *sweep_imgs.shape[3:])
                with span("image"), torch.autocast(
                        imgs.device.type, dtype=torch.bfloat16, enabled=self.use_bf16):
                    feats = _image_features(self.img_backbone,
                                            imgs.permute(0, 3, 1, 2),
                                            remat and sweep == 0)
                    depth1, semantic1, context1, semantic0 = self.height_net(
                        self.img_neck_16(feats), self.img_neck_8(feats), mlp_input)
                height = torch.softmax(depth1.float(), dim=1).permute(0, 2, 3, 1)
                semantic = torch.softmax(semantic1.float(), dim=1)
                # background suppression: drop pixels with P(background) > thr
                keep = background_keep(semantic)
                tran_feat = torch.cat([context1.float(), semantic], dim=1) * keep
                with span("lift"):
                    maps.append(_lift_and_splat(
                        cfg, height, tran_feat.permute(0, 2, 3, 1), mats, sweep,
                        cells if sweep == 0 else None,
                        pix_keep if sweep == 0 else None, train))
            if sweep == 0:
                aux = (semantic0, semantic1)
        out = torch.cat(maps, dim=-1) if s > 1 else maps[0]
        return out, aux
