"""The plain reference of the served detector: BEVHeight (ResNet, SECONDFPN,
HeightNet, top-k lift-splat, CenterPoint BEV head) and SGV3D (its BSM
backbone: two necks, MSCThead, background suppression, the lift at stride
8), in float32 PyTorch, eval mode only.

It is written from the published model (yanglei18/SGV3D's exps, BEVHeight's
paper and code) and imports nothing of the measured program. Its module
tree gives the same `state_dict` names and shapes as the served model, so
one seeded draw of weights feeds both sides. It departs from the program's
code on purpose where an independent formulation exists: the deformable
convolution samples with `grid_sample`, the geometry inverts matrices in
float64 with `torch.linalg.inv`, the top-k pick is `torch.topk` and the
pooling one `index_add_`. It keeps no cache: every call works the lift's
cells out again from the calibration.

Layouts: images (n, H, W, 3) uint8, NCHW inside, the head's outputs a list
over tasks of dicts of (n, h, w, c) tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BG_THRESHOLD = 0.45     # SGV3D keeps a pixel while P(background) <= this
STAGE_BLOCKS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def conv(cin, cout, k, stride=1, padding=None, dilation=1, bias=True):
    if padding is None:
        padding = (k // 2) * dilation
    return nn.Conv2d(cin, cout, k, stride, padding, dilation, bias=bias)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 by the running statistics."""

    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return ((x - self.running_mean.reshape(shape)) * scale.reshape(shape)
                + self.bias.reshape(shape))


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = conv(cin, cout, k)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, bias=False)
        self.bn2 = BatchNorm(planes)
        self.project = stride != 1 or cin != planes
        if self.project:
            self.downsample_conv = conv(cin, planes, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        skip = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(out + skip)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1):
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
        skip = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(out + skip)


class ResNet(nn.Module):
    """7x7 stride-2 stem (+ 3x3 max pool for the image backbones), then
    bottleneck (depth >= 50) or basic stages; every stage's output."""

    def __init__(self, depth, cin=3, base=64, num_stages=4, strides=(1, 2, 2, 2),
                 maxpool=True):
        super().__init__()
        self.maxpool = maxpool
        self.stem_conv = conv(cin, base, 7, 2, bias=False)
        self.stem_bn = BatchNorm(base)
        block = Bottleneck if depth >= 50 else BasicBlock
        expand = 4 if depth >= 50 else 1
        self.stages = []
        c = base
        for s, (n, stride) in enumerate(zip(STAGE_BLOCKS[depth][:num_stages], strides)):
            planes = base * 2 ** s
            names = []
            for b in range(n):
                name = f"layer{s + 1}_block{b}"
                setattr(self, name, block(c, planes, stride if b == 0 else 1))
                c = planes * expand
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        if self.maxpool:
            x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Each level to a common stride (transposed conv for strides >= 1, a
    strided conv below), BatchNorm (eps 1e-3), ReLU, concatenated."""

    def __init__(self, cins, couts, strides):
        super().__init__()
        self.ups = []
        for i, (cin, cout, s) in enumerate(zip(cins, couts, strides)):
            if s >= 1:
                name = f"deblock{i}_deconv"
                setattr(self, name, nn.ConvTranspose2d(cin, cout, int(s), int(s)))
            else:
                name = f"deblock{i}_conv"
                k = int(round(1 / s))
                setattr(self, name, conv(cin, cout, k, k, padding=0))
            setattr(self, f"deblock{i}_bn", BatchNorm(cout, eps=1e-3))
            self.ups.append(name)

    def forward(self, feats):
        return torch.cat([F.relu(getattr(self, f"deblock{i}_bn")(getattr(self, n)(x)))
                          for i, (x, n) in enumerate(zip(feats, self.ups))], dim=1)


class Mlp(nn.Module):
    def __init__(self, cin, hidden, out):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_reduce = conv(c, c, 1)
        self.conv_expand = conv(c, c, 1)

    def forward(self, x, x_se):
        return x * torch.sigmoid(self.conv_expand(F.relu(self.conv_reduce(x_se))))


class ASPP(nn.Module):
    """Dilations 1, 6, 12, 18 and a global-pooling branch, fused by a 1x1
    conv (the dropout after it is off in eval mode)."""

    def __init__(self, cin, mid):
        super().__init__()
        for i, (k, d) in enumerate([(1, 1), (3, 6), (3, 12), (3, 18)]):
            setattr(self, f"aspp{i + 1}_conv", conv(cin, mid, k, dilation=d, bias=False))
            setattr(self, f"aspp{i + 1}_bn", BatchNorm(mid))
        self.gap_conv = conv(cin, mid, 1, bias=False)
        self.gap_bn = BatchNorm(mid)
        self.proj_conv = conv(5 * mid, mid, 1, bias=False)
        self.proj_bn = BatchNorm(mid)

    def forward(self, x):
        out = [F.relu(getattr(self, f"aspp{i}_bn")(getattr(self, f"aspp{i}_conv")(x)))
               for i in range(1, 5)]
        g = F.relu(self.gap_bn(self.gap_conv(x.mean(dim=(2, 3), keepdim=True))))
        out.append(g.expand_as(out[0]))
        return F.relu(self.proj_bn(self.proj_conv(torch.cat(out, dim=1))))


class DeformConv(nn.Module):
    """DCNv1 (mmcv's DeformConv2dPack, no modulation): a conv predicts a
    (dy, dx) pair for each row-major tap; each tap samples the map
    bilinearly at its displaced position, zero outside; a grouped
    contraction over (channels, taps)."""

    def __init__(self, cin, cout, k=3, groups=4):
        super().__init__()
        self.k = k
        self.groups = groups
        self.offset_conv = nn.Conv2d(cin, 2 * k * k, k, padding=k // 2)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        n, c, h, w = x.shape
        k, pad = self.k, self.k // 2
        off = self.offset_conv(x).reshape(n, k * k, 2, h, w)
        ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
        xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
        taps = []
        for t in range(k * k):
            py = ys + (t // k - pad) + off[:, t, 0]
            px = xs + (t % k - pad) + off[:, t, 1]
            grid = torch.stack([2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1], dim=-1)
            taps.append(F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                      align_corners=True))
        s = torch.stack(taps, dim=2)                          # (n, c, k*k, h, w)
        g = self.groups
        s = s.reshape(n, g, (c // g) * k * k, h * w)
        wgt = self.weight.reshape(g, -1, (c // g) * k * k)
        out = torch.einsum("goq,ngqp->ngop", wgt, s).reshape(n, -1, h, w)
        return out + self.bias[None, :, None, None]


class HeightNet(nn.Module):
    def __init__(self, cin, mid, ctx_c, bins):
        super().__init__()
        self.mlp_bn = BatchNorm(27)
        self.reduce_conv = ConvBNReLU(cin, mid, 3)
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = conv(mid, ctx_c, 1)
        self.height_mlp = Mlp(27, mid, mid)
        self.height_se = SELayer(mid)
        for i in range(3):
            setattr(self, f"height_block{i}", BasicBlock(mid, mid))
        self.aspp = ASPP(mid, mid)
        self.dcn = DeformConv(mid, mid, 3, 4)
        self.height_layer = conv(mid, bins, 1)

    def forward(self, x, cam):
        cam = self.mlp_bn(cam)
        x = self.reduce_conv(x)
        context = self.context_conv(self.context_se(x, self.context_mlp(cam)[..., None, None]))
        h = self.height_se(x, self.height_mlp(cam)[..., None, None])
        for i in range(3):
            h = getattr(self, f"height_block{i}")(h)
        return self.height_layer(self.dcn(self.aspp(h))), context


class TaskHead(nn.Module):
    def __init__(self, cin, mid, out):
        super().__init__()
        self.block1 = BasicBlock(cin, mid)
        self.block2 = BasicBlock(mid, mid)
        self.decoder_out = ConvBNReLU(mid, mid, 3)
        self.head = conv(mid, out, 1)

    def forward(self, x):
        feat = self.decoder_out(self.block2(self.block1(x)))
        return self.head(feat), feat


class SABlock(nn.Module):
    def __init__(self, cin_x, cin_y, c):
        super().__init__()
        self.attention_conv = conv(cin_y, c, 3, bias=False)
        self.conv = conv(cin_x, c, 3, bias=False)

    def forward(self, x, y):
        return self.conv(x) * torch.sigmoid(self.attention_conv(y))


class TaskFPN(nn.Module):
    def __init__(self, c_coarse, c_fine, out):
        super().__init__()
        self.reduce_conv = conv(c_coarse, out, 3)
        self.self_attention = SABlock(c_fine, out, out)

    def forward(self, coarse, fine):
        up = self.reduce_conv(F.interpolate(coarse, scale_factor=2, mode="bilinear",
                                            align_corners=False))
        return up + self.self_attention(fine, up)


class MSCThead(nn.Module):
    """SGV3D's two-scale head: stride-16 semantic and context stage (its
    height head is the identity), three TaskFPNs to stride 8, then the
    height-bin, semantic and context outputs."""

    def __init__(self, cin0, cin1, mid, bins, sem, ctx_c):
        super().__init__()
        m0, m1 = mid
        self.mlp_bn = BatchNorm(27)
        self.reduce_conv0 = ConvBNReLU(cin0, m0, 3)
        self.reduce_conv1 = ConvBNReLU(cin1, m1, 3)
        self.scale0_mlp = Mlp(27, m0, m0)
        self.scale1_mlp = Mlp(27, m1, m1)
        self.scale0_se = SELayer(m0)
        self.scale1_se = SELayer(m1)
        self.aspp = ASPP(m0, m0)
        self.semantic_head0 = TaskHead(m0, m0, sem)
        self.context_conv0 = ConvBNReLU(m0, m0, 3)
        self.depth_fpn = TaskFPN(m0, m1, m1)
        self.semantic_fpn = TaskFPN(m0, m1, m1)
        self.context_fpn = TaskFPN(m0, m1, m1)
        self.depth_head1 = TaskHead(m1, m1, bins)
        self.semantic_head1 = TaskHead(m1, m1, sem)
        self.context_conv1a = ConvBNReLU(m1, m1, 3)
        self.context_conv1b = conv(m1, ctx_c, 1)

    def forward(self, f16, f8, cam):
        cam = self.mlp_bn(cam)
        f0 = self.scale0_se(self.reduce_conv0(f16), self.scale0_mlp(cam)[..., None, None])
        f1 = self.scale1_se(self.reduce_conv1(f8), self.scale1_mlp(cam)[..., None, None])
        f0 = self.aspp(f0)
        _, sem_feat = self.semantic_head0(f0)
        ctx_feat = self.context_conv0(f0)
        depth = self.depth_head1(self.depth_fpn(f0, f1))[0]
        semantic = self.semantic_head1(self.semantic_fpn(sem_feat, f1))[0]
        context = self.context_conv1b(self.context_conv1a(self.context_fpn(ctx_feat, f1)))
        return depth, semantic, context


class SeparateTaskBranch(nn.Module):
    def __init__(self, cin, out, num_conv=2, k=3):
        super().__init__()
        self.num_conv = num_conv
        c = cin
        for i in range(num_conv - 1):
            setattr(self, f"conv{i}", ConvBNReLU(c, 64, k))
            c = 64
        self.final = conv(c, out, k)

    def forward(self, x):
        for i in range(self.num_conv - 1):
            x = getattr(self, f"conv{i}")(x)
        return self.final(x)


class BEVHead(nn.Module):
    """ResNet-18 trunk (3 stages, strides 1, 2, 2, no max pool), SECONDFPN,
    a shared conv and, for each task, one branch per regression target
    and the heatmap."""

    def __init__(self, hc):
        super().__init__()
        cin, base = hc["bev_backbone_in_channels"], hc["bev_backbone_base_channels"]
        self.trunk = ResNet(18, cin, base, 3, (1, 2, 2), maxpool=False)
        self.neck = SECONDFPN((cin, base, 2 * base, 4 * base),
                              hc["bev_neck_out_channels"], hc["bev_neck_upsample_strides"])
        share = hc["share_conv_channels"]
        self.shared_conv = ConvBNReLU(sum(hc["bev_neck_out_channels"]), share, 3)
        self.names = []
        for ti, classes in enumerate(hc["tasks"]):
            heads = [(n, c, nc) for n, (c, nc) in hc["common_heads"]]
            heads.append(("heatmap", len(classes), 2))
            for name, out, num_conv in heads:
                setattr(self, f"task{ti}_{name}",
                        SeparateTaskBranch(share, out, num_conv, hc["final_kernel"]))
            self.names.append([h[0] for h in heads])

    def forward(self, bev):
        x = bev.permute(0, 3, 1, 2)
        x = self.shared_conv(self.neck([x] + self.trunk(x)))
        return [{n: getattr(self, f"task{ti}_{n}")(x).permute(0, 2, 3, 1) for n in names}
                for ti, names in enumerate(self.names)]


# ---------------------------------------------------------------------------
# Geometry and the lift
# ---------------------------------------------------------------------------

def camera_vector(mats: dict) -> torch.Tensor:
    """(n, 27): fx, fy, cx, cy, the ida's six affine terms, the bda's five
    and sensor2ego's top three rows."""
    k, ida, s2e, bda = (mats[n] for n in ("intrin_mats", "ida_mats",
                                          "sensor2ego_mats", "bda_mat"))
    v = [k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2],
         ida[:, 0, 0], ida[:, 0, 1], ida[:, 0, 3], ida[:, 1, 0], ida[:, 1, 1], ida[:, 1, 3],
         bda[:, 0, 0], bda[:, 0, 1], bda[:, 1, 0], bda[:, 1, 1], bda[:, 2, 2]]
    return torch.cat([torch.stack(v, -1), s2e[:, :3, :].reshape(-1, 12)], -1).float()


def lift_cells(bc: dict, mats: dict, feat_hw) -> torch.Tensor:
    """(n, fH*fW, D) int64 flat BEV cell of every (pixel, height bin),
    -1 where the point leaves the grid. The height-based frustum: pixel
    (u, v) of the resized image at height h above the ground plane is the
    ray of the virtual (ground-aligned) camera scaled to meet that plane,
    taken to ego coordinates; all in float64."""
    fh, fw = feat_hw
    H, W = bc["final_dim"]
    d0, d1, nb = bc["d_bound"]
    dev = mats["intrin_mats"].device
    f64 = torch.float64
    heights = d0 + (torch.arange(nb, dtype=f64, device=dev) / nb) ** 1.5 * (d1 - d0)
    u = torch.linspace(0, W - 1, fw, dtype=f64, device=dev)
    v = torch.linspace(0, H - 1, fh, dtype=f64, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    m = {n: mats[n].to(f64) for n in ("sensor2ego_mats", "sensor2virtual_mats",
                                        "intrin_mats", "ida_mats", "bda_mat")}
    ref_h = mats["reference_heights"].to(f64)
    img = torch.stack([uu, vv, torch.zeros_like(uu), torch.ones_like(uu)], -1)
    img = torch.einsum("nij,pqj->npqi", torch.linalg.inv(m["ida_mats"]), img)
    ray = torch.stack([img[..., 0] * 10, img[..., 1] * 10,
                       torch.full_like(img[..., 0], 10.0), torch.ones_like(img[..., 0])], -1)
    to_virtual = m["sensor2virtual_mats"] @ torch.linalg.inv(m["intrin_mats"])
    ray = torch.einsum("nij,npqj->npqi", to_virtual, ray)            # (n, fh, fw, 4)
    above = ref_h[:, None, None, None] - heights[None, None, None, :]  # (n, 1, 1, D)
    pts = ray[..., None, :3] * (above / ray[..., None, 1])[..., None]
    to_ego = m["bda_mat"] @ m["sensor2ego_mats"] @ torch.linalg.inv(m["sensor2virtual_mats"])
    ego = torch.einsum("nij,npqdj->npqdi", to_ego[:, :3, :3], pts) + to_ego[:, None, None, None, :3, 3]
    lo = torch.tensor([b[0] for b in (bc["x_bound"], bc["y_bound"], bc["z_bound"])],
                      dtype=f64, device=dev)
    size = torch.tensor([b[2] for b in (bc["x_bound"], bc["y_bound"], bc["z_bound"])],
                        dtype=f64, device=dev)
    num = [int(round((b[1] - b[0]) / b[2])) for b in (bc["x_bound"], bc["y_bound"], bc["z_bound"])]
    vox = torch.trunc((ego - lo) / size).long()        # truncation toward zero
    ok = ((vox >= 0) & (vox < torch.tensor(num, device=dev))).all(-1)
    cell = torch.where(ok, vox[..., 1] * num[0] + vox[..., 0], -1)
    return cell.reshape(cell.shape[0], fh * fw, nb)


def lift_splat(height: torch.Tensor, context: torch.Tensor, cells: torch.Tensor,
               k: int | None, num_cells: int) -> torch.Tensor:
    """height (n, HW, D) probabilities, context (n, HW, C), cells (n, HW, D):
    each camera's BEV map (n, num_cells, C) of the sum of height x context
    over its points in a cell, the k most probable bins of each pixel
    (all with k None)."""
    if k is not None and k < height.shape[-1]:
        height, pick = torch.topk(height, k, dim=-1)
        cells = torch.gather(cells, -1, pick)
    n, hw, c = context.shape
    out = torch.zeros(n * num_cells, c, dtype=context.dtype, device=context.device)
    live = cells >= 0
    cam = torch.arange(n, device=cells.device)[:, None, None].expand_as(cells)
    pix = torch.arange(hw, device=cells.device)[None, :, None].expand_as(cells)
    rows = (cam * hw + pix)[live]
    out.index_add_(0, (cam * num_cells + cells)[live],
                   height[live][:, None] * context.reshape(n * hw, c)[rows])
    return out.reshape(n, num_cells, c)


class Detector(nn.Module):
    """The whole served model; `forward(imgs, mats)` takes one block of
    frames (each its own camera) and returns the head's dense outputs."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        bc, hc = cfg["backbone"], cfg["head"]
        self.bsm = bc["is_bsm"]
        self.backbone = Backbone(bc)
        self.head = BEVHead(hc)

    def forward(self, imgs, mats):
        bev = self.backbone(normalize(imgs, self.cfg), mats)
        return self.head(bev)


def normalize(imgs: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 (n, H, W, 3) RGB frames -> normalised BGR float32 NCHW."""
    x = torch.flip(imgs.float(), dims=(-1,))
    mean = torch.tensor(cfg["img_mean"], device=x.device)
    std = torch.tensor(cfg["img_std"], device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


class Backbone(nn.Module):
    def __init__(self, bc: dict):
        super().__init__()
        self.bc = bc
        outs = (256, 512, 1024, 2048) if bc["resnet_depth"] >= 50 else (64, 128, 256, 512)
        neck = bc["img_neck_out_channels"]
        self.img_backbone = ResNet(bc["resnet_depth"])
        bins = int(bc["d_bound"][2])
        if bc["is_bsm"]:
            self.img_neck_16 = SECONDFPN(outs, neck, (0.25, 0.5, 1, 2))
            self.img_neck_8 = SECONDFPN(outs, neck, (0.5, 1, 2, 4))
            self.height_net = MSCThead(sum(neck), sum(neck), bc["height_net_mid_channels"],
                                       bins, bc["semantic_channels"], bc["output_channels"])
        else:
            self.img_neck = SECONDFPN(outs, neck, (0.25, 0.5, 1, 2))
            self.height_net = HeightNet(sum(neck), bc["height_net_mid_channels"][0],
                                        bc["output_channels"], bins)
            self.assist_layer = conv(sum(neck), 256, 1)     # training aux only

    def image_side(self, x, cam):
        """(height logits (n, D, fh, fw), lifted features (n, C, fh, fw))."""
        feats = self.img_backbone(x)
        if not self.bc["is_bsm"]:
            return self.height_net(self.img_neck(feats), cam)
        depth, semantic, context = self.height_net(self.img_neck_16(feats),
                                                   self.img_neck_8(feats), cam)
        semantic = torch.softmax(semantic.float(), dim=1)
        keep = (semantic[:, :1] <= BG_THRESHOLD).float()
        return depth, torch.cat([context.float(), semantic], dim=1) * keep

    def forward(self, x, mats):
        bc = self.bc
        logits, feat = self.image_side(x, camera_vector(mats))
        n, c, fh, fw = feat.shape
        height = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1).reshape(n, fh * fw, -1)
        num_x = int(round((bc["x_bound"][1] - bc["x_bound"][0]) / bc["x_bound"][2]))
        num_y = int(round((bc["y_bound"][1] - bc["y_bound"][0]) / bc["y_bound"][2]))
        cells = lift_cells(bc, mats, (fh, fw))
        bev = lift_splat(height, feat.float().permute(0, 2, 3, 1).reshape(n, fh * fw, c),
                         cells, bc["lift_top_k"], num_x * num_y)
        return bev.reshape(n, num_y, num_x, c)
