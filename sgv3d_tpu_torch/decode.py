"""CenterPoint box decoding + circle NMS with static shapes (torch port of
`sgv3d_tpu.decode`).

All tasks decode in one batched pass over (B, T). Output boxes are 9-dim
[x, y, z_bottom, dx, dy, dz, yaw, vx, vy].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from sgv3d_tpu_torch.config import HeadConfig
from sgv3d_tpu_torch.train.profiling import span


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, T*post_max, 9)
    scores: torch.Tensor  # (B, T*post_max)
    labels: torch.Tensor  # (B, T*post_max) global class ids
    valid: torch.Tensor   # (B, T*post_max) bool


def circle_nms(centers: torch.Tensor, valid: torch.Tensor,
               radius: torch.Tensor) -> torch.Tensor:
    """Greedy circular suppression over score-ordered candidates, batched.

    centers (..., K, 2) xy in BEV metres, descending score; valid (..., K)
    bool; radius broadcastable to valid's leading dims. Candidate i, if kept
    and valid, suppresses every later j within the radius. One Python loop
    of K steps serves every leading index at once. Returns (..., K) keep."""
    k = centers.shape[-2]
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    idx = torch.arange(k, device=centers.device)
    # suppress[..., i, j]: i would suppress j if i is kept
    suppress = ((d2 < (radius ** 2)[..., None, None])
                & (idx[None, :] > idx[:, None]) & valid[..., :, None])
    keep = valid.clone()
    for i in range(k):
        keep &= ~(suppress[..., i, :] & keep[..., i:i + 1])
    return keep


def _device_vector(values, dtype, device) -> torch.Tensor:
    """A small constant vector filled element by element on the device; a
    `torch.tensor(..., device=cuda)` copy would synchronise the stream."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i] = v
    return out


def decode(cfg: HeadConfig, preds: list) -> Detections:
    """Decode all task heads into a fixed-size detection set (the span
    `sgv3d.decode`, with `decode.rank` and `decode.nms` inside)."""
    t_n = len(cfg.tasks)
    ncs = [t.num_classes for t in cfg.tasks]
    b = preds[0]["heatmap"].shape[0]
    dev = preds[0]["heatmap"].device
    with span("decode"):
        with span("decode.rank"):
            scores, cls, boxes, valid = _ranked(cfg, preds)
        radii = _device_vector(cfg.nms_min_radius, torch.float32, dev)
        offsets = _device_vector([sum(ncs[:i]) for i in range(t_n)], torch.int64, dev)
        with span("decode.nms"):
            keep = circle_nms(boxes[..., :2], valid, radii[None, :])
        # stable kept-first order (already score-ordered), first post_max_size
        pm = cfg.post_max_size
        order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True)[1][..., :pm]
        out_valid = (torch.arange(pm, device=dev)
                     < keep.sum(-1, keepdim=True))                  # (B, T, pm)
        boxes = torch.take_along_dim(boxes, order[..., None], dim=2)
        scores = torch.take_along_dim(scores, order, dim=2) * out_valid
        labels = torch.take_along_dim(cls, order, dim=2) + offsets[:, None]
        return Detections(boxes.reshape(b, t_n * pm, 9),
                          scores.reshape(b, t_n * pm),
                          labels.reshape(b, t_n * pm),
                          out_valid.reshape(b, t_n * pm))


def _ranked(cfg: HeadConfig, preds: list):
    """Each task's k = min(max_per_task, H * W) best (cell, class) pairs by
    heatmap score, as (scores, class, boxes (B, T, k, 9), valid), each
    (B, T, k, ...) in descending score order."""
    t_n = len(cfg.tasks)
    ncs = [t.num_classes for t in cfg.tasks]
    nc_max = max(ncs)
    b, h, w, _ = preds[0]["heatmap"].shape
    k = min(cfg.max_per_task, h * w)

    # (B, T, H*W, nc_max) heatmap logits, padded classes at -inf; ranked over
    # the NHWC flattening pos * nc_max + cls
    hms = torch.stack([
        torch.nn.functional.pad(p["heatmap"].float().reshape(b, h * w, -1),
                                (0, nc_max - nc), value=float("-inf"))
        for p, nc in zip(preds, ncs)], dim=1)
    hm = torch.sigmoid(hms).reshape(b, t_n, -1)
    # a stable sort gives ties to the lowest flat index, as lax.top_k does
    scores, flat_idx = torch.sort(hm, dim=-1, descending=True, stable=True)
    scores, flat_idx = scores[..., :k], flat_idx[..., :k]           # (B, T, k)
    cls = flat_idx % nc_max
    pos = flat_idx // nc_max
    ys = (pos // w).float()
    xs = (pos % w).float()

    def gather(name):
        t = torch.stack([p[name].float() for p in preds], dim=1)
        c = t.shape[-1]
        return torch.take_along_dim(t.reshape(b, t_n, h * w, c),
                                    pos[..., None], dim=2)

    reg = gather("reg")
    height = gather("height")[..., 0]
    dim = torch.exp(gather("dim"))
    rot = gather("rot")
    vel = gather("vel")

    osf = float(cfg.out_size_factor)
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    pc = cfg.point_cloud_range
    x = (xs + reg[..., 0]) * osf * vx + pc[0]
    y = (ys + reg[..., 1]) * osf * vy + pc[1]
    yaw = torch.atan2(rot[..., 0], rot[..., 1])

    pcr = cfg.post_center_range
    valid = scores > cfg.score_threshold
    valid &= (x >= pcr[0]) & (y >= pcr[1]) & (height >= pcr[2])
    valid &= (x <= pcr[3]) & (y <= pcr[4]) & (height <= pcr[5])

    boxes = torch.stack(
        [x, y, height - dim[..., 2] * 0.5, dim[..., 0], dim[..., 1],
         dim[..., 2], yaw, vel[..., 0], vel[..., 1]], dim=-1)  # (B, T, k, 9)
    return scores, cls, boxes, valid
