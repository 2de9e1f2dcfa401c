"""CenterPoint decoding in plain PyTorch, for the control: a reference of
lower precision put in the program's place has its dense outputs decoded
by the published rule. Per task: sigmoid scores, the `max_per_task` best
(cell, class) pairs, the score threshold and the post-centre range, greedy
circle NMS over the score-ordered candidates, the first `post_max_size`
kept. Boxes are [x, y, z_bottom, dx, dy, dz, yaw, vx, vy]."""
from __future__ import annotations

import numpy as np
import torch


def decode_frame(hc: dict, preds: list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """preds: one frame's list over tasks of dicts of (h, w, c) tensors.
    Returns (boxes (M, 9), scores (M,), labels (M,)) as numpy."""
    out_b, out_s, out_l = [], [], []
    offset = 0
    osf = hc["out_size_factor"]
    vx, vy = hc["voxel_size"][:2]
    pc, pcr = hc["point_cloud_range"], hc["post_center_range"]
    for t, (classes, p) in enumerate(zip(hc["tasks"], preds)):
        h, w, nc = p["heatmap"].shape
        scores = torch.sigmoid(p["heatmap"].float()).reshape(-1)
        k = min(hc["max_per_task"], scores.numel())
        scores, idx = torch.sort(scores, descending=True, stable=True)
        scores, idx = scores[:k], idx[:k]
        cls, pos = idx % nc, idx // nc
        ys, xs = (pos // w).float(), (pos % w).float()

        def at(name):
            return p[name].float().reshape(h * w, -1)[pos]

        reg, height, dim, rot, vel = at("reg"), at("height")[:, 0], at("dim").exp(), at("rot"), at("vel")
        x = (xs + reg[:, 0]) * osf * vx + pc[0]
        y = (ys + reg[:, 1]) * osf * vy + pc[1]
        ok = ((scores > hc["score_threshold"]) & (x >= pcr[0]) & (y >= pcr[1])
              & (height >= pcr[2]) & (x <= pcr[3]) & (y <= pcr[4]) & (height <= pcr[5]))
        r2 = float(hc["nms_min_radius"][t]) ** 2
        d2 = (x[:, None] - x[None, :]) ** 2 + (y[:, None] - y[None, :]) ** 2
        later = torch.arange(k, device=x.device)
        suppress = (d2 < r2) & (later[None, :] > later[:, None])
        keep = ok.clone()
        for i in range(k):
            keep &= ~(suppress[i] & keep[i])
        kept = torch.nonzero(keep).reshape(-1)[:hc["post_max_size"]]
        boxes = torch.stack([x, y, height - dim[:, 2] * 0.5, dim[:, 0], dim[:, 1], dim[:, 2],
                             torch.atan2(rot[:, 0], rot[:, 1]), vel[:, 0], vel[:, 1]], -1)
        out_b.append(boxes[kept])
        out_s.append(scores[kept])
        out_l.append(cls[kept] + offset)
        offset += len(classes)
    return (torch.cat(out_b).cpu().numpy(), torch.cat(out_s).cpu().numpy(),
            torch.cat(out_l).cpu().numpy())
