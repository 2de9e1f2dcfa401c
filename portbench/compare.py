"""The comparison that decides `correct` for a served detector.

Each served frame's detections are judged against the float32 reference's
dense head outputs for the same frame, in four numbers:

- `sound_gap`: every served detection has to be one the reference's map
  gives. For a detection of class c, the distance to a cell is the largest
  of its departures in the head's own units: score, centre (in cells:
  the regression offset), centre height, log size, heading (the angle gap
  times the length of the reference's (sin, cos) vector) and velocity; the
  detection's gap is its distance to the nearest cell, and `sound_gap` the
  largest gap over the sample's detections. It catches one wrong answer;
  its tail is set by the discrete choices (top-k bins, the background
  keep) that any rounding flips, so it cannot tell one precision from the
  next.
- `sound_ratio`: for each frame, the median gap of the served detections
  over the median gap of the reference's own detections computed at the
  precision the configuration states (`reference.precision.configured`,
  decoded by `reference.decode`); the median over the sample's frames:
  about 1 for a program at that precision, about the ratio of the two
  roundings for one a step below.
- `miss_gap`: what the reference scores has to be in the served set.
  The best cell of each task (decode always keeps its task's first
  candidate) has to be matched by the task's best served score, and every
  cell the reference scores clearly above what decode would cut has to be
  accounted for by a served detection of its task within the NMS radius
  (itself, or one that suppressed it) whose score is at least its own.
  The cut is the threshold, the task's `max_per_task`-th reference score,
  and, where the task's served list is full, its lowest served score; a
  cell counts only MISS_MARGIN above the cut (the best cell: above the
  threshold) and RANGE_MARGIN inside the post-centre range, so that a
  near-tie on either side of a cut is no miss. `miss_gap` is the largest
  shortfall of a cell's score below its best served score or cover, 0 at
  least.
- `nms_pairs`: served detections of one task whose centres lie closer
  than the NMS radius (the kept set of circle NMS has none); exact.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MISS_MARGIN = 0.05      # score above the cut before a cell must be covered
RANGE_MARGIN = (1.0, 1.0, 0.5)   # metres inside the post-centre range (x, y, z)
COVER_MARGIN = 0.5      # metres added to the NMS radius for a cover
PAIR_SLACK = 1e-4       # relative slack on the squared radius (float32 rounding)


def _task_of(hc: dict) -> tuple[np.ndarray, np.ndarray]:
    """(task, class within task) of each global label."""
    task, cls = [], []
    for t, classes in enumerate(hc["tasks"]):
        task += [t] * len(classes)
        cls += list(range(len(classes)))
    return np.array(task), np.array(cls)


def frame_numbers(hc: dict, served, preds: list) -> dict:
    """served: (boxes (M, 9), scores (M,), labels (M,)) of one frame;
    preds: the reference's list over tasks of dicts of (h, w, c) tensors.
    Returns this frame's {"gaps" (each detection's), "miss_gap",
    "nms_pairs"}."""
    boxes, scores, labels = (np.asarray(a) for a in served)
    dev = preds[0]["heatmap"].device
    task_of, cls_of = _task_of(hc)
    osf = hc["out_size_factor"]
    sx, sy = osf * hc["voxel_size"][0], osf * hc["voxel_size"][1]
    pc, pcr = hc["point_cloud_range"], hc["post_center_range"]
    gaps, miss, pairs = [], 0.0, 0
    for t, p in enumerate(preds):
        h, w, nc = p["heatmap"].shape
        ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        f = {k: v.float().reshape(h * w, -1) for k, v in p.items()}
        cx = (xs.reshape(-1) + f["reg"][:, 0]) * sx + pc[0]
        cy = (ys.reshape(-1) + f["reg"][:, 1]) * sy + pc[1]
        ref_s = torch.sigmoid(f["heatmap"])                         # (hw, nc)
        yaw = torch.atan2(f["rot"][:, 0], f["rot"][:, 1])
        rlen = torch.hypot(f["rot"][:, 0], f["rot"][:, 1])
        mine = task_of[labels.astype(np.int64)] == t if len(labels) else np.zeros(0, bool)
        b = torch.as_tensor(boxes[mine], dtype=torch.float32, device=dev).reshape(-1, 9)
        s = torch.as_tensor(scores[mine], dtype=torch.float32, device=dev)
        c = torch.as_tensor(cls_of[labels[mine].astype(np.int64)], device=dev)
        if len(b):
            d_yaw = torch.remainder(b[:, 6:7] - yaw[None] + math.pi, 2 * math.pi) - math.pi
            parts = [
                (s[:, None] - ref_s[:, c].T).abs(),
                (b[:, 0:1] - cx[None]).abs() / sx,
                (b[:, 1:2] - cy[None]).abs() / sy,
                (b[:, 2:3] + b[:, 5:6] * 0.5 - f["height"][:, 0][None]).abs(),
                (torch.log(b[:, 3:6].clamp_min(1e-30))[:, None, :] - f["dim"][None]).abs().amax(-1),
                d_yaw.abs() * rlen[None],
                (b[:, None, 7:9] - f["vel"][None]).abs().amax(-1),
            ]
            dist = torch.stack(parts).amax(0)                       # (m, hw)
            gaps.append(dist.amin(1).cpu())
            r2 = float(hc["nms_min_radius"][t]) ** 2 * (1 - PAIR_SLACK)
            d2 = (b[:, None, 0] - b[None, :, 0]) ** 2 + (b[:, None, 1] - b[None, :, 1]) ** 2
            pairs += int(torch.triu(d2 < r2, diagonal=1).sum())
        flat = ref_s.reshape(-1)
        kth = float(torch.topk(flat, min(hc["max_per_task"], flat.numel())).values[-1])
        full = len(s) >= hc["post_max_size"]
        cut = max(hc["score_threshold"], kth, float(s.min()) if full else 0.0)
        best = ref_s.amax(1)
        inside = ((cx >= pcr[0] + RANGE_MARGIN[0]) & (cx <= pcr[3] - RANGE_MARGIN[0])
                  & (cy >= pcr[1] + RANGE_MARGIN[1]) & (cy <= pcr[4] - RANGE_MARGIN[1])
                  & (f["height"][:, 0] >= pcr[2] + RANGE_MARGIN[2])
                  & (f["height"][:, 0] <= pcr[5] - RANGE_MARGIN[2]))
        top = torch.where(inside, best, 0.0).max()
        if float(top) > hc["score_threshold"] + MISS_MARGIN:
            miss = max(miss, float(top) - (float(s.max()) if len(s) else 0.0))
        due = torch.nonzero(inside & (best > cut + MISS_MARGIN)).reshape(-1)
        if len(due):
            cover = torch.zeros(len(due), device=dev)
            if len(b):
                r = float(hc["nms_min_radius"][t]) + COVER_MARGIN
                near = ((b[None, :, 0] - cx[due][:, None]) ** 2
                        + (b[None, :, 1] - cy[due][:, None]) ** 2) < r * r
                cover = torch.where(near, s[None, :], 0.0).amax(1)
            miss = max(miss, float((best[due] - cover).max()))
    return {"gaps": torch.cat(gaps) if gaps else torch.zeros(0), "miss_gap": miss,
            "nms_pairs": pairs}


def combine(served: list[dict], configured: list[dict]) -> dict:
    """The sample's numbers from the served frames' and the
    configured-precision reference's per-frame numbers. `sound_ratio` is
    paired by frame (each frame's median gap over the reference's own on
    that frame), then the median over frames: a frame's scale cancels."""
    g = torch.cat([f["gaps"] for f in served])
    ratios = [float(a["gaps"].median()) / max(float(b["gaps"].median()), 1e-30)
              for a, b in zip(served, configured) if len(a["gaps"]) and len(b["gaps"])]
    return {"sound_gap": float(g.max()) if len(g) else 0.0,
            "sound_ratio": float(torch.tensor(ratios).median()) if ratios else float("inf"),
            "miss_gap": max((f["miss_gap"] for f in served), default=0.0),
            "nms_pairs": sum(f["nms_pairs"] for f in served)}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
