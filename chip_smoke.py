#!/usr/bin/env python3
"""Smoke run of the torch port (`sgv3d_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-k1   # K1's serving call alone (see below)
    python3 chip_smoke.py --time-k2b  # K2b alone on its four timed cases
    python3 chip_smoke.py --time-k2   # K2's forward on the same inputs
    python3 chip_smoke.py --sweep-k2b # K2b's constants, the alternatives

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. build the CUDA kernels from `sgv3d_tpu_torch/csrc` (one nvcc a source,
     all started together; sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, batch 4:
     K1 top-k-with-cells exactly, with and without its bins (rows of
     exact ties, whole rows equal, rows with fewer than k finite bins; its
     lanes a pixel printed; with bins also at the training shape (2, 20736,
     90); the serving call's time printed beside PERF.md's parent-code
     0.0518 ms, a comparison with a number of earlier runs only) and K2
     lift-splat within 1e-5 * max|ref| + 1e-6 and bitwise equal across two
     runs, its prep's offsets and order exactly the plain prep's (per-key
     counts, their scan and `torch.sort(stable=True)`), its prep and pool
     timed apart, in both layouts at the shapes of both served paths
     (SGV3D-r50: 18432 pixels, C = 87; r101: 4608 pixels, C = 80) and in
     the top-k layout at the r101 evaluation's (5184 pixels); K1 and
     K2 timed as 20 calls captured in one CUDA graph (device time) and as
     20 back-to-back wrapper calls (with the host's enqueue); K3 the fused
     identity bottleneck at ragged shapes and
     at each r50 stage's shape, with large positive BN biases, within
     2e-2 * max|plain| and bitwise equal across two runs, timed beside the
     plain version and the unfused cuDNN block; K4 the three gathers of the
     probe, each bitwise its plain version (ctx[idx], zero rows outside
     [0, HW); the one-hot's -0.0 as +0.0 and NaN from 0 x inf) at its card
     cases, graph-timed. Each kernel's entry carries its bound (bytes
     over 3.35 TB/s or operations over the data sheet's peak, the larger),
     its launches a forward as counted in phase 5's main-path run, and one
     PyTorch call's time where one call computes the same function
     (torch.topk for K1, ctx[idx] for K4);
  3. the tiny configs (copies of tests/tiny_configs.py), BEVHeight and
     SGV3D, each with a top-k lift + cull and with the all-bin lift, served
     on the card and on the CPU in float32: head tensors within 1e-3 of
     their scale, decoded boxes equal as a tie-aware set; then with
     `bf16_head=True` (bf16 on the card, float32 on the CPU): heads within
     BF16_HEAD_TOL of their scale, boxes equal as sets;
  4. `bevheight_dair_r101_128` at 864x1536, uint8 images, batch 4, seeded
     weights, serving defaults (bf16 backbone, static rig, pixel cull,
     top-16 lift): `__call__` once and `stream` over 3 batches, with the
     kernels' launch counts set to 0 just before and read just after, then
     20 timed batches each way; then `bf16_head=True` beside the fp32 head
     (heads within BF16_HEAD_TOL, 20 alternating batches each, the head
     alone fp32, bf16 NCHW (the predictor's layout) and bf16 channels_last,
     event means and kernel time); then the exact all-bin
     lift;
  5. `sgv3d_r50_128` the same way with `fused_convs=True`: K1 (1 a
     forward), K2 (the same count each forward, the prep's memset and
     kernels and the pool's) and K3 (12 a forward) launch counts, finite
     outputs, a background-suppression keep
     share strictly between 0 and 1, the four r50 stage outputs within 5e-2
     of the unfused (cuDNN) ones, and 20 timed batches fused on and off;
  6. the evaluation path, `runner.evaluate` from a flax-msgpack file that
     this script writes itself (`write_flax_msgpack`; no flax, no msgpack)
     on a fake KITTI root (`write_fake_kitti_root`, under `build/`): the
     tiny BEVHeight and SGV3D, parity-grade and `fast_lift`, on the card
     and on the CPU (detections equal as tie-aware sets, KITTI lines equal
     as multisets within 1e-3, AP dicts equal); then
     `bevheight_dair_r101_128` at full width on 64 frames of 1080x1920,
     batch 4, parity-grade (K2's all-bin launches counted) and `fast_lift`
     (K1 and K2 top-k launches counted), K1 and K2 held against their
     plain versions on the inputs of their first call in each pass, with
     the loop's steady seconds a batch, the loader's share of it, the
     loader's own seconds a batch on its thread and the peak device
     memory. Phase 4 also times HeightNet and its DCN alone and checks
     that the DCN's offsets are float32 under bf16 autocast;
  7. the training path: K2b (the lift's backward, `csrc/lift_splat_bwd.cu`)
     against `lift_splat_backward_plain` at `sgv3d_r50_128`'s training
     shape (height (2, 90, 20736) on its 108 x 192 map, g (2, 16384, 87)):
     on uniform cells (the worst case: a tile's points share next to no
     rows) and on the rig's own cells (`rig_lift_cells`: 2,849,856 live
     points), each in the all-bin and the top-k layout (K1's 16 picks),
     and at a ragged 13 x 77 map, within 1e-5 * max|ref| + 1e-6, bitwise
     equal across two runs, trash points' d_height exactly 0, graph-timed
     beside the plain version and its bound, with the kernel's tile
     (TH, TW, staged rows) and the share of live points it served from
     staged rows (at least that of the tiles whose distinct cells fit,
     `tile_distinct_cells`); K2's forward timed at the training shape too;
     then C4 (`phase_c4`): K2 and K2b on four rig frames in one batch
     bitwise each frame alone, both layouts, and the first stage of the
     r101 serving forward (ResNet, neck, HeightNet, the lift, the head)
     whose per-frame output differs between batch 2 and batch 4
     (reported); the tiny BEVHeight and
     SGV3D, one float32 train step on the card against the CPU (losses
     and grad_norm within 1e-4 relative, each leaf's gradient within 1e-3
     of its own max |g|), all-bin and `train_lift_top_k=4` (with a planted
     fault, the picks' gradient sent one bin off, that must fail); then
     `sgv3d_r50_128` at full width, batch 2, bf16 image
     side: `runner.train` on a fake root of 24 frames of 1080x1920 with
     masks for 10 steps (K2 and K2b launches counted from 0 over the run
     and checked equal every step), the step-10 checkpoint restored into a
     fresh state bitwise, a resume to step 12 through `tools/train.py`,
     and the steady seconds a step, the loader's wait share and the peak
     memory printed, with the card's own step time on one batch, its
     device time by launching operator, and BatchNorm's forward and
     backward a step timed alone beside cuDNN's fused batch norm; then
     `train_lift_top_k=16` for 4 steps (K1, K2 and K2b launches a step,
     finite losses, peak memory, the card's step alone beside the all-bin
     one's);
  8. the SAM ViT-B image encoder: a tiny one card vs CPU within 1e-4, then
     `build_sam_vit_b()` at 1024x1024, batch 1, float32 (TF32 off), seeded:
     output (1, 64, 64, 256) finite, median of 10 calls, peak memory;
  9. distribution, in spawned processes (`phase_dist`; the kernels were
     built above, so no two ranks build at once): (a) NCCL at world size
     1: its all-reduce, object gather and barrier, and the tiny BEVHeight
     step under the group bitwise the step without one; (b) two gloo
     ranks sharing the card (NCCL refuses two ranks on one card): the
     tiny BEVHeight and SGV3D 2-rank steps, dropout on, against this
     process's step on the concatenated batch under the train step's
     gates, and three planted faults (per-rank BatchNorm, per-rank loss
     normalisers, gradients summed and not averaged) that must fail them;
     `sgv3d_r50_128` at its own widths, batch 2 a rank, `runner.train`
     for 3 steps (K2 / K2b 9 / 1 a step on each rank, the ranks' states
     the same bits every step, one rank-0 checkpoint; seconds a step, the
     gradient all-reduce's seconds, the BatchNorm all-reduces a step, peak
     memory a rank: gloo's times, not NCCL's); r101 parity-grade
     evaluation of one checkpoint on 16 frames, batch 4 a rank: rank 0's
     KITTI lines those of this process's evaluation, rank 1 None; (c)
     NCCL across two cards where the machine has two.
The line before the last is the card's name and power limit from
nvidia-smi; the last line is {"ok": true, "device": {...}}. The kernels
line carries K1-K4 and K2b; K2's and K2b's launches of the all-bin
training run are `launches_train` and `launches`, K1's, K2's and K2b's of
the top-k training run `launches_train_topk`, K2's and K2b's of the
distributed run, a list by rank, `launches_dist_train` and
`launches_dist_eval`. Needs no jax.

`--time-k1` prints only K1's serving call (no bins) at the r50 serving
shape, graph-timed, as JSON, for whichever `sgv3d_tpu_torch` is first on
the path: copy this file into another tree's root (e.g. the parent
commit's `git archive`) and run both alternately in one machine to
compare that tree's K1 with this one's. `--time-k2b` does the same for
K2b: five graph-timed means of 20 calls on each of the rig all-bin, rig
top-k, uniform all-bin and uniform top-k cases of `k2b_cases`, with a
digest of each case's outputs (two trees whose kernels give the same bits
print the same digests); `--time-k2` times K2's forward on those inputs.
`--sweep-k2b` builds K2b with each of K2B_VARIANTS' constants (tile
shape, staging rows, block shape, rows in flight) from its own source,
holds each variant's outputs bitwise to the package kernel's and prints
their graph-timed means on the same four cases.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import io
import json
import multiprocessing
import multiprocessing.connection
import os
import pickle
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sgv3d_tpu_torch.config import BackboneConfig, ExpConfig, HeadConfig, Task

TINY_TASKS = (Task(("car",)), Task(("pedestrian", "cyclist")))
TINY_CLASSES = ("car", "pedestrian", "cyclist")


def tiny_backbone(is_bsm=False):
    return BackboneConfig(
        x_bound=(0.0, 25.6, 1.6),
        y_bound=(-12.8, 12.8, 1.6),
        z_bound=(-5.0, 3.0, 8.0),
        d_bound=(-2.0, 3.5, 8),
        final_dim=(64, 96),
        output_channels=16,
        downsample_factor=16,
        resnet_depth=18,
        img_neck_out_channels=(8, 8, 8, 8),
        height_net_mid_channels=(32, 16),
        semantic_channels=4,
        is_bsm=is_bsm,
    )


def tiny_head(is_bsm=False):
    bev_in = 16 + (4 if is_bsm else 0)
    return HeadConfig(
        tasks=TINY_TASKS,
        in_channels=32,
        bev_backbone_in_channels=bev_in,
        bev_backbone_base_channels=16,
        bev_neck_out_channels=(8, 8, 8, 8),
        bev_neck_upsample_strides=(1, 2, 4, 8),
        share_conv_channels=16,
        point_cloud_range=(0, -12.8, -5, 25.6, 12.8, 3),
        grid_size=(64, 64, 1),
        voxel_size=(0.4, 0.4, 8),
        out_size_factor=4,
        max_objs=20,
        post_center_range=(-5.0, -20.0, -10.0, 30.0, 20.0, 10.0),
        max_per_task=32,
        nms_min_radius=(4.0, 0.5),
        post_max_size=10,
    )


def tiny_exp(is_bsm=False):
    return ExpConfig(
        name="tiny_bsm" if is_bsm else "tiny",
        backbone=tiny_backbone(is_bsm),
        head=tiny_head(is_bsm),
        classes=TINY_CLASSES,
        is_train_height=True,
    )


def tiny_serving_exp(top_k: int | None = 4, is_bsm: bool = False):
    """The tiny exp with a top-k lift and a BEV range shrunk so that a band
    of pixels is wholly out of the grid and the cull has work to do."""
    cfg = tiny_exp(is_bsm)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, lift_top_k=top_k,
        x_bound=(0.0, 12.8, 1.6), y_bound=(-6.4, 6.4, 1.6)))


def match_sets(ref, got, tol: float = 0.05) -> dict:
    """Tie-aware comparison of two detection sets [boxes (M, 9), scores,
    labels]. Boxes whose score ties bit for bit with another's are dropped
    first (within a tie the kept subset is arbitrary); every remaining
    reference box must find an unused same-label box in `got` whose
    [box, score] differs by at most `tol` relative (greedy nearest). Returns
    {'unmatched': n, 'max_delta': worst matched delta}."""
    def untied(scores):
        uniq, counts = np.unique(scores, return_counts=True)
        return ~np.isin(scores, uniq[counts > 1])

    rb, rs, rl = (np.asarray(a) for a in ref)
    gb, gs, gl = (np.asarray(a) for a in got)
    rk, gk = untied(rs), untied(gs)
    ref_vals = np.concatenate([rb, rs[:, None]], 1)[rk]
    got_vals = np.concatenate([gb, gs[:, None]], 1)[gk]
    ref_labels, got_labels = rl[rk], gl[gk]
    used = np.zeros(len(got_vals), bool)
    unmatched, max_delta = 0, 0.0
    for lab, vec in zip(ref_labels, ref_vals):
        cand = np.where((got_labels == lab) & ~used)[0]
        if len(cand) == 0:
            unmatched += 1
            continue
        rel = np.max(np.abs(got_vals[cand] - vec[None])
                     / np.maximum(np.abs(vec[None]), 1.0), axis=1)
        if rel.min() > tol:
            unmatched += 1
            continue
        used[cand[int(np.argmin(rel))]] = True
        max_delta = max(max_delta, float(rel.min()))
    return {"unmatched": unmatched, "max_delta": max_delta}


def match_sets_across_ties(ref, got, tol: float = 0.05) -> int:
    """`match_sets` both ways for two sets whose scores tie on one side and
    not the other (a bf16 head's heatmap takes few values, so its scores
    tie exactly where a float32 head's differ): a box that matches a box
    tied on the other side is left out on its own side too, as
    `match_sets` leaves the tied ones out. Returns the unmatched boxes of
    the two directions."""
    def without_twins_of(a, b):
        ab, as_, al = (np.asarray(x) for x in a)
        bb, bs, bl = (np.asarray(x) for x in b)
        uniq, counts = np.unique(bs, return_counts=True)
        tied = np.isin(bs, uniq[counts > 1])
        keep = np.ones(len(as_), bool)
        vb = np.concatenate([bb, bs[:, None]], 1)[tied]
        for i, vec in enumerate(np.concatenate([ab, as_[:, None]], 1)):
            cand = bl[tied] == al[i]
            rel = (np.abs(vb[cand] - vec[None]) / np.maximum(np.abs(vec[None]), 1.0))
            keep[i] = not (len(rel) and rel.max(axis=1).min() <= tol)
        return ab[keep], as_[keep], al[keep]

    return (match_sets(without_twins_of(ref, got), got, tol)["unmatched"]
            + match_sets(without_twins_of(got, ref), ref, tol)["unmatched"])


def write_flax_msgpack(tree, path) -> None:
    """Write a tree of dicts (str keys) and numpy arrays in flax's msgpack
    format, as `flax.serialization.msgpack_serialize` does but in msgpack's
    widest encodings (an array is ext type 1 holding (shape, dtype name,
    C-order bytes)): the inverse of `weights.read_flax_msgpack`, so this
    script writes checkpoints with neither flax nor msgpack."""
    def enc(x) -> bytes:
        if isinstance(x, dict):
            return b"".join([struct.pack(">BI", 0xdf, len(x))]
                            + [enc(k) + enc(v) for k, v in x.items()])
        if isinstance(x, (list, tuple)):
            return b"".join([struct.pack(">BI", 0xdd, len(x))]
                            + [enc(v) for v in x])
        if isinstance(x, str):
            return struct.pack(">BI", 0xdb, len(x.encode())) + x.encode()
        if isinstance(x, int):
            return struct.pack(">Bq", 0xd3, x)
        if isinstance(x, bytes):
            return struct.pack(">BI", 0xc6, len(x)) + x
        if isinstance(x, np.ndarray):
            a = np.ascontiguousarray(x)
            payload = enc([list(a.shape), a.dtype.name, a.tobytes()])
            return struct.pack(">BIb", 0xc9, len(payload), 1) + payload
        raise TypeError(f"write_flax_msgpack: no encoding for {type(x)}")

    Path(path).write_bytes(enc(tree))


def eval_detections(out_dir) -> dict:
    """{token: [boxes (M, 9), scores, labels]} from an evaluation's
    results_nusc.json; boxes (x, y, z, w, l, h, yaw, vx, vy), labels the
    index of the class name in the sorted names of the file."""
    with open(os.path.join(out_dir, "results_nusc.json")) as f:
        results = json.load(f)["results"]
    names = sorted({a["detection_name"] for v in results.values() for a in v})
    out = {}
    for token, annos in results.items():
        out[token] = [
            np.array([a["translation"] + a["size"] + [a["box_yaw"]]
                      + a["velocity"] for a in annos]).reshape(-1, 9),
            np.array([a["detection_score"] for a in annos]),
            np.array([names.index(a["detection_name"]) for a in annos])]
    return out


def kitti_lines(out_dir) -> dict:
    """{file name: [(class, fields)]} of an evaluation's KITTI label files."""
    data = os.path.join(out_dir, "data")
    out = {}
    for name in sorted(os.listdir(data)):
        with open(os.path.join(data, name)) as f:
            out[name] = [(ln.split()[0], np.array(ln.split()[1:], float))
                         for ln in f.read().splitlines()]
    return out


def compare_evaluations(ref_dir, got_dir, tol: float = 1e-3) -> tuple[int, int]:
    """Two evaluations' outputs: per frame, the detections equal as
    tie-aware sets (`match_sets`, within `tol` relative, both ways), and
    the KITTI lines equal as multisets, each reference line matched by an
    unused line of its class with every field within `tol` of
    max(1, |value|) (the writer rounds to 4 decimals). Raises on a
    difference; returns (detections, lines)."""
    ref, got = eval_detections(ref_dir), eval_detections(got_dir)
    if ref.keys() != got.keys():
        raise AssertionError(f"frames differ: {sorted(ref)} vs {sorted(got)}")
    for token in ref:
        for a, b in ((ref[token], got[token]), (got[token], ref[token])):
            m = match_sets(a, b, tol=tol)
            if m["unmatched"]:
                raise AssertionError(f"frame {token}: {m['unmatched']} "
                                     f"detections unmatched")
    ref_lines, got_lines = kitti_lines(ref_dir), kitti_lines(got_dir)
    if ref_lines.keys() != got_lines.keys():
        raise AssertionError("the KITTI files differ")
    for name, lines in ref_lines.items():
        cand = got_lines[name]
        if len(cand) != len(lines):
            raise AssertionError(f"{name}: {len(lines)} vs {len(cand)} lines")
        used = [False] * len(cand)
        for cls, vals in lines:
            hit = next((i for i, (c, v) in enumerate(cand) if not used[i]
                        and c == cls and np.all(np.abs(v - vals) <= tol
                                                * np.maximum(1, np.abs(vals)))),
                       None)
            if hit is None:
                raise AssertionError(f"{name}: no match for {cls} {vals}")
            used[hit] = True
    return (sum(len(d[1]) for d in ref.values()),
            sum(len(v) for v in ref_lines.values()))


# ---------------------------------------------------------------------------


TIMED_CALLS = 20       # timed batches per serving measurement


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn` over `iters` calls captured in one CUDA
    graph and replayed (after a warm-up call and a warm-up replay), so that
    the host's enqueue of each call is out of the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# NVIDIA's data sheet for the H100 SXM (dense): bf16 tensor cores, float32
# outside them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _bound(tensors, flops: float, peak_flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    of `tensors` (each input read once, each output written once) over
    HBM's rate and `flops` over `peak_flops`, and which of the two it is."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _wall_ms(call, n: int) -> list[float]:
    """Host wall time of `call(i)` for i < n, each ending in the readback
    of its detections (so the card has finished), in ms."""
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        call(i)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_build():
    from sgv3d_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"-> {lib_path.relative_to(cuda_lib.BUILD_ROOT.parents[1])}")
    log = lib_path.parent / "nvcc.log"
    if log.exists():
        name = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = _kernel_label(line.split("'")[1])
            elif "Used" in line or "spill stores" in line:
                print(f"[build] ptxas {name}: {line.split(':', 1)[-1].strip()}")
            elif "C7520" in line:   # wgmma serialized: a slow kernel
                print(f"[build] ptxas: {line.strip()}")


def _kernel_label(mangled: str) -> str:
    """A short name for a mangled kernel symbol: its first identifier that
    ends in "kernel", and K3's template arguments (P, TH, TW, stages)."""
    names, i = [], 0
    while i < len(mangled):
        m = re.match(r"(\d+)", mangled[i:])
        if not m:
            i += 1
            continue
        n, start = int(m.group(1)), i + len(m.group(1))
        names.append(mangled[start:start + n])
        i = start + n
    label = next((n for n in names if n.endswith("kernel")), mangled[:40])
    args = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if args:
        p, th, tw, st = args.groups()
        label += f"<P={p}, {th}x{tw}, {st} stages>"
    return label


def check_prep(height, cells, batch: int, num_cells: int, name: str) -> int:
    """K2's prep on the card against `lift_prep_plain` (per-key counts,
    their scan and `torch.sort(stable=True)`): the same offsets and order
    exactly, and each slot's (row, weight) the row and height of its
    point. Returns the live points."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_prep_plain, lift_splat_prep

    got = lift_splat_prep(height, cells, batch, num_cells)
    offsets, order = lift_prep_plain(cells, batch, num_cells)
    _, j, hw = height.shape
    rows = (order // (j * hw)) * hw + order % hw
    if not (torch.equal(got["offsets"].long(), offsets)
            and torch.equal(got["order"].long(), order)
            and torch.equal(got["rows"].long(), rows)
            and torch.equal(got["weights"], height.reshape(-1)[order])):
        raise AssertionError(f"K2 prep ({name}) differs from the plain prep "
                             f"(torch.sort(stable=True))")
    return order.numel()


def phase_kernels(dev, smi) -> list[dict]:
    """K1 and K2 at the shapes of both served paths: SGV3D-r50 (the cull
    keeps 18432 of 108x192 pixels, C = 80 + 7 = 87) and BEVHeight-r101
    (4608 of 54x96 pixels, C = 80), and at the r101 evaluation's top-k
    shape (no rig cache, so no cull: all 5184 pixels; its all-bin shape is
    the served one). "ms" is device time (`_graph_ms`: at r101 a call's
    host enqueue is longer than its kernels), "call_ms" the wrapper's
    back-to-back time with the host in it."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward, lift_splat_plain
    from sgv3d_tpu_torch.ops.topk_cells import (
        lanes_per_pixel, topk_cells_plain, topk_with_cells)
    from sgv3d_tpu_torch.tools.lift_probe import k2_launchers

    g = torch.Generator(device=dev).manual_seed(0)
    n, d, k, num_cells = 4, 90, 16, 16384
    k1 = {"name": "topk_cells", "route": "cuda",
          "source": "sgv3d_tpu_torch/csrc/topk_cells.cu",
          "replaces": "sgv3d_tpu/ops/pallas_topk.py:50", "max_abs_err": 0.0,
          "library_note": "torch.topk(h, k, dim=-1): values and indices "
                          "only; no tie order, no cells"}
    k2 = {"name": "lift_splat", "route": "cuda",
          "source": "sgv3d_tpu_torch/csrc/lift_splat.cu",
          "replaces": "sgv3d_tpu/ops/pallas_lift_splat.py:87",
          "max_abs_err": 0.0, "library_ms": None,
          "library_note": "none: no single PyTorch call forms height x "
                          "context and segment-sums it into cells"}
    for path, hw, hw_all, c in (("sgv3d_r50", 18432, 20736, 87),
                                ("r101", 4608, 5184, 80),
                                ("r101_eval", 5184, None, 80)):
        suffix = "" if path == "sgv3d_r50" else f"_{path}"
        h, cells = k1_inputs(g, n, hw, d, num_cells, dev)
        lanes = lanes_per_pixel(n * hw)
        check_k1(h, cells, k, f"{path}, serving")
        check_k1(h, cells, k, f"{path}, with bins", return_bins=True)
        k1["ms" + suffix] = _graph_ms(lambda: topk_with_cells(h, cells, k))
        k1["call_ms" + suffix] = _cuda_ms(lambda: topk_with_cells(h, cells, k))
        k1["plain_ms" + suffix] = _cuda_ms(lambda: topk_cells_plain(h, cells, k))
        k1["library_ms" + suffix] = _graph_ms(lambda: torch.topk(h, k, dim=-1))
        got = topk_with_cells(h, cells, k)
        # one compare a candidate bin, on the fp32 cores
        k1["bound_ms" + suffix], k1["bound_by" + suffix] = _bound(
            (h, cells) + tuple(got), h.numel(), PEAK_FP32_FLOPS)
        k1["shape" + suffix] = [n, hw, d, k]
        k1["lanes_per_pixel" + suffix] = lanes
        bins_note = ""
        if path == "sgv3d_r50":
            k1["ms_bins"] = _graph_ms(
                lambda: topk_with_cells(h, cells, k, return_bins=True))
            bins_note = (f"; with bins {k1['ms_bins']:.4f} ms; serving "
                         f"{k1['ms'] / K1_PARENT_MS:.3f}x the parent code's "
                         f"{K1_PARENT_MS} ms in PERF.md (earlier runs, not "
                         f"this one)")
        print(f"[kernels] K1 topk_cells {path} ({n}, {hw}, {d}) k={k}, {lanes} "
              f"lanes a pixel: exact, bins too; "
              f"kernel {k1['ms' + suffix]:.4f} ms (wrapper call "
              f"{k1['call_ms' + suffix]:.4f} ms), plain "
              f"{k1['plain_ms' + suffix]:.4f} ms, torch.topk "
              f"{k1['library_ms' + suffix]:.4f} ms, bound "
              f"{k1['bound_ms' + suffix]:.4f} ms ({k1['bound_by' + suffix]})"
              f"{bins_note} ({smi})")

        # K2 in both layouts into 128x128 cells; a quarter of the points in
        # the trash cell, as off-grid bins are on the main path
        layouts = [("top-k", k, hw)] + ([("all-bin", d, hw_all)] if hw_all else [])
        for layout, j, hwl in layouts:
            height = torch.rand(n, j, hwl, generator=g, device=dev)
            ctx = torch.randn(n, hwl, c, generator=g, device=dev)
            cl = torch.randint(0, num_cells, (n, j, hwl), generator=g,
                               device=dev, dtype=torch.int32)
            trash = torch.rand(n, j, hwl, generator=g, device=dev) < 0.25
            cl = torch.where(trash, num_cells, cl).to(torch.int32)
            args = (height, ctx, cl, n, num_cells)
            live = check_prep(height, cl, n, num_cells, f"{path}, {layout}")
            out1 = lift_splat_forward(*args)
            out2 = lift_splat_forward(*args)
            ref = lift_splat_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(out1, out2):
                raise AssertionError(f"K2 ({path}, {layout}) is not bitwise "
                                     f"deterministic")
            err = float((out1 - ref).abs().max())
            bound = 1e-5 * float(ref.abs().max()) + 1e-6
            if not err <= bound:
                raise AssertionError(f"K2 ({path}, {layout}) max|err| {err} > "
                                     f"{bound}")
            ms = _graph_ms(lambda: lift_splat_forward(*args))
            call_ms = _cuda_ms(lambda: lift_splat_forward(*args))
            prep, pool = k2_launchers(*args)
            prep_ms, pool_ms = _graph_ms(prep), _graph_ms(pool)
            plain_ms = _cuda_ms(lambda: lift_splat_plain(*args))
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            tag = suffix if layout == "top-k" else "_all_bin" + suffix
            # one multiply-add a (point, channel), on the fp32 cores
            bound_ms, bound_by = _bound((height, ctx, cl, out1),
                                        2 * height.numel() * c, PEAK_FP32_FLOPS)
            k2.update({"ms" + tag: ms, "call_ms" + tag: call_ms,
                       "prep_ms" + tag: prep_ms,
                       "pool_ms" + tag: pool_ms, "plain_ms" + tag: plain_ms,
                       "bound_ms" + tag: bound_ms, "bound_by" + tag: bound_by,
                       "shape" + tag: [n, j, hwl, c]})
            print(f"[kernels] K2 lift_splat {path} {layout} ({n}, {j}, {hwl}) x "
                  f"C={c}: order of the {live} live points equals torch.sort("
                  f"stable=True)'s; max|err| {err:.3e} <= {bound:.3e}, bitwise "
                  f"deterministic; kernel {ms:.4f} ms (prep {prep_ms:.4f}, pool "
                  f"{pool_ms:.4f}; wrapper call {call_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}) ({smi})")
    # K1 with its bins at the training shape of sgv3d_r50_128 (batch 2, no
    # cull: every pixel of the stride-8 map)
    nt, hwt = 2, 20736
    h, cells = k1_inputs(g, nt, hwt, d, num_cells, dev)
    check_k1(h, cells, k, "training, with bins", return_bins=True)
    got = topk_with_cells(h, cells, k, return_bins=True)
    k1["ms_train_bins"] = _graph_ms(
        lambda: topk_with_cells(h, cells, k, return_bins=True))
    k1["plain_ms_train_bins"] = _cuda_ms(
        lambda: topk_cells_plain(h, cells, k, return_bins=True))
    k1["library_ms_train"] = _graph_ms(lambda: torch.topk(h, k, dim=-1))
    k1["bound_ms_train_bins"], k1["bound_by_train_bins"] = _bound(
        (h, cells) + tuple(got), h.numel(), PEAK_FP32_FLOPS)
    k1["shape_train"] = [nt, hwt, d, k]
    print(f"[kernels] K1 topk_cells training ({nt}, {hwt}, {d}) k={k} with "
          f"bins: exact; kernel {k1['ms_train_bins']:.4f} ms, plain "
          f"{k1['plain_ms_train_bins']:.4f} ms, torch.topk "
          f"{k1['library_ms_train']:.4f} ms, bound "
          f"{k1['bound_ms_train_bins']:.4f} ms ({k1['bound_by_train_bins']}) "
          f"({smi})")
    return [k1, k2]


# PERF.md's K1 device time at the r50 serving shape before K1 wrote its
# bins (PRs 5-8), printed beside this run's for reference only;
# `--time-k1` measures another tree's K1 on the same machine
K1_PARENT_MS = 0.0518


def k1_inputs(g, n: int, hw: int, d: int, num_cells: int, dev):
    """K1's inputs (N, HW, D): softmax rows; every 7th row quantised (exact
    ties), every 17th flat (a whole row equal, the softmax of zero logits);
    rows padded with -inf, some with fewer than k = 16 finite bins."""
    h = torch.softmax(torch.randn(n, hw, d, generator=g, device=dev) * 3, -1)
    h[:, ::7] = torch.randint(0, 4, (n, len(range(0, hw, 7)), d), generator=g,
                              device=dev).float() / 4
    h[:, 3::17] = 1.0 / d
    h[:, 1::11, 50:] = float("-inf")
    h[:, 2::13, 5:] = float("-inf")
    cells = torch.randint(0, num_cells + 1, (n, hw, d), generator=g,
                          device=dev, dtype=torch.int32)
    return h, cells


def check_k1(h, cells, k: int, name: str, return_bins: bool = False) -> None:
    """K1 on the card exactly `topk_cells_plain`: values, cells and, with
    `return_bins`, the bins (ties to the lowest bin)."""
    from sgv3d_tpu_torch.ops.topk_cells import topk_cells_plain, topk_with_cells

    got = topk_with_cells(h, cells, k, return_bins=return_bins)
    ref = topk_cells_plain(h, cells, k, return_bins=return_bins)
    torch.cuda.synchronize()
    if len(got) != len(ref) or not all(torch.equal(a, b) for a, b in zip(got, ref)):
        bad = sum(int((a != b).sum()) for a, b in zip(got, ref))
        raise AssertionError(f"K1 ({name}) differs from its plain version at "
                             f"{bad} outputs")


def time_k1(iters: int = 20) -> float:
    """K1's serving call (no bins) graph-timed at the r50 serving shape on
    `k1_inputs`, for whichever tree is first on `sys.path` (`--time-k1`)."""
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    h, cells = k1_inputs(g, 4, 18432, 90, 16384, dev)
    return _graph_ms(lambda: topk_with_cells(h, cells, 16), iters)


# (P, H, W) of each ResNet-50 stage at 864x1536: C = 4P, 2 / 3 / 5 / 2
# identity blocks after each stage's first
R50_STAGES = ((64, 216, 384), (128, 108, 192), (256, 54, 96), (512, 27, 48))


def seeded_bottleneck(c: int, p: int, seed: int, device):
    """A `Bottleneck` with seeded weights and large positive BatchNorm
    biases (so a kernel that leaked relu(b1) through conv2's zero padding
    would be off by far more than the tolerance), in eval mode on
    `device`, and its fold."""
    from sgv3d_tpu_torch.nn.resnet import Bottleneck
    from sgv3d_tpu_torch.ops.fused_bottleneck import fold_bottleneck
    from sgv3d_tpu_torch.weights import random_init

    block = Bottleneck(c, p)
    random_init(block, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in (block.bn1, block.bn2, block.bn3):
            bn.bias.copy_(torch.randn(bn.bias.shape, generator=gen).abs() + 0.5)
    block = block.to(device).eval()
    return block, fold_bottleneck(block)


# ragged shapes: H and W not multiples of any tile, so the halo predicate
# and the ring's last stages are exercised at a partial tile on every side
K3_RAGGED = ((1, 13, 21, 256), (2, 27, 50, 2048))


def _k3_check(fb, x, name: str) -> tuple[torch.Tensor, float, float]:
    """K3 on x twice against its plain version: bitwise equal runs, within
    2e-2 * max|plain|. Returns (output, max|err|, the bound)."""
    from sgv3d_tpu_torch.ops.fused_bottleneck import (
        fused_bottleneck, fused_bottleneck_plain)

    out1 = fused_bottleneck(x, fb)
    out2 = fused_bottleneck(x, fb)
    ref = fused_bottleneck_plain(x, fb)
    torch.cuda.synchronize()
    if not torch.equal(out1, out2):
        raise AssertionError(f"K3 {name} is not bitwise deterministic")
    err = float((out1.float() - ref.float()).abs().max())
    bound = 2e-2 * float(ref.float().abs().max())
    if not err <= bound:
        raise AssertionError(f"K3 {name} {tuple(x.shape)}: max|err| {err} > "
                             f"{bound}")
    return out1, err, bound


def phase_k3(dev, smi) -> dict:
    """K3 at each r50 stage's shape, batch 4, and at ragged shapes: against
    its plain version within 2e-2 * max|plain| (both round y1 and y2 to
    bf16, in another sum order), bitwise equal across two runs, with large
    positive BN biases; at the stage shapes timed beside the plain version
    and beside the unfused bf16 cuDNN block (BatchNorm unfolded) that it
    replaces on the serving path, with its bound."""
    from sgv3d_tpu_torch.ops.fused_bottleneck import (
        fused_bottleneck, fused_bottleneck_plain)

    entry = {"name": "fused_bottleneck", "route": "cuda",
             "source": "sgv3d_tpu_torch/csrc/fused_bottleneck.cu",
             "replaces": "sgv3d_tpu/ops/pallas_bottleneck.py:189",
             "max_abs_err": 0.0, "library_ms": None,
             "library_note": "none: a bottleneck is several PyTorch calls; "
                             "the unfused cuDNN block is cudnn_unfused_ms",
             "stages": [], "ragged": []}
    g = torch.Generator(device=dev).manual_seed(3)
    for b, h, w, c in K3_RAGGED:
        _, fb = seeded_bottleneck(c, c // 4, seed=h + w, device=dev)
        x = torch.randn(b, h, w, c, generator=g, device=dev).to(torch.bfloat16)
        _, err, bound = _k3_check(fb, x, "ragged")
        entry["ragged"].append({"shape": [b, h, w, c], "max_abs_err": err,
                                "bound": bound})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"[kernels] K3 fused_bottleneck ragged ({b}, {h}, {w}, {c}): "
              f"max|err| {err:.3e} <= {bound:.3e}, bitwise deterministic")
    for stage, (p, h, w) in enumerate(R50_STAGES, start=1):
        c = 4 * p
        block, fb = seeded_bottleneck(c, p, seed=stage, device=dev)
        x = torch.randn(4, h, w, c, generator=g, device=dev).to(torch.bfloat16)
        out1, err, bound = _k3_check(fb, x, f"layer{stage}")
        x_cl = x.permute(0, 3, 1, 2)          # channels_last NCHW, no copy
        block = block.to(memory_format=torch.channels_last)

        def cudnn():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return block(x_cl)

        # 17 P^2 multiply-adds a pixel on the bf16 tensor cores; x in, the
        # output and the folded weights once
        bound_ms, bound_by = _bound((x, out1) + fb.tensors(),
                                    2 * 17 * p * p * x.numel() // c,
                                    PEAK_BF16_FLOPS)
        with torch.inference_mode():
            unfused = cudnn().permute(0, 2, 3, 1).float()
            unfused_ratio = float((out1.float() - unfused).abs().max()) / float(
                unfused.abs().max())
            row = {"stage": f"layer{stage}", "shape": [4, h, w, c], "p": p,
                   "max_abs_err": err, "bound": bound,
                   "vs_unfused_ratio": unfused_ratio,
                   "ms": _cuda_ms(lambda: fused_bottleneck(x, fb)),
                   "plain_ms": _cuda_ms(lambda: fused_bottleneck_plain(x, fb)),
                   "cudnn_unfused_ms": _cuda_ms(cudnn),
                   "bound_ms": bound_ms, "bound_by": bound_by}
        entry["stages"].append(row)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"[kernels] K3 fused_bottleneck layer{stage} (4, {h}, {w}, {c}) "
              f"P={p}: max|err| {err:.3e} <= {bound:.3e}, bitwise "
              f"deterministic, vs the unfused bf16 block {unfused_ratio:.3e} "
              f"of scale; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, cuDNN unfused block {row['cudnn_unfused_ms']:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) ({smi})")
        del x, out1, unfused
    # the top-level numbers: the sum over the twelve identity blocks of an
    # r50 forward at batch 4 (2, 3, 5, 2 blocks at the four stages)
    counts = (2, 3, 5, 2)
    for key in ("ms", "plain_ms", "cudnn_unfused_ms", "bound_ms"):
        entry[key] = sum(n * r[key] for n, r in zip(counts, entry["stages"]))
    entry["bound_by"] = "operations" if sum(
        n * r["bound_ms"] for n, r in zip(counts, entry["stages"])
        if r["bound_by"] == "operations") >= entry["bound_ms"] / 2 else "bytes"
    print(f"[kernels] K3 over the 12 identity blocks of an r50 forward: kernel "
          f"{entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, cuDNN "
          f"unfused {entry['cudnn_unfused_ms']:.3f} ms, bound "
          f"{entry['bound_ms']:.3f} ms ({smi})")
    return entry


def time_k4(iters: int = 20) -> dict:
    """Device time of each K4 formulation and of `ctx[idx]` at the probe's
    shape, 20 calls in one CUDA graph (`_graph_ms`), from whichever
    `sgv3d_tpu_torch` is first on `sys.path` (to time another tree's
    kernels in the same call, load this file by path with that tree first)."""
    from sgv3d_tpu_torch.tools import spike_gather

    ctx, idx = spike_gather.probe_inputs(torch.device("cuda"))
    times = {name: _graph_ms(lambda: fn(ctx, idx), iters)
             for name, fn in spike_gather.FORMULATIONS}
    times["ctx[idx]"] = _graph_ms(lambda: ctx[idx], iters)
    return times


def phase_k4(dev, smi) -> list[dict]:
    """K4, the gather probe, through its entry point: each formulation
    bitwise equal to its plain version and to itself across two calls at
    every card case (`spike_gather.check`); launches are counted over the
    probe's run, its only path. "ms" is device time (`_graph_ms`: against
    a 6.8 us bound the gap between back-to-back launches is a large share
    of an event mean), "event_ms" the back-to-back event mean beside it.
    The bound of all three is the function's bytes; the one-hot's entry
    also carries two operations floors beside it: the dense product's, and
    that of the products it issues (one m64n128k16 for each (m64 tile, k16
    slab) that a row of the tile indexes)."""
    from sgv3d_tpu_torch.tools import spike_gather

    for _, fn in spike_gather.FORMULATIONS:
        fn.launches = 0
    rows = spike_gather.run(dev)
    launches = {name: fn.launches for name, fn in spike_gather.FORMULATIONS}
    ctx, idx = spike_gather.probe_inputs(dev)
    graph = time_k4()
    library_event_ms = _cuda_ms(lambda: ctx[idx])
    # ctx and idx read once, the gathered rows written once
    bytes_ms, _ = _bound((ctx, idx, ctx[idx]), 0, PEAK_BF16_FLOPS)
    share = spike_gather.slab_share(idx, ctx.shape[0])
    dense_flops = 2.0 * idx.numel() * ctx.shape[0] * ctx.shape[1]
    tiles, slabs = -(-idx.numel() // 64), -(-ctx.shape[0] // 16)
    issued_flops = round(share * tiles * slabs) * 2.0 * 64 * 16 * ctx.shape[1]
    floors = {"dense_floor_ms": dense_flops / PEAK_BF16_FLOPS * 1e3,
              "issued_floor_ms": issued_flops / PEAK_BF16_FLOPS * 1e3,
              "issued_slab_share": share}
    print(f"[kernels] K4 one-hot: {share:.4f} of (m64 tile, k16 slab) pairs "
          f"issued (host count from idx); operations floor dense "
          f"{floors['dense_floor_ms']:.4f} ms, issued "
          f"{floors['issued_floor_ms']:.4f} ms at {PEAK_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s bf16")
    entries = []
    for (name, _), row, line in zip(spike_gather.FORMULATIONS, rows, (28, 34, 41)):
        onehot = name == "onehot-mma"
        entries.append({"name": f"spike_gather.{name}", "route": "cuda",
                        "source": "sgv3d_tpu_torch/csrc/spike_gather.cu",
                        "replaces": f"tools/spike_pallas_gather.py:{line}",
                        "launches": launches[name], "launches_per_forward": 0,
                        "max_abs_err": 0.0, "ms": graph[name],
                        "event_ms": row["ms"], "plain_ms": row["plain_ms"],
                        "library_ms": graph["ctx[idx]"],
                        "library_event_ms": library_event_ms,
                        "library_note": "ctx[idx]", "bound_ms": bytes_ms,
                        "bound_by": "bytes",
                        "shape": [spike_gather.N_CHUNKS, spike_gather.M,
                                  spike_gather.C], **(floors if onehot else {})})
        if not launches[name]:
            raise AssertionError(f"K4 {name} was not launched")
        print(f"[kernels] K4 spike_gather {name} ({spike_gather.N_CHUNKS}, "
              f"{spike_gather.M}) rows of ({spike_gather.HW}, {spike_gather.C}):"
              f" bitwise its plain version at its card cases; kernel "
              f"{graph[name]:.4f} ms (event mean {row['ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms, ctx[idx] {graph['ctx[idx]']:.4f} ms "
              f"(event mean {library_event_ms:.4f}), bound {bytes_ms:.4f} ms "
              f"(bytes) ({smi})")
    return entries


def phase_tiny(dev):
    from sgv3d_tpu_torch.api import BEVHeightPredictor
    from sgv3d_tpu_torch.data.synthetic import make_batch
    from sgv3d_tpu_torch.weights import seeded_state_dict

    for is_bsm, top_k in ((False, 4), (False, None), (True, 4), (True, None)):
        cfg = tiny_serving_exp(top_k, is_bsm)
        imgs, mats, *_ = make_batch(cfg, batch=2, seed=1, num_objs=2)
        state = seeded_state_dict(cfg, seed=1)
        on_card = BEVHeightPredictor(cfg, state, device=dev, use_bf16=False)
        on_cpu = BEVHeightPredictor(cfg, state, device="cpu")
        heads_card = on_card.predict_heads(imgs, mats)
        heads_cpu = on_cpu.predict_heads(imgs, mats)
        worst = 0.0
        for tc, tr in zip(heads_card, heads_cpu):
            for name in tr:
                a, r = tc[name].cpu().numpy(), tr[name].numpy()
                if not np.isfinite(a).all():
                    raise AssertionError(f"tiny {name}: non-finite on the card")
                worst = max(worst, float(np.abs(a - r).max())
                            / max(float(np.abs(r).max()), 1e-6))
        if not worst <= 1e-3:
            raise AssertionError(f"{cfg.name} heads (top_k={top_k}): card vs "
                                 f"CPU {worst:.3e} of scale > 1e-3")
        dets_card, dets_cpu = on_card(imgs, mats), on_cpu(imgs, mats)
        for i, (got, ref) in enumerate(zip(dets_card, dets_cpu)):
            m = match_sets(ref, got)
            if m["unmatched"]:
                raise AssertionError(f"{cfg.name} sample {i} (top_k={top_k}): "
                                     f"{m['unmatched']} boxes unmatched")
        cull = "off" if on_card._cells[1] is None else \
            f"{on_card._cells[0].shape[1]} of {cfg.backbone.feat_hw[0] * cfg.backbone.feat_hw[1]} pixels"
        print(f"[tiny] {cfg.name} lift_top_k={top_k}, cull {cull}: heads card vs CPU "
              f"{worst:.3e} of scale; detections {[len(d[0]) for d in dets_card]} "
              f"match as sets")

    # the bf16 BEV head on the card against the CPU's float32 head (the
    # predictor applies bf16_head on CUDA only)
    for is_bsm in (False, True):
        cfg = tiny_serving_exp(4, is_bsm)
        imgs, mats, *_ = make_batch(cfg, batch=2, seed=1, num_objs=2)
        state = seeded_state_dict(cfg, seed=1)
        on_card = BEVHeightPredictor(cfg, state, device=dev, use_bf16=False,
                                     bf16_head=True)
        on_cpu = BEVHeightPredictor(cfg, state, device="cpu", bf16_head=True)
        if (on_card.model.head.dtype, on_cpu.model.head.dtype) != (torch.bfloat16, None):
            raise AssertionError("bf16_head: the card's head must be bf16, the "
                                 "CPU's float32")
        worst = head_error(on_card.predict_heads(imgs, mats),
                           on_cpu.predict_heads(imgs, mats))
        if not worst <= BF16_HEAD_TOL:
            raise AssertionError(f"{cfg.name} bf16 head on the card vs the "
                                 f"CPU's fp32 head: {worst:.3e} of scale > "
                                 f"{BF16_HEAD_TOL}")
        dets_card, dets_cpu = on_card(imgs, mats), on_cpu(imgs, mats)
        for i, (got, ref) in enumerate(zip(dets_card, dets_cpu)):
            unmatched = match_sets_across_ties(ref, got)
            if unmatched:
                raise AssertionError(f"{cfg.name} bf16 head sample {i}: "
                                     f"{unmatched} boxes unmatched")
        print(f"[tiny] {cfg.name} bf16_head=True: heads card (bf16) vs CPU "
              f"(fp32) {worst:.3e} of scale (bound {BF16_HEAD_TOL}); "
              f"detections {[len(d[0]) for d in dets_card]} against "
              f"{[len(d[0]) for d in dets_cpu]} match as sets (ties on "
              f"either side left out)")


# the bf16 head against a float32 one, each output against its own max
# |value|: ~20 layers of bf16 rounding (3.9e-3 relative a rounding), 1.1-1.9e-2
# in the CPU tests (tests/test_torch_bf16_head.py)
BF16_HEAD_TOL = 4e-2


def head_error(heads, heads_ref) -> float:
    """The largest max|a - r| / max|r| over the head's outputs; raises on a
    non-finite output."""
    worst = 0.0
    for task, task_ref in zip(heads, heads_ref):
        for name, r in task_ref.items():
            a = task[name].float().cpu()
            r = r.float().cpu()
            if not torch.isfinite(a).all():
                raise AssertionError(f"head output {name} is not finite")
            worst = max(worst, float((a - r).abs().max())
                        / max(float(r.abs().max()), 1e-6))
    return worst


def _kernel_ms(fn, iters: int = 5) -> float:
    """The device time of `fn`'s kernels a call, from `torch.profiler` over
    `iters` calls after a warm-up (what a CUDA-event time of a launch-bound
    call cannot give: that one times the host's enqueue)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


def time_bev_head(cfg, state_dict, batch: int, dev) -> dict:
    """The BEV head alone on a seeded BEV map (B, Y, X, C) under inference
    mode: float32 NCHW (the serving default), bf16 NCHW (the predictor's
    layout) and bf16 channels_last (the weights moved to channels_last,
    so cuDNN runs every activation after the first conv channels_last),
    each as the CUDA-event mean of 20 calls ("_ms", the host's enqueue in
    it) and its kernels' device time ("_kernel_ms")."""
    from sgv3d_tpu_torch.heads.bev_head import BEVHeightHead

    head_sd = {k[len("head."):]: v for k, v in state_dict.items()
               if k.startswith("head.")}
    grid = cfg.backbone.voxel_grid
    g = torch.Generator(device=dev).manual_seed(0)
    bev = torch.randn(batch, int(grid.voxel_num[1]), int(grid.voxel_num[0]),
                      cfg.head.bev_backbone_in_channels, generator=g, device=dev)
    out = {}
    for key, dtype, channels_last in (("fp32_ms", None, False),
                                      ("bf16_nchw_ms", torch.bfloat16, False),
                                      ("bf16_channels_last_ms", torch.bfloat16, True)):
        head = BEVHeightHead(cfg.head, dtype=dtype)
        head.load_state_dict(head_sd)
        head = head.to(dev).eval()
        if channels_last:
            head.to(memory_format=torch.channels_last)
        with torch.inference_mode():
            out[key] = _cuda_ms(lambda: head(bev))
            out[key.replace("_ms", "_kernel_ms")] = _kernel_ms(lambda: head(bev))
    return out


def time_heightnet(exp: str = "bevheight_dair_r101_128", batch: int = 4) -> dict:
    """HeightNet and its deformable conv alone at `exp`'s shapes, seeded,
    under the serving predictor's bf16 autocast (channels_last, TF32 off):
    the mean of 20 calls each after a warm-up, and the dtype of the DCN's
    offsets. To time another tree's package in the same call, load this
    file with that tree first on `sys.path`."""
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.nn.height_net import HeightNet
    from sgv3d_tpu_torch.weights import random_init

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_exp(exp).backbone
    f_h, f_w = cfg.feat_hw
    cin, mid = sum(cfg.img_neck_out_channels), cfg.height_net_mid_channels[0]
    net = HeightNet(cin, mid, cfg.output_channels, cfg.num_height_bins)
    random_init(net, seed=0)
    net = net.to(dev).eval().to(memory_format=torch.channels_last)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(batch, cin, f_h, f_w, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    mlp = torch.randn(batch, 27, generator=g, device=dev)
    h = torch.randn(batch, mid, f_h, f_w, generator=g, device=dev).to(
        torch.bfloat16).to(memory_format=torch.channels_last)
    offsets = []
    hook = net.dcn.offset_conv.register_forward_hook(
        lambda mod, args, out: offsets.append(out.dtype))

    def run(fn, *args):
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return fn(*args)

    run(net.dcn, h)
    hook.remove()
    return {"heightnet_ms": _cuda_ms(lambda: run(net, x, mlp)),
            "dcn_ms": _cuda_ms(lambda: run(net.dcn, h)),
            "dcn_offsets": str(offsets[0]).replace("torch.", ""),
            "shape": [batch, cin, f_h, f_w], "dcn_shape": [batch, mid, f_h, f_w]}


def phase_full(dev, smi):
    from sgv3d_tpu_torch.api import BEVHeightPredictor
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import make_batch
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells
    from sgv3d_tpu_torch.weights import seeded_state_dict

    cfg = get_exp("bevheight_dair_r101_128")
    batch = 4
    rng = np.random.default_rng(0)
    _, mats, *_ = make_batch(cfg, batch=batch, seed=0, num_objs=1, max_objs=1)
    shape = (batch, 1, 1) + cfg.backbone.final_dim + (3,)
    batches = [(rng.integers(0, 256, shape, dtype=np.uint8), mats)
               for _ in range(4)]
    t0 = time.perf_counter()
    state = seeded_state_dict(cfg, seed=0)
    predictor = BEVHeightPredictor(cfg, state, device=dev)
    print(f"[full] {cfg.name}: seeded weights + predictor in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    predictor(*batches[0])                 # first call: rig cells, cull, cuDNN
    print(f"[full] first call (rig cells + cull + warm-up) "
          f"{time.perf_counter() - t0:.3f} s; cull keeps "
          f"{predictor._cells[0].shape[1]} of "
          f"{cfg.backbone.feat_hw[0] * cfg.backbone.feat_hw[1]} pixels")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    topk_with_cells.launches = 0
    lift_splat_forward.launches = 0
    results = [predictor(*batches[0])]
    results += list(predictor.stream(iter(batches[1:])))
    launches = {"topk_cells": topk_with_cells.launches,
                "lift_splat": lift_splat_forward.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    if len(results) != 4 or not all(launches.values()):
        raise AssertionError(f"main path: {len(results)} batches, launches "
                             f"{launches}")
    cap = cfg.head.num_tasks * cfg.head.post_max_size
    for res in results:
        if len(res) != batch:
            raise AssertionError(f"{len(res)} samples in a batch of {batch}")
        for boxes, scores, labels in res:
            if not (boxes.shape[0] <= cap and boxes.shape[1:] == (9,)
                    and np.isfinite(boxes).all() and np.isfinite(scores).all()):
                raise AssertionError(f"bad detections {boxes.shape}")
    n_dets = [len(r[0]) for res in results for r in res]
    print(f"[full] launches in the main-path run: {launches}")
    print(f"[full] detections per sample: {n_dets} (<= {cap}), all finite")
    calls = _wall_ms(lambda i: predictor(*batches[i % 4]), TIMED_CALLS)
    t0 = time.perf_counter()
    list(predictor.stream(batches[i % 4] for i in range(TIMED_CALLS)))
    stream_ms = (time.perf_counter() - t0) * 1e3 / TIMED_CALLS
    print(f"[full] wall time per batch of {batch} at 864x1536 over "
          f"{TIMED_CALLS} batches: __call__ median {np.median(calls):.2f} ms "
          f"(min {min(calls):.2f}, max {max(calls):.2f}), stream mean "
          f"{stream_ms:.2f} ms ({smi})")
    print(f"[full] peak torch.cuda.max_memory_allocated: "
          f"{peak / 2 ** 30:.3f} GiB ({smi})")

    hn = time_heightnet(cfg.name, batch)
    if hn["dcn_offsets"] != "float32":
        raise AssertionError(f"DeformConv's offsets are {hn['dcn_offsets']} "
                             f"under bf16 autocast, not float32")
    print(f"[full] HeightNet alone {tuple(hn['shape'])} under bf16 autocast "
          f"{hn['heightnet_ms']:.3f} ms, its DeformConv {tuple(hn['dcn_shape'])} "
          f"{hn['dcn_ms']:.3f} ms (offsets float32) ({smi})")

    # the bf16 BEV head beside the fp32 one, batch by batch
    bf16 = BEVHeightPredictor(cfg, state, device=dev, bf16_head=True)
    head_err = head_error(bf16.predict_heads(*batches[0]),
                          predictor.predict_heads(*batches[0]))
    if not head_err <= BF16_HEAD_TOL:
        raise AssertionError(f"bf16 head vs fp32 head at r101: {head_err:.3e} "
                             f"of scale > {BF16_HEAD_TOL}")
    on_ms, off_ms = [], []
    for i in range(TIMED_CALLS):
        on_ms += _wall_ms(lambda _: bf16(*batches[i % 4]), 1)
        off_ms += _wall_ms(lambda _: predictor(*batches[i % 4]), 1)
    heads = time_bev_head(cfg, state, batch, dev)
    print(f"[full] bf16_head=True: heads within {head_err:.3e} of the fp32 "
          f"head's scale (bound {BF16_HEAD_TOL}); __call__ median "
          f"{np.median(on_ms):.2f} ms (min {min(on_ms):.2f}) against the fp32 "
          f"head's {np.median(off_ms):.2f} ms (min {min(off_ms):.2f}), "
          f"{TIMED_CALLS} batches each, alternating; the head alone (event "
          f"mean / kernels): fp32 {heads['fp32_ms']:.3f} / "
          f"{heads['fp32_kernel_ms']:.3f} ms, bf16 NCHW "
          f"{heads['bf16_nchw_ms']:.3f} / {heads['bf16_nchw_kernel_ms']:.3f} ms, "
          f"bf16 channels_last {heads['bf16_channels_last_ms']:.3f} / "
          f"{heads['bf16_channels_last_kernel_ms']:.3f} ms ({smi})")
    del bf16
    bf16_head = {"call_ms_median": float(np.median(on_ms)), "call_ms_min": min(on_ms),
                 "fp32_head_call_ms_median": float(np.median(off_ms)),
                 "fp32_head_call_ms_min": min(off_ms), "head_max_rel_err": head_err,
                 **{f"head_alone_{k}": v for k, v in heads.items()}}

    # the exact all-bin lift (runner.eval_config), so K2 runs its D layout
    exact_cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, lift_top_k=None))
    predictor = BEVHeightPredictor(exact_cfg, state, device=dev)
    lift_splat_forward.launches = 0
    res = predictor(*batches[0])
    all_bin_launches = lift_splat_forward.launches
    if not all_bin_launches or not all(
            np.isfinite(b).all() and len(b) <= cap for b, _, _ in res):
        raise AssertionError("all-bin lift run failed")
    exact_ms = _wall_ms(lambda i: predictor(*batches[i % 4]), TIMED_CALLS)
    print(f"[full] exact all-bin lift: {all_bin_launches} K2 launches; "
          f"{[len(r[0]) for r in res]} detections; "
          f"__call__ median {np.median(exact_ms):.2f} ms per batch of {batch} "
          f"over {TIMED_CALLS} ({smi})")
    return launches, {"batch": batch, "call_ms_median": float(np.median(calls)),
                      "call_ms_min": min(calls), "call_ms_max": max(calls),
                      "stream_ms_mean": stream_ms,
                      "all_bin_call_ms_median": float(np.median(exact_ms)),
                      "timed_batches": TIMED_CALLS,
                      "peak_mem_gib": peak / 2 ** 30,
                      "heightnet_ms": hn["heightnet_ms"], "dcn_ms": hn["dcn_ms"],
                      "bf16_head": bf16_head}


def phase_sgv3d(dev, smi, cfg=None, batch: int = 4):
    """SGV3D (default `sgv3d_r50_128`) at full width with `fused_convs=True`."""
    from sgv3d_tpu_torch.api import BEVHeightPredictor
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import make_batch
    from sgv3d_tpu_torch.models.bev_height import normalize_images
    from sgv3d_tpu_torch.ops.fused_bottleneck import fused_bottleneck
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells
    from sgv3d_tpu_torch.weights import seeded_state_dict

    cfg = cfg or get_exp("sgv3d_r50_128")
    rng = np.random.default_rng(0)
    _, mats, *_ = make_batch(cfg, batch=batch, seed=0, num_objs=1, max_objs=1)
    shape = (batch, 1, 1) + cfg.backbone.final_dim + (3,)
    batches = [(rng.integers(0, 256, shape, dtype=np.uint8), mats)
               for _ in range(4)]
    t0 = time.perf_counter()
    state = seeded_state_dict(cfg, seed=0)
    fused = BEVHeightPredictor(cfg, state, device=dev, fused_convs=True)
    unfused = BEVHeightPredictor(cfg, state, device=dev)
    print(f"[sgv3d] {cfg.name}: seeded weights + two predictors (fused_convs "
          f"on / off) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fused(*batches[0])                 # first call: rig cells, cull, cuDNN
    first_s = time.perf_counter() - t0
    kept = fused._cells[0].shape[1]
    print(f"[sgv3d] first call (rig cells + cull + warm-up) {first_s:.3f} s; "
          f"cull keeps {kept} of "
          f"{cfg.backbone.feat_hw[0] * cfg.backbone.feat_hw[1]} pixels")
    unfused(*batches[0])

    # the keep share of background suppression, read off the stage-two
    # semantic logits: with random weights a mask of all zeros (or ones)
    # would leave the checks below vacuous
    semantic = []
    hook = fused.model.backbone.height_net.semantic_head1.register_forward_hook(
        lambda mod, args, out: semantic.append(out.detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in (topk_with_cells, lift_splat_forward, fused_bottleneck):
        fn.launches = 0
    results = [fused(*batches[0])]
    results += list(fused.stream(iter(batches[1:])))
    launches = {"topk_cells": topk_with_cells.launches,
                "lift_splat": lift_splat_forward.launches,
                "fused_bottleneck": fused_bottleneck.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    hook.remove()
    forwards = len(results)
    if (forwards != 4 or launches["topk_cells"] != forwards
            or not launches["lift_splat"] or launches["lift_splat"] % forwards
            or launches["fused_bottleneck"] != 12 * forwards):
        raise AssertionError(f"main path: {forwards} batches, launches "
                             f"{launches} (K1 must launch once a forward, K2 "
                             f"as often each forward, K3 12 times)")
    cap = cfg.head.num_tasks * cfg.head.post_max_size
    for res in results:
        if len(res) != batch:
            raise AssertionError(f"{len(res)} samples in a batch of {batch}")
        for boxes, scores, labels in res:
            if not (boxes.shape[0] <= cap and boxes.shape[1:] == (9,)
                    and np.isfinite(boxes).all() and np.isfinite(scores).all()):
                raise AssertionError(f"bad detections {boxes.shape}")
    p_bg = torch.cat([torch.softmax(s.float(), dim=1)[:, 0] for s in semantic])
    keep_share = float((p_bg <= 0.45).float().mean())
    if len(semantic) != forwards or not 0.0 < keep_share < 1.0:
        raise AssertionError(f"background-suppression keep share {keep_share} "
                             f"over {len(semantic)} forwards; need 0 < s < 1")
    n_dets = [len(r[0]) for res in results for r in res]
    print(f"[sgv3d] launches in the main-path run: {launches}")
    print(f"[sgv3d] detections per sample: {n_dets} (<= {cap}), all finite; "
          f"background-suppression keep share {keep_share:.4f}")

    # the four ResNet-50 stage outputs, K3 (folded BN) against cuDNN
    # (unfolded BN), on the same normalised images
    with torch.inference_mode(), torch.autocast(dev.type, dtype=torch.bfloat16):
        x = normalize_images(torch.from_numpy(batches[0][0]).to(dev), cfg)
        x = x.reshape(batch, *x.shape[3:]).permute(0, 3, 1, 2)
        outs_f = fused.model.backbone.img_backbone(x)
        outs_u = unfused.model.backbone.img_backbone(x)
    ratios = [float((f.float() - u.float()).abs().max() / u.float().abs().max())
              for f, u in zip(outs_f, outs_u)]
    if not all(r <= 5e-2 for r in ratios):
        raise AssertionError(f"fused vs unfused r50 stages: {ratios} of scale "
                             f"(bound 5e-2)")
    print(f"[sgv3d] r50 stage outputs, fused_convs on vs off: max|diff| / "
          f"max|off| = {[f'{r:.3e}' for r in ratios]} (bound 5e-2)")
    del x, outs_f, outs_u

    # alternate the two predictors batch by batch, so both see the same
    # card state
    on_ms, off_ms = [], []
    for i in range(TIMED_CALLS):
        on_ms += _wall_ms(lambda _: fused(*batches[i % 4]), 1)
        off_ms += _wall_ms(lambda _: unfused(*batches[i % 4]), 1)
    t0 = time.perf_counter()
    list(fused.stream(batches[i % 4] for i in range(TIMED_CALLS)))
    stream_ms = (time.perf_counter() - t0) * 1e3 / TIMED_CALLS
    print(f"[sgv3d] wall time per batch of {batch} at "
          f"{cfg.backbone.final_dim[0]}x{cfg.backbone.final_dim[1]} over "
          f"{TIMED_CALLS} batches each: __call__ median fused_convs on "
          f"{np.median(on_ms):.2f} ms (min {min(on_ms):.2f}, max "
          f"{max(on_ms):.2f}), off {np.median(off_ms):.2f} ms (min "
          f"{min(off_ms):.2f}, max {max(off_ms):.2f}); stream mean (on) "
          f"{stream_ms:.2f} ms ({smi})")
    print(f"[sgv3d] peak torch.cuda.max_memory_allocated: "
          f"{peak / 2 ** 30:.3f} GiB ({smi})")
    return launches, forwards, {
        "exp": cfg.name, "batch": batch, "fused_convs": True,
        "call_ms_median": float(np.median(on_ms)), "call_ms_min": min(on_ms),
        "call_ms_max": max(on_ms),
        "unfused_call_ms_median": float(np.median(off_ms)),
        "unfused_call_ms_min": min(off_ms), "unfused_call_ms_max": max(off_ms),
        "stream_ms_mean": stream_ms, "timed_batches": TIMED_CALLS,
        "first_call_s": first_s, "cull_kept_pixels": kept,
        "keep_share": keep_share, "stage_ratios": ratios,
        "peak_mem_gib": peak / 2 ** 30}


EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
# sixteen batches of 4: the loop's steady state (batches 2-15, each with one
# wait on the loader) outlasts the loader's head start during the first
# batch's warm-up (a queue of 2 plus one in hand) four times over
EVAL_FRAMES = 64


def _seeded_checkpoint(cfg, seed: int, path: Path) -> float:
    """Seeded weights for `cfg` written as a flax-msgpack file; returns its
    size in MB. The heatmap biases are set to 0 (scores near 0.5 where
    `random_init` leaves them near 0.1), so that the writer's 0.45 score
    cut keeps boxes and the KITTI lines and AP have work to do."""
    from sgv3d_tpu_torch.models.bev_height import BEVHeight
    from sgv3d_tpu_torch.nn.blocks import SeparateTaskBranch
    from sgv3d_tpu_torch.weights import random_init, to_flax

    model = BEVHeight(cfg)
    random_init(model, seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SeparateTaskBranch) and m.init_bias is not None:
                m.final.bias.zero_()
    write_flax_msgpack(to_flax(model), path)
    return path.stat().st_size / 1e6


def _quiet_evaluate(**kw):
    """`runner.evaluate`, its printed AP table kept out of this log."""
    from sgv3d_tpu_torch import runner

    with contextlib.redirect_stdout(io.StringIO()):
        return runner.evaluate(**kw)


def offset_gt(src: Path, dst: Path) -> None:
    """The KITTI lines in `src` written to `dst` as GT, every box moved by
    0.5 px in the image and 1 cm in x: the evaluator's rotated IoU is 0 for
    boxes that coincide exactly (lines scored against themselves give a
    3D mAP of 0), and a detection 1 cm off is far from both IoU cuts."""
    shutil.rmtree(dst)
    dst.mkdir()
    for name in os.listdir(src):
        lines = []
        for line in (src / name).read_text().splitlines():
            cls, *vals = line.split()
            vals = [float(v) for v in vals]
            vals[3:7] = [v + 0.5 for v in vals[3:7]]     # bbox
            vals[10] += 0.01                               # location x
            lines.append(" ".join([cls] + [f"{v:.4f}" for v in vals]))
        (dst / name).write_text("\n".join(lines) + "\n")


def phase_eval_tiny(dev):
    """The evaluation path at the tiny configs, BEVHeight and SGV3D,
    parity-grade and `fast_lift`, on `dev` against the CPU, from one
    checkpoint file each, on a fake root of 5 frames (the last batch of 2
    ragged). Random weights score 0 AP against the root's own GT, so each
    config's GT is first replaced by the KITTI lines of a parity-grade CPU
    run (`offset_gt`): the AP dicts compared then hold nonzero APs."""
    from sgv3d_tpu_torch.data.synthetic import write_fake_kitti_root

    shutil.rmtree(EVAL_DIR / "tiny", ignore_errors=True)
    src_hw = (216, 384)
    root = write_fake_kitti_root(EVAL_DIR / "tiny" / "rope3d-kitti", 5,
                                 src_hw=src_hw, seed=0)
    gt_dir = Path(root) / "training" / "label_eval"
    for is_bsm in (False, True):
        cfg = tiny_exp(is_bsm)
        cfg = dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, lift_top_k=4),
            batch_size_per_device=2, data_root=root, src_hw=src_hw,
            is_train_height=False)
        ckpt = EVAL_DIR / "tiny" / f"{cfg.name}.msgpack"
        _seeded_checkpoint(cfg, 2, ckpt)
        gt_src = EVAL_DIR / "tiny" / f"{cfg.name}_gt"
        _quiet_evaluate(cfg=cfg, ckpt_path=str(ckpt), output_dir=str(gt_src),
                        device=torch.device("cpu"))
        offset_gt(gt_src / "data", gt_dir)
        for fast_lift in (False, True):
            out, res = {}, {}
            for where in (dev, torch.device("cpu")):
                out[where.type] = str(EVAL_DIR / "tiny" /
                                      f"{cfg.name}_{fast_lift}_{where.type}")
                res[where.type] = _quiet_evaluate(
                    cfg=cfg, ckpt_path=str(ckpt), output_dir=out[where.type],
                    fast_lift=fast_lift, device=where)
            n_dets, n_lines = compare_evaluations(out["cpu"], out[dev.type])
            nonzero = sum(v > 0 for v in res["cpu"][1].values())
            if not n_lines or not nonzero or res[dev.type] != res["cpu"]:
                raise AssertionError(f"{cfg.name} eval (fast_lift={fast_lift}): "
                                     f"{n_lines} KITTI lines, {nonzero} nonzero "
                                     f"APs; (mAP, AP dict) equal: "
                                     f"{res[dev.type] == res['cpu']}")
            print(f"[eval] {cfg.name} fast_lift={fast_lift}: card vs CPU, "
                  f"{n_dets} detections equal as sets, {n_lines} KITTI lines "
                  f"equal within 1e-3, AP dicts equal ({len(res['cpu'][1])} "
                  f"keys, {nonzero} nonzero, max "
                  f"{max(res['cpu'][1].values()):.2f}; mAP {res['cpu'][0]:.4f})")


@contextlib.contextmanager
def first_call_inputs(module, name: str, store: dict):
    """Within the block, calls of `module.name` also keep a copy of the
    arguments of the first one in `store[name]`."""
    fn = getattr(module, name)

    def spy(*args):
        if name not in store:
            store[name] = tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args)
        return fn(*args)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


@torch.inference_mode()
def check_captured(inputs: dict, path: str) -> dict:
    """K1 and K2 held against their plain versions on the inputs that an
    evaluation pass gave them: K1 exactly, K2 within 1e-5 of scale and
    bitwise equal across two runs. Returns the shapes checked and K2's
    max |err| beside its bound."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward, lift_splat_plain
    from sgv3d_tpu_torch.ops.topk_cells import topk_cells_plain, topk_with_cells

    checked = {}
    if "topk_with_cells" in inputs:
        args = inputs["topk_with_cells"]
        got, ref = topk_with_cells(*args), topk_cells_plain(*args)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"K1 differs from its plain version on the "
                                 f"{path} evaluation's inputs")
        checked["topk_cells_shape"] = list(args[0].shape) + [args[2]]
    args = inputs["lift_splat_forward"]
    out1, out2 = lift_splat_forward(*args), lift_splat_forward(*args)
    ref = lift_splat_plain(*args)
    err = float((out1 - ref).abs().max())
    bound = 1e-5 * float(ref.abs().max()) + 1e-6
    if not (torch.equal(out1, out2) and err <= bound):
        raise AssertionError(f"K2 on the {path} evaluation's inputs: max|err| "
                             f"{err} (bound {bound}), deterministic "
                             f"{torch.equal(out1, out2)}")
    checked.update(lift_splat_shape=list(args[0].shape) + [args[1].shape[-1]],
                   lift_splat_max_abs_err=err, lift_splat_err_bound=bound)
    return checked


def phase_eval_full(dev, smi) -> dict:
    """The evaluation path for `bevheight_dair_r101_128` at full width on
    the card, batch 4, parity-grade and `fast_lift`, each with its kernels'
    launches counted from 0 over the `evaluate` call and the inputs of
    their first call held against the plain versions after it. The loop's
    steady state is batches 1 to n-2 (from 0): batch 0 holds the warm-up,
    the last one only the final readback; batch i waits for batch i + 1."""
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import write_fake_kitti_root
    from sgv3d_tpu_torch.nn import lss_fpn
    from sgv3d_tpu_torch.ops import voxel_pooling
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells

    shutil.rmtree(EVAL_DIR / "r101", ignore_errors=True)
    cfg = get_exp("bevheight_dair_r101_128")
    t0 = time.perf_counter()
    root = write_fake_kitti_root(EVAL_DIR / "r101" / "rope3d-kitti", EVAL_FRAMES,
                                 src_hw=cfg.src_hw, seed=0)
    cfg = dataclasses.replace(cfg, batch_size_per_device=4, data_root=root,
                              is_train_height=False)
    ckpt = EVAL_DIR / "r101" / "weights.msgpack"
    mb = _seeded_checkpoint(cfg, 0, ckpt)
    print(f"[eval] {cfg.name}: fake root of {EVAL_FRAMES} frames at "
          f"{cfg.src_hw[0]}x{cfg.src_hw[1]} and a {mb:.1f} MB flax-msgpack "
          f"checkpoint written in {time.perf_counter() - t0:.2f} s")
    rows = {}
    for fast_lift, path in ((False, "parity-grade (K2 all-bin)"),
                            (True, "fast_lift (K1 + K2 top-k)")):
        inputs = {}
        topk_with_cells.launches = 0
        lift_splat_forward.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        stats = {}
        out_dir = EVAL_DIR / "r101" / ("fast_lift" if fast_lift else "all_bin")
        t0 = time.perf_counter()
        with first_call_inputs(voxel_pooling, "topk_with_cells", inputs), \
                first_call_inputs(lss_fpn, "lift_splat_forward", inputs):
            mAP, ret = _quiet_evaluate(cfg=cfg, ckpt_path=str(ckpt),
                                       output_dir=str(out_dir),
                                       fast_lift=fast_lift, device=dev,
                                       stats=stats)
        total_s = time.perf_counter() - t0
        launches = {"topk_cells": topk_with_cells.launches,
                    "lift_splat": lift_splat_forward.launches}
        peak = torch.cuda.max_memory_allocated(dev)
        files = sorted(os.listdir(out_dir / "data"))
        n_lines = sum(len(v) for v in kitti_lines(out_dir).values())
        if not (np.isfinite(mAP) and all(np.isfinite(v) for v in ret.values())
                and len(files) == EVAL_FRAMES and launches["lift_splat"]
                and bool(launches["topk_cells"]) == fast_lift):
            raise AssertionError(f"r101 eval (fast_lift={fast_lift}): mAP {mAP}, "
                                 f"{len(files)} KITTI files, launches {launches}")
        checked = check_captured(inputs, path)
        batch_s, waits = stats["batch_s"], stats["loader_wait_s"]
        build = stats["loader_build_s"]
        steady = batch_s[1:-1]
        per_batch = float(np.mean(steady))
        # the waits, and the loader's builds, of the batches it waited for
        share = sum(waits[2:]) / sum(steady)
        build_s = float(np.mean(build[2:]))
        rows["fast_lift" if fast_lift else "all_bin"] = {
            "launches": launches, "batches": len(batch_s),
            "first_batch_s": batch_s[0], "steady_batches": len(steady),
            "s_per_batch_steady": per_batch, "loader_wait_share": share,
            "loader_build_s_per_batch": build_s, "evaluate_s": total_s,
            "peak_mem_gib": peak / 2 ** 30, "mAP": float(mAP),
            "kitti_files": len(files), "kitti_lines": n_lines, **checked}
        print(f"[eval] {cfg.name} {path}, batch 4: launches {launches}; "
              f"first calls' inputs: K1 exact, K2 max|err| "
              f"{checked['lift_splat_max_abs_err']:.3e} <= "
              f"{checked['lift_splat_err_bound']:.3e} at "
              f"{tuple(checked['lift_splat_shape'])}; mAP {mAP:.4f} ({len(ret)} "
              f"AP keys, all finite); {len(files)} KITTI files, {n_lines} lines; "
              f"{len(batch_s)} batches, first {batch_s[0]:.3f} s, steady "
              f"(batches 1-{len(batch_s) - 2}) {per_batch:.4f} s a batch, "
              f"loader wait {share:.4f} of that loop; the loader's own "
              f"{build_s:.4f} s a batch on its thread; evaluate() "
              f"{total_s:.2f} s in all; peak torch.cuda.max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB ({smi})")
    shutil.rmtree(EVAL_DIR / "r101")
    return rows


# ---------------------------------------------------------------------------
# phase 7: training


K2B_RIG_EXP = "sgv3d_r50_128"   # the rig whose training-shape cells K2b gets
K2B_TOP_K = 16


def _bwd_takes_feat_w() -> bool:
    """Whether this tree's `lift_splat_backward` takes the feature map's
    width (`--time-k2b` also times trees from before it did)."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward

    return "feat_w" in inspect.signature(lift_splat_backward).parameters


def rig_lift_cells(batch: int, seed: int = 0) -> tuple[torch.Tensor, int]:
    """The all-bin training cells of K2B_RIG_EXP on `make_batch(cfg, batch,
    seed)`'s rig, computed on the CPU (the same on every machine): (batch,
    D, fH * fW) int32, and fW."""
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import make_batch
    from sgv3d_tpu_torch.nn.lss_fpn import compute_lift_cells

    bb = get_exp(K2B_RIG_EXP).backbone
    _, mats, *_ = make_batch(get_exp(K2B_RIG_EXP), batch, seed=seed)
    m = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in mats.items()}
    cells = compute_lift_cells(bb, m, train=True)
    f_h, f_w = bb.feat_hw
    return cells.reshape(batch, bb.num_height_bins, f_h * f_w).contiguous(), f_w


def k2b_cases(dev) -> dict:
    """K2b's inputs, tag -> (grad, height, context, cells, batch,
    num_cells, feat_w): at the training shape of K2B_RIG_EXP (2 cameras,
    90 bins, 108 x 192 pixels, C = 87, 128 x 128 cells), the uniform cells
    (a quarter trash; "" all-bin, "_top_k" 16 bins), which share no rows
    within a tile (the worst case), and the rig's own ("_rig": the all-bin
    cells of `rig_lift_cells`; "_rig_top_k": the cells of K1's 16 picks of
    seeded random heights over them, the picks' heights as heights); then
    "_ragged": 3 batch elements of 2 cameras, J = 13, a 13 x 77 map (HW =
    1001, neither side a multiple of the tile), C = 37. g is seeded in every
    case."""
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells

    g = torch.Generator(device=dev).manual_seed(1)
    cases = {}
    for tag, (batch, n, j, hw, c, num_cells, feat_w) in (
            ("", (2, 2, 90, 20736, 87, 16384, 192)),
            ("_top_k", (2, 2, K2B_TOP_K, 20736, 87, 16384, 192)),
            ("_ragged", (3, 6, 13, 1001, 37, 777, 77))):
        height = torch.rand(n, j, hw, generator=g, device=dev)
        ctx = torch.randn(n, hw, c, generator=g, device=dev)
        cells = torch.randint(0, num_cells, (n, j, hw), generator=g, device=dev,
                              dtype=torch.int32)
        trash = torch.rand(n, j, hw, generator=g, device=dev) < 0.25
        cells = torch.where(trash, num_cells, cells).to(torch.int32)
        grad = torch.randn(batch, num_cells, c, generator=g, device=dev)
        cases[tag] = (grad, height, ctx, cells, batch, num_cells, feat_w)
    rig, f_w = rig_lift_cells(2)
    rig = rig.to(dev)
    n, d, hw = rig.shape
    c, num_cells = 87, 16384
    g = torch.Generator(device=dev).manual_seed(2)
    grad = torch.randn(n, num_cells, c, generator=g, device=dev)
    ctx = torch.randn(n, hw, c, generator=g, device=dev)
    height = torch.rand(n, d, hw, generator=g, device=dev)
    cases["_rig"] = (grad, height, ctx, rig, n, num_cells, f_w)
    h_hwd = torch.rand(n, hw, d, generator=g, device=dev)
    vals, picked, _ = topk_with_cells(h_hwd, rig.transpose(1, 2).contiguous(),
                                      K2B_TOP_K, return_bins=True)
    cases["_rig_top_k"] = (grad, vals, ctx, picked, n, num_cells, f_w)
    return {k: cases[k] for k in ("", "_top_k", "_rig", "_rig_top_k", "_ragged")}


def tile_distinct_cells(cells: torch.Tensor, num_cells: int, feat_w: int,
                        tile: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Per tile of tile[0] x tile[1] pixels of each camera of cells (N, J,
    fH * feat_w) (cameras major, tile rows, tile columns): the distinct live
    cells (in [0, num_cells)) and the live points, int64."""
    n, _, hw = cells.shape
    f_h = hw // feat_w
    t_y, t_x = -(-f_h // tile[0]), -(-feat_w // tile[1])
    y = torch.arange(f_h, device=cells.device) // tile[0]
    x = torch.arange(feat_w, device=cells.device) // tile[1]
    tile_of = (y[:, None] * t_x + x[None, :]).reshape(-1)
    tile_of = tile_of + torch.arange(n, device=cells.device)[:, None] * (t_y * t_x)
    c = cells.long()
    live = (c >= 0) & (c < num_cells)
    tiles = tile_of[:, None, :].expand_as(c)[live]
    distinct = torch.bincount(torch.unique(tiles * num_cells + c[live]) // num_cells,
                              minlength=n * t_y * t_x)
    return distinct, torch.bincount(tiles, minlength=n * t_y * t_x)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_k2b(iters: int = 20) -> dict:
    """K2b graph-timed on the four cases of `k2b_cases` that are not ragged
    (rig all-bin, rig top-k, uniform all-bin, uniform top-k), for whichever
    tree is first on `sys.path` (`--time-k2b`), with a digest of each
    case's outputs (trees whose kernels give the same bits give the same
    digests)."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward

    cases = k2b_cases(torch.device("cuda"))
    tiled = _bwd_takes_feat_w()
    out = {}
    for tag, name in (("_rig", "rig"), ("_rig_top_k", "rig_top_k"),
                      ("", "uniform"), ("_top_k", "uniform_top_k")):
        *args, feat_w = cases[tag]
        kw = {"feat_w": feat_w} if tiled else {}
        out[name] = {"ms": _graph_ms(lambda: lift_splat_backward(*args, **kw), iters),
                     "digest": _digest(*lift_splat_backward(*args, **kw))}
    return out


def time_k2(iters: int = 20) -> dict:
    """K2's forward graph-timed on the inputs of `time_k2b`'s cases, for
    whichever tree is first on `sys.path` (`--time-k2`)."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward

    cases = k2b_cases(torch.device("cuda"))
    out = {}
    for tag, name in (("_rig", "rig"), ("_rig_top_k", "rig_top_k"),
                      ("", "uniform"), ("_top_k", "uniform_top_k")):
        _, height, ctx, cells, batch, num_cells, _ = cases[tag]
        args = (height, ctx, cells, batch, num_cells)
        out[name] = {"ms": _graph_ms(lambda: lift_splat_forward(*args), iters),
                     "digest": _digest(lift_splat_forward(*args))}
    return out


# `--sweep-k2b`: K2b built with other constants from its own source, each
# variant's outputs held bitwise to the package kernel's (the per-point
# arithmetic does not depend on them). name -> constants replaced.
K2B_VARIANTS = {
    "chosen": {},
    "tile_4x8": {"kTileH": 4},
    "tile_4x16": {"kTileH": 4, "kTileW": 16},
    "rows_256": {"kMaxRows": 256},
    "narrow_all_j": {"kNarrowJ": 256},     # the all-bin layout two blocks an SM
    "wide_all_j": {"kNarrowJ": 0},         # the top-k layout one block an SM
    "unroll_2": {"kUnroll": 2},
    "unroll_8": {"kUnroll": 8},
}


K2B_PHASES = ("load", "hash", "stage", "compute", "write")


def _with_phase_clocks(src: str) -> str:
    """K2b's source with thread 0 of each block recording clock64() since
    the block's start after each of its barriers and at its end (the five
    steps of the source note) into `k2b_phase_clocks`, read back by the
    exported `k2b_phase_read`."""
    src = src.replace("namespace {\n", "__device__ long long k2b_phase_clocks[1 << 16];\n"
                      "namespace {\n", 1)
    head = "  extern __shared__ __align__(16) unsigned char s_raw[];\n"
    src = src.replace(head, head + "  const long long t_start = clock64();\n"
                      "  int t_mark = 0;\n", 1)
    i = src.index("__global__ void __launch_bounds__")
    j = src.index("template <bool kNarrow, int CS>\nint launch(")
    rec = ("  if (threadIdx.x == 0) k2b_phase_clocks[(blockIdx.y * gridDim.x + "
           "blockIdx.x) * 8 + t_mark++] = clock64() - t_start;\n")
    body = src[i:j].replace("  __syncthreads();\n", "  __syncthreads();\n" + rec)
    k = body.rindex("}\n")
    return (src[:i] + body[:k] + rec + body[k:] + src[j:] +
            '\nextern "C" int k2b_phase_read(long long* out, int n) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(out, k2b_phase_clocks, n * 8));\n}\n")


def sweep_k2b(iters: int = 20) -> dict:
    """Each of K2B_VARIANTS compiled from `csrc/lift_splat_bwd.cu` with its
    constants replaced (one nvcc a variant, all started together, into
    `build/k2b_sweep/`), graph-timed on `time_k2b`'s four cases; a variant
    whose outputs differ from the package kernel's in any bit raises. The
    chosen constants are also built with `_with_phase_clocks`: the mean
    cycles a block spends in each of K2B_PHASES, per case."""
    import ctypes

    from sgv3d_tpu_torch.ops import cuda_lib
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward

    src = (cuda_lib.CSRC / "lift_splat_bwd.cu").read_text()
    src = re.sub(r"static_assert\(rows_offset\([^;]*;", "", src)
    out_dir = Path(__file__).resolve().parent / "build" / "k2b_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, consts in {**K2B_VARIANTS, "phases": None}.items():
        text = src if consts is not None else _with_phase_clocks(src)
        for key, value in (consts or {}).items():
            text, n = re.subn(rf"constexpr int {key} = [^;]+;",
                              f"constexpr int {key} = {value};", text)
            if n != 1:
                raise AssertionError(f"K2b sweep: no constant {key}")
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"K2b sweep: {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.lift_splat_bwd_launch.argtypes = cuda_lib.SIGNATURES["lift_splat_bwd_launch"]
        lib.lift_splat_bwd_plan.argtypes = cuda_lib.SIGNATURES["lift_splat_bwd_plan"]
        libs[name] = lib
    cases = k2b_cases(torch.device("cuda"))
    result = {}
    for name, lib in libs.items():
        for tag, label in (("_rig", "rig"), ("_rig_top_k", "rig_top_k"),
                           ("", "uniform"), ("_top_k", "uniform_top_k")):
            grad, height, ctx, cells, batch, num_cells, feat_w = cases[tag]
            n, j, hw = height.shape
            c = ctx.shape[-1]
            d_h, d_c = torch.empty_like(height), torch.empty_like(ctx)
            launched = ctypes.c_int(0)

            def call():
                cuda_lib.check(lib.lift_splat_bwd_launch(
                    grad.data_ptr(), height.data_ptr(), ctx.data_ptr(),
                    cells.data_ptr(), d_h.data_ptr(), d_c.data_ptr(), None, batch,
                    num_cells, n, j, hw, feat_w, c, ctypes.byref(launched),
                    torch.cuda.current_stream().cuda_stream), f"K2b sweep {name}")
            call()
            ref = lift_splat_backward(grad, height, ctx, cells, batch, num_cells, feat_w)
            if not (torch.equal(ref[0], d_h) and torch.equal(ref[1], d_c)):
                raise AssertionError(f"K2b sweep: {name} {label} differs from the "
                                     "package kernel")
            plan = (ctypes.c_int * 5)()
            lib.lift_splat_bwd_plan(j, c, plan)
            row = {"ms": _graph_ms(call, iters), "rows": plan[2],
                   "blocks_per_sm": plan[4]}
            if name == "phases":
                call()
                torch.cuda.synchronize()
                blocks = -(-(hw // feat_w) // 8) * -(-feat_w // 8) * n
                clocks = np.zeros((blocks, 8), np.int64)
                lib.k2b_phase_read(ctypes.c_void_p(clocks.ctypes.data), clocks.size)
                ends = clocks[:, :len(K2B_PHASES)]
                steps = np.diff(ends, axis=1, prepend=0)
                row["cycles_a_block"] = dict(zip(K2B_PHASES, steps.mean(0).tolist()))
            result.setdefault(name, {})[label] = row
    return result


def phase_k2b(dev, smi) -> dict:
    """K2b, the lift's backward, against `lift_splat_backward_plain` on each
    case of `k2b_cases` (uniform and rig cells, all-bin and top-k, and
    ragged): within 1e-5 * max|ref| + 1e-6, bitwise equal across two runs,
    trash points' d_height exactly 0. Graph-timed beside the plain version
    and its bound, with the share of live points the kernel read from its
    staged rows (`served`), at least the share of the tiles whose distinct
    cells all fit its rows; K2's forward is timed at the training shape too
    (batch 2)."""
    from sgv3d_tpu_torch.ops.lift_splat import (
        backward_plan, lift_splat_backward, lift_splat_backward_plain,
        lift_splat_forward, lift_splat_plain)

    entry = {"name": "lift_splat_bwd", "route": "cuda",
             "source": "sgv3d_tpu_torch/csrc/lift_splat_bwd.cu",
             "replaces": "sgv3d_tpu/ops/voxel_pooling.py:142",
             "max_abs_err": 0.0, "library_ms": None,
             "library_note": "none: no single PyTorch call gathers g rows at "
                             "cells and reduces them both ways"}
    k2_train = {}
    for tag, (grad, height, ctx, cells, batch, num_cells, feat_w) in k2b_cases(dev).items():
        n, j, hw = height.shape
        c = ctx.shape[-1]
        args = (grad, height, ctx, cells, batch, num_cells, feat_w)
        served = torch.zeros(1, dtype=torch.int32, device=dev)
        out1 = lift_splat_backward(*args, served=served)
        out2 = lift_splat_backward(*args)
        ref = lift_splat_backward_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for name, a, b, r in zip(("d_height", "d_ctx"), out1, out2, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"K2b{tag} {name} is not bitwise deterministic")
            err = float((a - r).abs().max())
            bound = 1e-5 * float(r.abs().max()) + 1e-6
            if not err <= bound:
                raise AssertionError(f"K2b{tag} {name}: max|err| {err} > {bound}")
            errs.append((err, bound))
        dead = (cells < 0) | (cells >= num_cells)
        if bool((out1[0][dead] != 0).any()):
            raise AssertionError(f"K2b{tag}: a trash point got a nonzero d_height")
        live = int((~dead).sum())
        plan = backward_plan(j, c)
        distinct, points = tile_distinct_cells(cells, num_cells, feat_w, plan["tile"])
        fits = int(points[distinct <= plan["rows"]].sum())
        share = int(served) / live
        if not fits <= int(served) <= live:
            raise AssertionError(f"K2b{tag}: {int(served)} points served from staged "
                                 f"rows, not within [{fits}, {live}]")
        ms = _graph_ms(lambda: lift_splat_backward(*args))
        plain_ms = _cuda_ms(lambda: lift_splat_backward_plain(*args), iters=5)
        # a dot product and an axpy of C channels a live point, fp32 cores
        bound_ms, bound_by = _bound((grad, height, ctx, cells) + tuple(out1),
                                    4.0 * live * c, PEAK_FP32_FLOPS)
        entry["max_abs_err"] = max(entry["max_abs_err"], *(e for e, _ in errs))
        entry.update({"ms" + tag: ms, "plain_ms" + tag: plain_ms,
                      "bound_ms" + tag: bound_ms, "bound_by" + tag: bound_by,
                      "shape" + tag: [batch, n, j, hw, c, num_cells],
                      "feat_w" + tag: feat_w, "live_points" + tag: live,
                      "smem_share" + tag: share,
                      "tile" + tag: [*plan["tile"], plan["rows"]]})
        q = torch.quantile(distinct.double(), torch.tensor([0.5, 0.9], dtype=torch.float64,
                                                           device=distinct.device))
        print(f"[train] K2b lift_splat_bwd{tag or ' (training shape)'} g "
              f"({batch}, {num_cells}, {c}), height ({n}, {j}, {hw}), fW {feat_w}, "
              f"{live} live points: d_height max|err| {errs[0][0]:.3e} <= "
              f"{errs[0][1]:.3e}, d_ctx {errs[1][0]:.3e} <= {errs[1][1]:.3e}, "
              f"bitwise deterministic; tile {plan['tile'][0]}x{plan['tile'][1]}, "
              f"{plan['rows']} rows, {plan['smem']} B, {plan['blocks_per_sm']} "
              f"block(s) an SM: distinct cells a tile p50 "
              f"{float(q[0]):.0f} p90 {float(q[1]):.0f} max {int(distinct.max())}, "
              f"served from staged rows {share:.4f} (tiles that fit: "
              f"{fits / live:.4f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) ({smi})")
        if tag == "":
            fwd = (height, ctx, cells, batch, num_cells)
            out, ref_f = lift_splat_forward(*fwd), lift_splat_plain(*fwd)
            err = float((out - ref_f).abs().max())
            if not err <= 1e-5 * float(ref_f.abs().max()) + 1e-6:
                raise AssertionError(f"K2 at the training shape: max|err| {err}")
            k2_train = {"ms": _graph_ms(lambda: lift_splat_forward(*fwd)),
                        "plain_ms": _cuda_ms(lambda: lift_splat_plain(*fwd), iters=5),
                        "shape": [n, j, hw, c], "max_abs_err": err}
            k2_train["bound_ms"], k2_train["bound_by"] = _bound(
                (height, ctx, cells, out), 2.0 * height.numel() * c, PEAK_FP32_FLOPS)
            print(f"[train] K2 lift_splat all-bin at the training shape ({n}, {j}, "
                  f"{hw}) x {c}, batch 2: max|err| {err:.3e}; kernel "
                  f"{k2_train['ms']:.4f} ms, plain {k2_train['plain_ms']:.4f} ms, "
                  f"bound {k2_train['bound_ms']:.4f} ms ({smi})")
    entry["k2_train"] = k2_train
    return entry


C4_FRAMES = 4


def lift_batch_invariance(dev) -> dict:
    """K2 (forward) and K2b (backward) on C4_FRAMES frames of K2B_RIG_EXP's
    rig in one batch, and on each frame alone: the number of frames whose
    outputs differ in any bit, all-bin and top-k (K1's 16 picks of seeded
    random heights). Both kernels sum each frame apart (K2's pool chunks
    start at each batch element, K2b's tiles lie in one camera), so every
    count should be 0."""
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward, lift_splat_forward
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells

    cells, f_w = rig_lift_cells(C4_FRAMES)
    cells = cells.to(dev)
    n, d, hw = cells.shape
    c, num_cells = 87, 16384
    g = torch.Generator(device=dev).manual_seed(3)
    grad = torch.randn(n, num_cells, c, generator=g, device=dev)
    ctx = torch.randn(n, hw, c, generator=g, device=dev)
    height = torch.rand(n, d, hw, generator=g, device=dev)
    vals, picked, _ = topk_with_cells(torch.rand(n, hw, d, generator=g, device=dev),
                                      cells.transpose(1, 2).contiguous(), K2B_TOP_K,
                                      return_bins=True)
    kw = {"feat_w": f_w} if _bwd_takes_feat_w() else {}
    out = {}
    for layout, (h, cl) in (("all_bin", (height, cells)), ("top_k", (vals, picked))):
        whole_f = lift_splat_forward(h, ctx, cl, n, num_cells)
        whole_b = lift_splat_backward(grad, h, ctx, cl, n, num_cells, **kw)
        f_bad = b_bad = 0
        for i in range(n):
            sl = slice(i, i + 1)
            alone_f = lift_splat_forward(h[sl], ctx[sl], cl[sl], 1, num_cells)
            alone_b = lift_splat_backward(grad[sl], h[sl], ctx[sl], cl[sl], 1,
                                          num_cells, **kw)
            f_bad += not torch.equal(alone_f[0], whole_f[i])
            b_bad += not all(torch.equal(a[0], w[i]) for a, w in zip(alone_b, whole_b))
        out[layout] = {"k2_frames_differ": f_bad, "k2b_frames_differ": b_bad}
    return out


def r101_stage_batch_diff(dev) -> dict:
    """bevheight_dair_r101_128 (seeded weights, the serving forward: bf16
    image side, top-16 lift, fp32 head) on four frames as one batch of 4
    and as two batches of 2: for each stage (ResNet, neck, HeightNet, the
    lift's BEV map, the head), the largest per-frame difference over its
    outputs' scale, and the first stage that differs at all."""
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import make_batch
    from sgv3d_tpu_torch.models.bev_height import BEVHeight
    from sgv3d_tpu_torch.weights import seeded_state_dict

    cfg = get_exp("bevheight_dair_r101_128")
    model = BEVHeight(cfg, use_bf16=True).to(dev).eval()
    model.load_state_dict(seeded_state_dict(cfg, seed=0))
    _, mats, *_ = make_batch(cfg, batch=4, seed=0, num_objs=1, max_objs=1)
    imgs = np.random.default_rng(0).integers(
        0, 256, (4, 1, 1) + cfg.backbone.final_dim + (3,), dtype=np.uint8)
    # (stage, module, its outputs compared): the backbone's first output is
    # the lift's BEV map
    stages = (("resnet", model.backbone.img_backbone, _flat_tensors),
              ("neck", model.backbone.img_neck, _flat_tensors),
              ("height_net", model.backbone.height_net, _flat_tensors),
              ("lift", model.backbone, lambda o: [o[0]]),
              ("head", model.head, _flat_tensors))

    def run(sl):
        got, hooks = {}, []
        for name, mod, pick in stages:
            hooks.append(mod.register_forward_hook(
                lambda _m, _i, o, name=name, pick=pick: got.__setitem__(name, [
                    t.detach().float() for t in pick(o)])))
        m = {k: torch.from_numpy(np.asarray(v[sl], np.float32)).to(dev)
             for k, v in mats.items()}
        with torch.no_grad():
            model(torch.from_numpy(imgs[sl]).to(dev), m)
        for hk in hooks:
            hk.remove()
        return got

    whole = run(slice(0, 4))
    halves = [run(slice(0, 2)), run(slice(2, 4))]
    report, first = {}, None
    for name, *_ in stages:
        worst = 0.0
        for i, ref in enumerate(whole[name]):
            # BEV maps and head tensors lead with the batch, image-side
            # tensors with batch x cameras (one camera here)
            part = torch.cat([h[name][i] for h in halves])
            diff = float((part - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            worst = max(worst, diff)
        report[name] = worst
        if first is None and worst > 0:
            first = name
    return {"rel_diff": report, "first_differing_stage": first}


def _flat_tensors(o) -> list:
    if isinstance(o, torch.Tensor):
        return [o]
    if isinstance(o, dict):
        return [t for k in sorted(o) for t in _flat_tensors(o[k])]
    if isinstance(o, (list, tuple)):
        return [t for x in o for t in _flat_tensors(x)]
    return []


def phase_c4(dev, smi) -> dict:
    """Whether a frame's outputs depend on its batch (ROADMAP C4): the
    lift's kernels bitwise per frame (`lift_batch_invariance`, a gate), and
    the first stage of the r101 serving forward that differs between
    batch 2 and batch 4 (`r101_stage_batch_diff`, a report)."""
    lift = lift_batch_invariance(dev)
    print(f"[c4] K2 / K2b on {C4_FRAMES} rig frames in one batch against each "
          f"frame alone, frames differing in any bit: {lift}")
    if any(v for layout in lift.values() for v in layout.values()):
        raise AssertionError(f"C4: the lift's kernels depend on the batch: {lift}")
    stages = r101_stage_batch_diff(dev)
    print(f"[c4] bevheight_dair_r101_128 forward, 4 frames as a batch of 4 "
          f"against two batches of 2: largest per-frame difference over scale "
          f"by stage {stages['rel_diff']}; first stage that differs: "
          f"{stages['first_differing_stage']} ({smi})")
    return {"lift": lift, **stages}


def _train_batch(cfg, batch: int, seed: int):
    """A batch of `batch` unlike frames (each scaled and shifted, so that the
    ASPP's global-branch BatchNorm over the frames is well conditioned) with
    boxes and semantic masks, as numpy."""
    from sgv3d_tpu_torch.data.synthetic import make_batch

    imgs, mats, boxes, labels, sem = make_batch(
        cfg, batch=batch, num_objs=5, max_objs=cfg.head.max_objs, seed=seed)
    for i in range(1, batch):
        imgs[i] = imgs[i] * (1.0 - 0.15 * i) + 0.3 * i
    return imgs, mats, boxes, labels, sem if cfg.backbone.is_bsm else None


def biases_ahead_of_batchnorm(model) -> set:
    """The conv biases whose output goes straight into a BatchNorm
    (`conv` beside `bn`, `<x>_conv` or `<x>_deconv` beside `<x>_bn`): in
    train mode the batch mean removes them, so their gradient is zero in
    exact arithmetic and only rounding is left."""
    from sgv3d_tpu_torch.nn.blocks import BatchNorm

    names = set()
    for path, module in model.named_modules():
        children = dict(module.named_children())
        for name, child in children.items():
            stem = name.rsplit("_", 1)[0] + "_bn" if "_" in name else "bn"
            if (name == "conv" or name.endswith(("_conv", "_deconv"))) \
                    and getattr(child, "bias", None) is not None \
                    and isinstance(children.get(stem), BatchNorm):
                names.add(f"{path}.{name}.bias".lstrip("."))
    return names


# The gates of one train step against a reference step (tests/
# test_torch_train_step.py holds the port to JAX with them; phase_dist and
# tests/test_torch_dist_train.py hold a 2-rank step to one process's).
# `stepped` holds the reference's metrics, gradients and state after the
# step under the keys `jax_*` (its gradients twice: `jax_grads` and
# `jax_eager_grads`, two evaluations whose difference is its own spread)
# and the step under test's under the plain keys.


def metric_rtol(key: str) -> float:
    """A step metric's relative tolerance: grad_norm 1e-2, each task's
    terms 5e-4, the other losses 3e-4."""
    if key == "grad_norm":
        return 1e-2
    return 5e-4 if key.startswith("task") else 3e-4


def check_loss_and_metrics(stepped):
    ref, got = stepped["jax_metrics"], stepped["metrics"]
    assert set(got) == set(ref)
    assert ("semantic_loss" in got) == stepped["is_bsm"]
    assert stepped["step"] == stepped["jax_step"] == 1
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=metric_rtol(key),
                                   err_msg=key)


def leaf_bounds(stepped) -> dict:
    """Each leaf's bound on |port - JAX op by op|: 1e-4 of the leaf's own
    max |g|, plus three times the largest change in that leaf between the
    reference's two evaluations (jitted step, op by op), or `stepped`'s
    "spread" of that leaf where it has one."""
    jit, eager = stepped["jax_grads"], stepped["jax_eager_grads"]
    spread = stepped.get("spread") or {
        name: float((jit[name] - g).abs().max()) for name, g in eager.items()}
    return {name: 1e-4 * float(g.abs().max()) + 3 * spread[name]
            for name, g in eager.items()}


def cancelled_leaves(stepped, floor: float = 1e-6) -> set:
    """The leaves whose gradient is under `floor` of the largest leaf on
    every side (the port, JAX jitted and op by op): a sum that cancels to
    rounding, such as an L1 term's bias where the residuals' signs
    balance."""
    sides = (stepped["grads"], stepped["jax_eager_grads"], stepped["jax_grads"])
    top = max(float(g.abs().max()) for g in stepped["jax_eager_grads"].values())
    return {name for name in sides[1]
            if all(float(side[name].abs().max()) <= floor * top for side in sides)}


def check_grads(stepped, cancelled: frozenset = frozenset()):
    """`cancelled`: leaves held, as the biases ahead of a BatchNorm are, to
    rounding on every side (`cancelled_leaves`)."""
    ref, got = stepped["jax_eager_grads"], stepped["grads"]
    assert set(got) == set(ref) == set(stepped["jax_grads"])
    top = max(float(g.abs().max()) for g in ref.values())
    assert stepped["zero_leaves"] and stepped["zero_leaves"] <= set(ref)
    zero = stepped["zero_leaves"] | cancelled
    bounds = leaf_bounds(stepped)
    for name, g_ref in ref.items():
        if name in zero:        # rounding only, on every side
            for side in (got, ref, stepped["jax_grads"]):
                assert float(side[name].abs().max()) <= 1e-4 * top, name
            continue
        err = float((got[name] - g_ref).abs().max())
        assert err <= bounds[name], (name, err, bounds[name],
                                     float(g_ref.abs().max()))
    total_ref = sum(float(g.abs().sum()) for g in ref.values())
    total = sum(float(g.abs().sum()) for g in got.values())
    np.testing.assert_allclose(total, total_ref, rtol=1e-2)
    assert sum(float(g.abs().max()) > 0 for g in ref.values()) > 0.8 * len(ref)


def check_after_the_step(stepped, min_firm: float = 0.05,
                         cancelled: frozenset = frozenset()):
    """`min_firm`: the least share of the elements held to the tight bound,
    a floor on what the check sees (the reference's own spread decides it);
    `cancelled` as in `check_grads`."""
    ref, got = stepped["jax_after"], stepped["after"]
    assert set(got) == set(ref)
    lr = stepped["lr"]
    bounds = leaf_bounds(stepped)
    zero = stepped["zero_leaves"] | cancelled
    firm_total = 0
    for name, r in ref.items():
        g = got[name]
        if name.endswith(("running_mean", "running_var")):
            err = float((g - r).abs().max())
            assert err <= 3e-4 * float(r.abs().max()) + 2e-5, (name, err)
            continue
        assert float((g - r).abs().max()) <= 2 * lr + 1e-7, name
        # the JAX step applied its jitted gradients; the port's are within
        # bounds[name] of the op-by-op ones, which are within a third of
        # it of the jitted ones: where |g| exceeds twice that, signs agree
        g_ref = stepped["jax_grads"][name]
        firm = g_ref.abs() > (np.inf if name in zero else 2 * bounds[name])
        np.testing.assert_allclose(g[firm], r[firm], rtol=1e-6, atol=1e-2 * lr,
                                   err_msg=name)
        # a gradient far above eps moves its element by about lr
        moved = (r - stepped["params_before"][name]).abs()
        assert bool((moved[firm & (g_ref.abs() > 1e-6)] > 0.5 * lr).all()), name
        firm_total += int(firm.sum())
    # a twentieth of the elements and more are held to the tight bound
    # (measured: 14% of BEVHeight's, 5.8% of SGV3D's)
    assert firm_total > min_firm * sum(v.numel() for k, v in ref.items()
                                  if not k.endswith(("running_mean", "running_var")))


def train_step_record(cfg, state_dict, batch, device, dropout: bool = False,
                      num_devices: int = 1) -> dict:
    """One float32 `train_step` of `cfg` from `state_dict` on `device`
    (under a process group: this rank's step on its rows), the ASPPs'
    dropout on or off, the LR that of `num_devices` devices. Returns, on
    the CPU: 'metrics' (floats), 'grads' ({parameter: the gradient the
    optimizer took}), 'after' (the state_dict after the step), 'lr', 'step'."""
    from sgv3d_tpu_torch.models.bev_height import BEVHeight
    from sgv3d_tpu_torch.nn.blocks import ASPP
    from sgv3d_tpu_torch.train.loop import TrainState, train_step
    from sgv3d_tpu_torch.train.optim import make_optimizer

    model = BEVHeight(cfg)
    model.load_state_dict(state_dict)
    model.to(device)
    if not dropout:
        for m in model.modules():
            if isinstance(m, ASPP):
                m.dropout_p = 0.0
    names = [n for n, _ in model.named_parameters()]
    state = TrainState(0, model, make_optimizer(cfg, list(model.parameters()),
                                                num_devices, 10))
    grads = {}
    opt_step = state.optimizer.step

    def spy(gs):
        grads.update((n, g.detach().cpu().clone()) for n, g in zip(names, gs))
        return opt_step(gs)

    state.optimizer.step = spy
    t = lambda a: torch.from_numpy(np.array(a)).to(device)   # noqa: E731
    imgs, mats, boxes, labels, sem = batch
    metrics = train_step(state, t(imgs), {k: t(v) for k, v in mats.items()},
                         t(boxes), t(labels), None if sem is None else t(sem))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "after": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "lr": state.optimizer.schedule(0), "step": state.step}


def one_train_step(cfg, state_dict, batch, device) -> tuple[dict, dict]:
    """One float32 `train_step` of `cfg` from `state_dict` on `device`, the
    ASPPs' dropout off. Returns (metrics, {parameter: gradient}) on the CPU."""
    rec = train_step_record(cfg, state_dict, batch, device)
    return rec["metrics"], rec["grads"]


TOPK_NOISE_DRAWS = 3     # CPU steps under 1e-7 image noise a top-k config


@contextlib.contextmanager
def one_bin_off():
    """A planted fault for `phase_train_tiny`: `TopkCells` gets every
    pick's bin one higher (mod D), so its forward is right and its
    backward credits the wrong bin."""
    from sgv3d_tpu_torch.ops import lift_splat

    pick = lift_splat.topk_with_cells

    def shifted(h, cells, k, return_bins=False):
        vals, picked, bins = pick(h, cells, k, return_bins=True)
        return vals, picked, (bins + 1) % h.shape[-1]

    lift_splat.topk_with_cells = shifted
    try:
        yield
    finally:
        lift_splat.topk_with_cells = pick


def phase_train_tiny(dev):
    """The tiny BEVHeight and SGV3D, one float32 train step on the card (K2
    and K2b under `LiftSplat`) against the CPU (the plain versions), the
    same seeded weights and batch of four unlike frames, TF32 off: every
    loss term and grad_norm within 1e-4 relative, each leaf's gradient
    within 1e-3 of its own max |g|, the conv biases ahead of a BatchNorm
    (zero in exact arithmetic) within 1e-4 of the largest leaf gradient.
    It is the same code in another summation order (cuDNN's convolutions,
    not oneDNN's), and a train-mode step at these sizes amplifies rounding
    (tests/test_torch_train_step.py: JAX's jitted step and its op-by-op
    gradients differ by up to 10% of a leaf's scale for SGV3D); card vs
    CPU measured 2.0e-5 (BEVHeight) and 5.5e-4 (SGV3D, a head task's
    BatchNorm bias) of a leaf's own scale on an H100 80GB HBM3 at 700 W.
    Each config runs with the all-bin lift and with `train_lift_top_k=4`
    (K1 with its bins, then K2 and K2b in the top-k layout). SGV3D's
    top-k step has a ReLU input within rounding of zero in a head task
    branch: on the CPU alone, images scaled by 1 + 1e-7 N(0, 1) flip that
    one ReLU and move the task-0 heatmap BatchNorm bias by 5.2e-2 of its
    scale, and the card flips it too (5.2e-2 card vs CPU). A kink is a
    property of the seeded problem, not of the code, and any seed has
    some near zero. So with the top-k lift each leaf is held within 1e-3
    of its own max |g| plus three times the CPU's largest change of that
    leaf over TOPK_NOISE_DRAWS such draws (the step test's rule against
    JAX's own spread), and a leaf whose gradient cancels to rounding on
    both sides (under 1e-6 of the largest leaf: the task-1 height bias, an
    L1 term whose residual signs balance, 3.7e-9 on the CPU) against the
    largest leaf, as the biases ahead of a BatchNorm are. The top-k
    backward feeds only the leaves ahead of the lift (image backbone,
    necks, height net), which the kink moves far less; a planted fault
    proves the widened gate still sees a wrong backward: the card step
    rerun with every pick's gradient sent one bin off must fail it."""
    from sgv3d_tpu_torch.models.bev_height import BEVHeight
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells
    from sgv3d_tpu_torch.weights import seeded_state_dict

    # float32 on the card means no TF32 (cuDNN's convs default to it)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for is_bsm, top_k in ((False, None), (True, None), (False, 4), (True, 4)):
        cfg = tiny_exp(is_bsm)
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, train_lift_top_k=top_k))
        name = cfg.name + ("" if top_k is None else f" train_lift_top_k={top_k}")
        batch = _train_batch(cfg, 4, seed=3)
        state = seeded_state_dict(cfg, seed=5)
        lift_splat_backward.launches = 0
        topk_with_cells.launches = 0
        got, g_card = one_train_step(cfg, state, batch, dev)
        launches = lift_splat_backward.launches
        k1_launches = topk_with_cells.launches
        ref, g_cpu = one_train_step(cfg, state, batch, torch.device("cpu"))
        spread = {k: 0.0 for k in g_cpu}
        for draw in range(TOPK_NOISE_DRAWS if top_k is not None else 0):
            # the CPU's own change under 1e-7 noise, the largest of the draws
            noise_rng = np.random.default_rng(draw)
            imgs = batch[0] * (1 + 1e-7 * noise_rng.standard_normal(
                batch[0].shape)).astype(np.float32)
            _, g_near = one_train_step(cfg, state, (imgs,) + tuple(batch[1:]),
                                       torch.device("cpu"))
            for k, v in g_cpu.items():
                spread[k] = max(spread[k], float((g_near[k] - v).abs().max()))
        worst = {}
        for key, r in ref.items():
            rtol = 1e-4
            rel = abs(got[key] - r) / max(abs(r), 1e-12)
            worst[key] = rel
            if not (np.isfinite(got[key]) and rel <= rtol):
                raise AssertionError(f"{name} train step {key}: card {got[key]} "
                                     f"vs CPU {r} (bound {rtol} relative)")
        # each leaf against its own scale, but a conv bias ahead of a
        # BatchNorm (zero in exact arithmetic), and a leaf whose gradient
        # cancels to rounding on both sides (an L1 term's bias where the
        # residuals' signs balance: under 1e-6 of the largest leaf), against
        # the largest leaf
        top = max(float(v.abs().max()) for v in g_cpu.values())
        zero = biases_ahead_of_batchnorm(BEVHeight(cfg))
        cancelled = {k for k, v in g_cpu.items() if top_k is not None
                     and k not in zero and max(float(v.abs().max()),
                                               float(g_card[k].abs().max())) <= 1e-6 * top}
        # each leaf's error over its bound, the bound being 1e-3 of the
        # leaf's own max |g| (plus 3x the CPU's own spread, top-k only)
        def leaf_errors(grads):
            return sorted(((float((grads[k] - v).abs().max())
                            / max(float(v.abs().max()) + 3e3 * spread[k], 1e-30), k)
                           for k, v in g_cpu.items() if k not in zero | cancelled),
                          reverse=True)

        rel = leaf_errors(g_card)
        noise = max(float(g[k].abs().max()) for g in (g_card, g_cpu)
                    for k in zero | cancelled) / top
        print(f"[train] {name} card vs CPU, worst leaves (of their own max "
              f"|g|{'' if top_k is None else ' + 3e3 x the CPU spread'}): "
              + ", ".join(f"{k} {r:.2e}" for r, k in rel[:3])
              + f"; {len(zero)} biases ahead of a BatchNorm and "
              f"{len(cancelled)} leaves cancelled to rounding "
              f"({', '.join(sorted(cancelled)) or 'none'}) up to {noise:.2e} "
              f"of the largest leaf")
        leaf, worst_leaf = rel[0]
        k1_need = 0 if top_k is None else 1
        if not (leaf <= 1e-3 and noise <= 1e-4 and launches == 1
                and k1_launches == k1_need):
            raise AssertionError(f"{name} train step: leaf gradients card vs "
                                 f"CPU up to {leaf:.3e} of the leaf's max |g| "
                                 f"({worst_leaf}; bound 1e-3), biases ahead of a "
                                 f"BatchNorm {noise:.3e} of the largest leaf "
                                 f"(bound 1e-4); K2b launches {launches} (need "
                                 f"1), K1 {k1_launches} (need {k1_need})")
        print(f"[train] {name} one fp32 train step, card vs CPU: total_loss "
              f"{got['total_loss']:.5f} vs {ref['total_loss']:.5f} "
              f"({worst['total_loss']:.2e} rel), grad_norm "
              f"{worst['grad_norm']:.2e} rel, worst metric "
              f"{max(worst.values()):.2e} rel, leaf gradients within "
              f"{leaf:.3e} of their own max |g| (worst {worst_leaf}); K2b "
              f"launched once, K1 {k1_launches} times")
        if top_k is None:
            continue
        spreads = sorted(((spread[k] / max(float(v.abs().max()), 1e-30), k)
                          for k, v in g_cpu.items() if k not in zero | cancelled),
                         reverse=True)
        ahead = max(r for r, k in spreads if k.startswith("backbone."))
        with one_bin_off():
            _, g_bad = one_train_step(cfg, state, batch, dev)
        bad, bad_leaf = leaf_errors(g_bad)[0]
        print(f"[train] {name}: the CPU's largest change over "
              f"{TOPK_NOISE_DRAWS} draws of 1e-7 noise {spreads[0][0]:.2e} of "
              f"a leaf's scale ({spreads[0][1]}), {ahead:.2e} ahead of the "
              f"lift; planted fault (picks' gradient one bin off) "
              f"{bad:.3e} over the bound's 1e-3 ({bad_leaf})")
        if not bad > 1e-3:
            raise AssertionError(f"{name}: the train-step gate passed a top-k "
                                 f"backward one bin off ({bad:.3e} <= 1e-3)")


def profile_train_step(state, batch, steps: int = 3) -> dict:
    """The card's time for `train_step` on one batch held on the card (no
    loader), TF32 off as `runner.train` runs it: the mean over `steps`
    steps by CUDA events after a warm-up step, and `torch.profiler`'s
    device time over two more steps: its kernels' sum (the busy share is
    that over the steps' event time; one stream, so kernels do not overlap)
    and the operators that launched the most of it (each aten op's own
    kernels, forward and backward)."""
    from sgv3d_tpu_torch.train.loop import no_tf32, train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with no_tf32():
        train_step(state, *batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            train_step(state, *batch)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / steps
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                train_step(state, *batch)
            torch.cuda.synchronize()
    kernels, ops = {}, {}
    for evt in prof.key_averages():
        ms = evt.self_device_time_total / 2e3          # us over 2 steps
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
        elif ms > 0:
            ops[evt.key] = ops.get(evt.key, 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    # the lift's own kernels: K2b's one, and K2's prep and pool
    k2 = ("tile_hist_kernel", "scan_kernel", "place_kernel", "pool_kernel",
          "finish_kernel")
    lift = {"lift_splat_bwd": sum(ms for k, ms in kernels.items()
                                  if "lift_splat_bwd_kernel" in k),
            "lift_splat": sum(ms for k, ms in kernels.items()
                              if any(name in k for name in k2))}
    return {"step_ms": step_ms, "kernel_ms_per_step": busy,
            "busy_share": busy / step_ms, "kernels": len(kernels),
            "top_ops": [[name[:60], ms] for name, ms in top], "lift_ms": lift}


def profile_batchnorm(state, batch) -> dict:
    """BatchNorm's share of a train step: the input of every train-mode
    `BatchNorm` call in one step is recorded (shape, dtype, memory format),
    then each call's forward and backward runs once more on random tensors
    of that layout and `torch.profiler` sums the device time of their
    kernels (device time, as `profile_train_step`'s kernel sum: timed
    alone, a small call's events would time the host's enqueue); beside it
    the same calls through cuDNN's `batch_norm` (one fused forward and
    backward; it puts the unbiased variance into the running one, so it is
    not the port's function and is timed here only as the fused floor)."""
    from sgv3d_tpu_torch.nn.blocks import BatchNorm
    from sgv3d_tpu_torch.train.loop import no_tf32, train_step

    calls = []

    def record(module, args):
        x = args[0]
        cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        calls.append((tuple(x.shape), x.dtype, cl))

    hooks = [m.register_forward_pre_hook(record)
             for m in state.model.modules() if isinstance(m, BatchNorm)]
    try:
        with no_tf32():
            train_step(state, *batch)
    finally:
        for h in hooks:
            h.remove()
    dev = next(state.model.parameters()).device
    cases = []
    for shape, dtype, cl in calls:
        fmt = torch.channels_last if cl else torch.contiguous_format
        x = torch.randn(shape, device=dev).to(dtype).contiguous(memory_format=fmt)
        bn = BatchNorm(shape[1]).to(dev).train()
        cases.append((x.requires_grad_(), torch.randn_like(x), bn))

    def cudnn(bn, x):
        return torch.nn.functional.batch_norm(
            x, bn.running_mean.clone(), bn.running_var.clone(), bn.weight,
            bn.bias, True, 0.1, bn.eps)

    def device_ms(fn) -> float:
        for x, g, bn in cases:          # warm-up
            fn(bn, x).backward(g)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for x, g, bn in cases:
                fn(bn, x).backward(g)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    port_ms = device_ms(lambda bn, x: bn(x))
    cudnn_ms = device_ms(cudnn)
    del cases
    return {"calls": len(calls), "port_ms": port_ms, "cudnn_ms": cudnn_ms}


TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
TRAIN_FRAMES = 24       # 12 steps an epoch at batch 2
TRAIN_STEPS = 10        # then a resume for 2 more


def phase_train_full(dev, smi) -> dict:
    """`sgv3d_r50_128` at full width: batch 2, 864x1536, bf16 image side,
    `runner.train` on a fake root of 1080x1920 frames with masks for
    TRAIN_STEPS steps (K2 and K2b launches counted from 0 over the run and
    per step), a checkpoint, its restore into a fresh state (bitwise), and
    a resume for 2 more steps through the CLI (`tools/train.py`)."""
    from sgv3d_tpu_torch import runner
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import write_fake_kitti_root
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward, lift_splat_forward
    from sgv3d_tpu_torch.tools import train as train_cli
    from sgv3d_tpu_torch.train.checkpoint import CheckpointManager
    from sgv3d_tpu_torch.train.loop import create_train_state

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = get_exp("sgv3d_r50_128")
    t0 = time.perf_counter()
    root = write_fake_kitti_root(TRAIN_DIR / "rope3d-kitti", TRAIN_FRAMES,
                                 src_hw=cfg.src_hw, seed=0)
    print(f"[train] {cfg.name}: fake root of {TRAIN_FRAMES} frames at "
          f"{cfg.src_hw[0]}x{cfg.src_hw[1]} with masks in "
          f"{time.perf_counter() - t0:.2f} s")
    out_dir = str(TRAIN_DIR / "out")
    per_step = []
    step_fn = runner.train_step

    def counted(state, *args):
        before = (lift_splat_forward.launches, lift_splat_backward.launches)
        metrics = step_fn(state, *args)
        per_step.append((lift_splat_forward.launches - before[0],
                         lift_splat_backward.launches - before[1]))
        return metrics

    stats = {}
    runner.train_step = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        lift_splat_forward.launches = 0
        lift_splat_backward.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = runner.train(cfg, data_root=root, output_dir=out_dir,
                                 max_steps=TRAIN_STEPS, device=dev, backup=False,
                                 stats=stats)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"lift_splat": lift_splat_forward.launches,
                    "lift_splat_bwd": lift_splat_backward.launches}
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        runner.train_step = step_fn
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["total_loss"] for r in records]
    ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    if not (len(records) == TRAIN_STEPS == state.step == len(per_step)
            and all(np.isfinite(v) for r in records for v in r.values())
            and ckpt.all_steps() == [TRAIN_STEPS]
            and len(set(per_step)) == 1 and all(per_step[0])
            and launches["lift_splat_bwd"] == TRAIN_STEPS * per_step[0][1]):
        raise AssertionError(f"train run: {len(records)} records, step {state.step}, "
                             f"losses {losses}, checkpoints {ckpt.all_steps()}, "
                             f"launches a step {per_step}")
    fresh = create_train_state(cfg, seed=1, device=dev)
    ckpt.restore(fresh)
    saved = state.model.state_dict()
    same = (fresh.step == state.step and fresh.optimizer.count == state.optimizer.count
            and all(torch.equal(v, saved[k]) for k, v in fresh.model.state_dict().items())
            and all(torch.equal(a, b) for a, b in zip(
                fresh.optimizer.mu + fresh.optimizer.nu,
                state.optimizer.mu + state.optimizer.nu)))
    if not same:
        raise AssertionError("the restored state differs from the saved one")
    del state
    # the card's own step time on one batch, without the loader
    from sgv3d_tpu_torch.data.dataset import DataLoader, RoadSideDataset
    info, _ = runner.default_info_paths(cfg, root)
    dataset = RoadSideDataset(cfg.ida_aug_conf, cfg.classes, root, info,
                              is_train=True, return_semantic=True,
                              max_objs=cfg.head.max_objs, device_normalize=True)
    batch = next(iter(DataLoader(dataset, cfg.batch_size_per_device,
                                 prefetch=False, to_device=dev)))[:5]
    alone = profile_train_step(fresh, batch)
    print(f"[train] the card alone (one batch held on the card, no loader): "
          f"{alone['step_ms']:.2f} ms a step (CUDA events, 3 steps); "
          f"torch.profiler: {alone['kernel_ms_per_step']:.2f} ms of kernels a "
          f"step in {alone['kernels']} kernel names, busy share "
          f"{alone['busy_share']:.3f} ({smi})")
    for name, ms in alone["top_ops"]:
        print(f"[train]   {ms:8.3f} ms a step in the kernels of {name}")
    print(f"[train]   the lift's kernels: K2 {alone['lift_ms']['lift_splat']:.4f} "
          f"ms, K2b {alone['lift_ms']['lift_splat_bwd']:.4f} ms a step")
    bn = profile_batchnorm(fresh, batch)
    alone["batchnorm"] = bn
    print(f"[train] BatchNorm: {bn['calls']} train-mode calls a step, forward + "
          f"backward {bn['port_ms']:.2f} ms of kernels a step (the port's flax "
          f"statistics; torch.profiler) against cuDNN's fused batch_norm "
          f"{bn['cudnn_ms']:.2f} ms on the same layouts; the step's kernels "
          f"{alone['kernel_ms_per_step']:.2f} ms ({smi})")
    del fresh
    topk = train_topk_run(cfg, root, dev, batch, alone, smi)
    del batch
    with contextlib.redirect_stdout(io.StringIO()) as log:
        resumed = train_cli.main([cfg.name, "--data_root", root, "--output_dir",
                                  out_dir, "--max_steps", str(TRAIN_STEPS + 2),
                                  "--no_backup", "--device", str(dev)])
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    if not (resumed.step == TRAIN_STEPS + 2
            and f"resumed from step {TRAIN_STEPS}" in log.getvalue()
            and steps == list(range(1, TRAIN_STEPS + 3))
            and ckpt.all_steps() == [TRAIN_STEPS, TRAIN_STEPS + 2]):
        raise AssertionError(f"resume: step {resumed.step}, logged steps {steps}, "
                             f"checkpoints {ckpt.all_steps()}")
    del resumed
    step_s = stats["step_s"]
    steady = step_s[2:]
    waits = stats["loader_wait_s"][2:len(step_s)]
    row = {"exp": cfg.name, "batch": cfg.batch_size_per_device, "use_bf16": True,
           "steps": TRAIN_STEPS, "first_step_s": step_s[0],
           "s_per_step_median": float(np.median(steady)),
           "s_per_step_min": min(steady), "s_per_step_max": max(steady),
           "loader_wait_share": sum(waits) / sum(steady),
           "step_dispatch_s_median": float(np.median(stats["step_dispatch_s"][2:])),
           "train_s": train_s, "peak_mem_gib": peak / 2 ** 30,
           "launches": launches, "launches_per_step": dict(zip(launches, per_step[0])),
           "total_loss_first": losses[0], "total_loss_last": losses[-1],
           "card_alone": alone, "train_lift_top_k": topk}
    print(f"[train] {cfg.name} batch 2 bf16: {TRAIN_STEPS} steps, losses finite "
          f"({losses[0]:.4f} -> {losses[-1]:.4f}); K2 / K2b launches {launches} "
          f"({per_step[0][0]} / {per_step[0][1]} every step); checkpoint of step "
          f"{TRAIN_STEPS} restored bitwise; resumed to step {TRAIN_STEPS + 2} "
          f"through the CLI")
    print(f"[train] steady (steps 3-{TRAIN_STEPS}) median {row['s_per_step_median']:.4f} "
          f"s a step (min {row['s_per_step_min']:.4f}, max {row['s_per_step_max']:.4f}), "
          f"first step {step_s[0]:.3f} s; loader wait share {row['loader_wait_share']:.4f}; "
          f"host enqueue {row['step_dispatch_s_median']:.4f} s a step; peak "
          f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.3f} GiB ({smi})")
    shutil.rmtree(TRAIN_DIR)
    return row


SAM_TINY = dict(img_size=96, patch_size=16, embed_dim=32, depth=3, num_heads=2,
                out_chans=16, window_size=4, global_attn_indexes=(1,))


def sam_tiny_card_vs_cpu(dev) -> float:
    """The tiny SAM encoder (seeded) on the card against the CPU: the output's
    max|diff| over its max|value|; raises above 1e-4 or on a wrong shape."""
    from sgv3d_tpu_torch.nn.sam_encoder import ImageEncoderViT
    from sgv3d_tpu_torch.weights import random_init

    tiny = ImageEncoderViT(**SAM_TINY).eval()
    random_init(tiny, seed=0)
    x = torch.randn(2, 96, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ref = tiny(x)
        got = tiny.to(dev)(x.to(dev)).cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    if not (got.shape == (2, 6, 6, 16) and err <= 1e-4):
        raise AssertionError(f"SAM tiny encoder card vs CPU: shape "
                             f"{tuple(got.shape)}, {err:.3e} of scale (bound 1e-4)")
    return err


def phase_sam(dev, smi) -> dict:
    """The SAM ViT-B image encoder (`nn.sam_encoder`): a tiny encoder (embed
    32, depth 3 with one global block, 4x4 windows over a 6x6 grid, so
    padded) on the card against the CPU within 1e-4 of the output's scale;
    then `build_sam_vit_b()` at 1024x1024, batch 1, float32 with TF32 off,
    seeded weights: output (1, 64, 64, 256) and finite, the median of 10
    calls (CUDA events each, after a warm-up), peak memory."""
    from sgv3d_tpu_torch.nn.sam_encoder import build_sam_vit_b, preprocess
    from sgv3d_tpu_torch.weights import random_init

    err = sam_tiny_card_vs_cpu(dev)
    print(f"[sam] tiny encoder (embed 32, depth 3, one global block, padded "
          f"windows) card vs CPU: {err:.3e} of scale (bound 1e-4)")

    enc = build_sam_vit_b()
    random_init(enc, seed=0)
    enc = enc.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    pixels = torch.rand(1, 1024, 1024, 3, generator=g, device=dev) * 255
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        img = preprocess(pixels)
        out = enc(img)
        torch.cuda.synchronize()
        if out.shape != (1, 64, 64, 256) or not torch.isfinite(out).all():
            raise AssertionError(f"SAM ViT-B output {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        times = [_cuda_ms(lambda: enc(img), iters=1) for _ in range(10)]
    peak = torch.cuda.max_memory_allocated(dev)
    params = sum(p.numel() for p in enc.parameters())
    print(f"[sam] ViT-B ({params} parameters) at 1024x1024, batch 1, float32, "
          f"TF32 off: output {tuple(out.shape)} finite; median of 10 calls "
          f"{np.median(times):.2f} ms (min {min(times):.2f}, max "
          f"{max(times):.2f}); peak torch.cuda.max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB ({smi})")
    del enc, out
    return {"tiny_card_vs_cpu": err, "ms_median": float(np.median(times)),
            "ms_min": min(times), "ms_max": max(times),
            "peak_mem_gib": peak / 2 ** 30, "parameters": params}


TOPK_TRAIN_STEPS = 4    # 2 warm-up, 2 steady


def train_topk_run(cfg, root: str, dev, batch, all_bin: dict, smi) -> dict:
    """`cfg` with `train_lift_top_k=16` through `runner.train` for
    TOPK_TRAIN_STEPS steps on the same root: K1 (with its bins), K2 and
    K2b launches counted a step (K1 and K2b once, K2 alike every step),
    finite losses, the steady seconds a step, peak memory, and the card's
    step alone on `batch` beside the all-bin step's (`all_bin`)."""
    from sgv3d_tpu_torch import runner
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward, lift_splat_forward
    from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells

    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, train_lift_top_k=16))
    counters = (topk_with_cells, lift_splat_forward, lift_splat_backward)
    per_step = []
    step_fn = runner.train_step

    def counted(state, *args):
        before = [f.launches for f in counters]
        metrics = step_fn(state, *args)
        per_step.append(tuple(f.launches - b for f, b in zip(counters, before)))
        return metrics

    out_dir = str(TRAIN_DIR / "out_topk")
    stats = {}
    runner.train_step = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for f in counters:
            f.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            state = runner.train(cfg, data_root=root, output_dir=out_dir,
                                 max_steps=TOPK_TRAIN_STEPS, device=dev,
                                 backup=False, stats=stats)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        runner.train_step = step_fn
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    launches = dict(zip(("topk_cells", "lift_splat", "lift_splat_bwd"),
                        (f.launches for f in counters)))
    if not (len(losses) == TOPK_TRAIN_STEPS == len(per_step)
            and all(np.isfinite(losses)) and len(set(per_step)) == 1
            and per_step[0][0] == 1 and per_step[0][2] == 1 and per_step[0][1]):
        raise AssertionError(f"top-k train run: losses {losses}, launches a "
                             f"step (K1, K2, K2b) {per_step} (need 1, the same "
                             f"each step, 1)")
    alone = profile_train_step(state, batch)
    del state
    steady = stats["step_s"][2:]
    print(f"[train] {cfg.name} train_lift_top_k=16: {TOPK_TRAIN_STEPS} steps, "
          f"losses finite ({losses[0]:.4f} -> {losses[-1]:.4f}); K1 / K2 / K2b "
          f"launches {per_step[0][0]} / {per_step[0][1]} / {per_step[0][2]} "
          f"every step; steady median {np.median(steady):.4f} s a step; peak "
          f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.3f} GiB; the card "
          f"alone {alone['step_ms']:.2f} ms a step, {alone['kernel_ms_per_step']:.2f} "
          f"ms of kernels (busy share {alone['busy_share']:.3f}), against the "
          f"all-bin step's {all_bin['step_ms']:.2f} ms, "
          f"{all_bin['kernel_ms_per_step']:.2f} ms of kernels ({smi})")
    return {"top_k": 16, "steps": TOPK_TRAIN_STEPS, "launches": launches,
            "launches_per_step": dict(zip(launches, per_step[0])),
            "s_per_step_median": float(np.median(steady)),
            "total_loss_first": losses[0], "total_loss_last": losses[-1],
            "peak_mem_gib": peak / 2 ** 30, "card_alone_step_ms": alone["step_ms"],
            "card_alone_kernel_ms": alone["kernel_ms_per_step"],
            "card_alone_busy_share": alone["busy_share"],
            "all_bin_card_alone_step_ms": all_bin["step_ms"],
            "all_bin_card_alone_kernel_ms": all_bin["kernel_ms_per_step"]}


# ---------------------------------------------------------------------------
# phase 9: distribution


DIST_WORLD = 2
DIST_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dist"
# the faults each 2-rank tiny step is run with once, each of which the
# gates must catch: per-rank BatchNorm statistics (the collective skipped),
# per-rank loss normalisers, gradients summed over ranks and not averaged
DIST_FAULTS = ("per_rank_batchnorm", "per_rank_normalisers", "summed_grads")
# the 2-rank tiny steps: (name, is_bsm, dropout, fault, remat_backbone)
DIST_CASES = tuple((("sgv3d" if bsm else "bevheight") + ("" if f is None else "." + f),
                    bsm, True, f, False)
                   for bsm in (False, True) for f in (None,) + DIST_FAULTS)


def dist_tiny_cfg(is_bsm: bool, remat: bool = False):
    cfg = tiny_exp(is_bsm)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, remat_backbone=remat))


def dist_tiny_batch(cfg, rank: int | None = None, world: int = DIST_WORLD):
    """The global batch of the 2-rank tiny steps, or `rank`'s rows of it
    (contiguous: [rank 0's, rank 1's], as the JAX mesh shards a batch):
    `_train_batch`'s four unlike frames, frame 0 left with three of its five
    boxes so that the ranks' counts of heatmap positives differ (equal
    counts would hide per-rank normalisers)."""
    imgs, mats, boxes, labels, sem = _train_batch(cfg, 4, seed=3)
    boxes[0, 3:5] = 0.0
    labels[0, 3:5] = -1
    batch = (imgs, mats, boxes, labels, sem)
    if rank is None:
        return batch
    n = imgs.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    return (imgs[rows], {k: v[rows] for k, v in mats.items()}, boxes[rows],
            labels[rows], None if sem is None else sem[rows])


@contextlib.contextmanager
def planted_dist_fault(fault: str | None):
    """One of DIST_FAULTS planted for the block (None: none)."""
    from sgv3d_tpu_torch import dist
    from sgv3d_tpu_torch.heads import losses
    from sgv3d_tpu_torch.nn.blocks import BatchNorm
    from sgv3d_tpu_torch.train import sharding

    def summed(grads):
        return [dist.all_reduce_sum(g.float()) for g in grads]

    target, name, fake = {
        None: (None, None, None),
        "per_rank_batchnorm": (BatchNorm, "_global_stats", staticmethod(
            lambda xf, dims, world: BatchNorm._local_stats(xf, dims))),
        "per_rank_normalisers": (losses, "divisors", losses.local_divisors),
        "summed_grads": (sharding, "average_grads", summed)}[fault]
    if target is None:
        yield
        return
    saved = target.__dict__[name]
    setattr(target, name, fake)
    try:
        yield
    finally:
        setattr(target, name, saved)


# Other orders of one process's BatchNorm sums over the rows than its mean's:
# the rows cut into groups, each group summed apart and the groups' sums
# added in turn. "ranks" is the 2 ranks' grouping; the others measure how far
# a change of summation order moves the step (`dist_stepped`).
BATCHNORM_ORDERS = {
    "ranks": lambda n: [slice(0, n // 2), slice(n // 2, None)],
    "rows": lambda n: [slice(i, i + 1) for i in range(n)],
    "rows_reversed": lambda n: [slice(i, i + 1) for i in reversed(range(n))],
    "interleaved_halves": lambda n: [slice(0, None, 2), slice(1, None, 2)],
}


@contextlib.contextmanager
def batchnorm_sum_order(order: str):
    """Within the block, one process's train-mode BatchNorms take [sum x,
    sum x^2] in the order BATCHNORM_ORDERS[order] gives, then flax's
    formula over the whole count."""
    from sgv3d_tpu_torch.nn.blocks import BatchNorm

    saved = BatchNorm.__dict__["_local_stats"]

    def grouped(xf, dims):
        count = xf.numel() // xf.shape[1]
        sums = None
        for rows in BATCHNORM_ORDERS[order](xf.shape[0]):
            part = torch.stack([xf[rows].sum(dims), (xf[rows] * xf[rows]).sum(dims)])
            sums = part if sums is None else sums + part
        mean = sums[0] / count
        return mean, torch.clamp(sums[1] / count - mean * mean, min=0.0)

    BatchNorm._local_stats = staticmethod(grouped)
    try:
        yield
    finally:
        BatchNorm._local_stats = saved


def _rank_start(device: str) -> None:
    """A spawned rank's settings: one CPU thread (the ranks share the
    machine's cores), float32 without TF32 on the card."""
    if device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dist_tiny_steps(rank: int, world: int, device, out_dir, cases) -> None:
    """This rank's step of each case on its rows of `dist_tiny_batch`, from
    `seeded_state_dict(seed=5)`, the LR of `world` devices; each record
    saved as `<out_dir>/<name>.<rank>.pt`."""
    from sgv3d_tpu_torch.weights import seeded_state_dict

    for name, is_bsm, dropout, fault, remat in cases:
        cfg = dist_tiny_cfg(is_bsm, remat)
        with planted_dist_fault(fault):
            rec = train_step_record(cfg, seeded_state_dict(cfg, seed=5),
                                    dist_tiny_batch(cfg, rank, world), device,
                                    dropout=dropout, num_devices=world)
        torch.save(rec, Path(out_dir) / f"{name}.{rank}.pt")


def dist_batchnorm_record(device, rank: int | None = None,
                          world: int = DIST_WORLD) -> dict:
    """A train-mode `BatchNorm(6)` (seeded scale and bias) on a seeded
    (4, 6, 5, 3) input with per-channel offsets, or `rank`'s rows of it:
    the output and the input's gradient of sum(y * w) (w seeded), and the
    running statistics after, on the CPU; 'x', 'w', 'scale', 'bias' the
    whole inputs."""
    from sgv3d_tpu_torch.nn.blocks import BatchNorm

    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4, 6, 5, 3)) * rng.uniform(0.5, 2, (1, 6, 1, 1))
         + rng.normal(size=(1, 6, 1, 1)) * 3).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    rows = slice(None) if rank is None else slice(rank * 2, rank * 2 + 2)
    bn = BatchNorm(6).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x[rows]).to(device).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(w[rows]).to(device)).sum().backward()
    return {"y": y.detach().cpu(), "dx": xt.grad.cpu(),
            "running_mean": bn.running_mean.cpu(), "running_var": bn.running_var.cpu(),
            "x": x, "w": w, "scale": scale, "bias": bias}


def dist_tiny_worker(rank: int, world: int, init_url: str, device: str,
                     out_dir: str, cases) -> None:
    """A spawned rank of the 2-rank tiny checks: joins the gloo group at
    `init_url`, runs `dist_tiny_steps`, then saves its
    `dist_batchnorm_record` as `<out_dir>/batchnorm.<rank>.pt`."""
    from sgv3d_tpu_torch import dist

    _rank_start(device)
    dist.init_distributed(init_url, world, rank, backend="gloo")
    try:
        dist_tiny_steps(rank, world, device, out_dir, cases)
        torch.save(dist_batchnorm_record(device, rank, world),
                   Path(out_dir) / f"batchnorm.{rank}.pt")
    finally:
        dist.destroy()


def spawn_ranks(target, args: tuple, world: int = DIST_WORLD,
                timeout: float = 600.0) -> None:
    """`target(rank, world, *args)` in `world` spawned processes (never
    forked: CUDA and threads do not survive a fork); waits for all of them.
    Raises if one exits with an error or the time runs out, after stopping
    every one still running (a rank left alone would wait in a collective)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world) + tuple(args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        running = list(procs)
        while running and time.monotonic() < deadline:
            multiprocessing.connection.wait([p.sentinel for p in running],
                                            deadline - time.monotonic())
            running = [p for p in running if p.exitcode is None]
            if any(p.exitcode for p in procs):
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{getattr(target, '__name__', target)}: ranks exited "
                           f"with {codes} (a negative code is a signal; the "
                           f"time limit was {timeout:.0f} s)")


def dist_references(cfg, state_dict, device, dropout: bool = True) -> dict:
    """One process's step of `cfg` on the whole of `dist_tiny_batch`, the LR
    of DIST_WORLD devices, as `train_step_record`s: "plain" the step as it
    is, and one a BATCHNORM_ORDERS order of its BatchNorm sums."""
    batch = dist_tiny_batch(cfg)
    refs = {"plain": train_step_record(cfg, state_dict, batch, device, dropout,
                                       DIST_WORLD)}
    for order in BATCHNORM_ORDERS:
        with batchnorm_sum_order(order):
            refs[order] = train_step_record(cfg, state_dict, batch, device,
                                            dropout, DIST_WORLD)
    return refs


def dist_stepped(refs: dict, got: dict, cfg, state_dict) -> dict:
    """The gates' `stepped` dict for a 2-rank step (`got`, rank 0's record:
    the rank mean of the losses, the averaged gradients) against one
    process's step on the concatenated batch (`dist_references`' "plain",
    where the gates have JAX's steps). The reference's spread, which the
    gates get from JAX's jitted and op-by-op gradients, is the largest
    change of each leaf's gradient over the other orders of its BatchNorm
    sums (BATCHNORM_ORDERS but the ranks' own). A train-mode step at the
    tiny sizes is ill-conditioned (tests/test_torch_train_step.py): in
    HeightNet's `mlp_bn` a camera feature near 2000 that is the same in
    all four frames has E[x^2] - E[x]^2 cancel to 0 or to one ulp of 4e6
    (0.5) by the order of the sums, and the leaves it feeds move by tens of
    percent of their scale with it."""
    from sgv3d_tpu_torch.models.bev_height import BEVHeight

    ref = refs["plain"]
    spread = {name: max(float((refs[o]["grads"][name] - g).abs().max())
                        for o in BATCHNORM_ORDERS if o != "ranks")
              for name, g in ref["grads"].items()}
    return {"jax_metrics": ref["metrics"], "metrics": got["metrics"],
            "jax_grads": ref["grads"], "jax_eager_grads": ref["grads"],
            "spread": spread,
            "zero_leaves": biases_ahead_of_batchnorm(BEVHeight(cfg)),
            "grads": got["grads"], "jax_after": ref["after"], "after": got["after"],
            "params_before": state_dict, "lr": got["lr"], "jax_step": ref["step"],
            "step": got["step"], "is_bsm": cfg.backbone.is_bsm}


def ranks_grouping_error(refs: dict, got: dict, zero: set) -> float:
    """How far a 2-rank step (`got`) is from one process whose BatchNorms
    sum the rows in the ranks' grouping (`refs["ranks"]`), the same
    arithmetic but for the all-reduce: the largest of each metric's
    relative error and each leaf's gradient error over its own max |g|
    (the `zero` leaves, rounding on both sides, over the largest leaf)."""
    ref = refs["ranks"]
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    errs = [abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
            for k, v in ref["metrics"].items()]
    errs += [float((got["grads"][k] - g).abs().max())
             / max(top if k in zero else float(g.abs().max()), 1e-30)
             for k, g in ref["grads"].items()]
    return max(errs)


def gate_excess(stepped) -> tuple[float, str]:
    """How far `stepped` is from the step gates' edge: the largest of each
    metric's relative error over its tolerance and each leaf's gradient
    error over its bound (`leaf_bounds`; the biases ahead of a BatchNorm
    against 1e-4 of the largest leaf), and where it is. Above 1 a gate
    fails."""
    ref, got = stepped["jax_metrics"], stepped["metrics"]
    worst = []
    for key in ref:
        worst.append((abs(got[key] - ref[key]) / max(abs(ref[key]), 1e-30)
                      / metric_rtol(key), key))
    top = max(float(g.abs().max()) for g in stepped["jax_eager_grads"].values())
    bounds = leaf_bounds(stepped)
    for name, g_ref in stepped["jax_eager_grads"].items():
        err = float((stepped["grads"][name] - g_ref).abs().max())
        bound = 1e-4 * top if name in stepped["zero_leaves"] else bounds[name]
        worst.append((err / max(bound, 1e-30), name))
    return max(worst)


# the least share of a 2-rank step's elements `check_after_the_step` holds to
# its tight bound: the order spread (`dist_stepped`) leaves few firm, 1.7%
# of BEVHeight's and 0.6% of SGV3D's on the CPU
DIST_MIN_FIRM = 0.003


def passes_step_gates(stepped) -> bool:
    """Whether a 2-rank `stepped` passes `check_loss_and_metrics`,
    `check_grads` and `check_after_the_step` (DIST_MIN_FIRM)."""
    try:
        check_loss_and_metrics(stepped)
        check_grads(stepped)
        check_after_the_step(stepped, min_firm=DIST_MIN_FIRM)
    except AssertionError:
        return False
    return True


DIST_TRAIN_STEPS = 3
DIST_EVAL_FRAMES = 16   # 8 a rank: two batches of 4 each
DIST_CARD_GROUPING_TOL = 1e-3   # see phase_dist


def state_digest(model) -> str:
    """sha256 of the bytes of `model`'s parameters and buffers, in order."""
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def nccl_world1_worker(rank: int, world: int, init_url: str, out_dir: str) -> None:
    """A spawned process on the card: the tiny BEVHeight step (dropout on)
    twice without a process group, then NCCL at world size 1: its
    all-reduce through `dist.all_reduce_sum` (forward and backward), object
    gather and barrier, and the same step under the group, through the
    distributed code path (which at world size 1 issues no collective).
    Deterministic algorithms on (cuDNN's and torch's), so that the same
    step is the same bits. Saves `<out_dir>/nccl1.<rank>.pt`."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import warnings

    import torch.distributed as tdist

    from sgv3d_tpu_torch import dist
    from sgv3d_tpu_torch.weights import seeded_state_dict

    _rank_start("cuda")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings("ignore", message=".*deterministic.*")
    cfg = dist_tiny_cfg(False)
    sd = seeded_state_dict(cfg, seed=5)
    batch = dist_tiny_batch(cfg)
    alone = [train_step_record(cfg, sd, batch, "cuda", dropout=True) for _ in range(2)]
    device = dist.init_distributed(init_url, world, rank, backend="nccl")
    try:
        x = torch.arange(1.0, 5.0, device=device).requires_grad_()
        y = dist.all_reduce_sum(x)
        (2 * y).sum().backward()
        gathered = [None]
        tdist.all_gather_object(gathered, {"rank": rank, "device": str(device)})
        tdist.barrier()
        dist.synchronize()
        grouped = train_step_record(cfg, sd, batch, device, dropout=True)

        def same(a, b):
            return (a["metrics"] == b["metrics"]
                    and all(torch.equal(v, b["grads"][k]) for k, v in a["grads"].items())
                    and all(torch.equal(v, b["after"][k]) for k, v in a["after"].items()))

        torch.save({"device": str(device), "backend": tdist.get_backend(),
                    "sum_ok": bool(torch.equal(y.detach(), x.detach())
                                   and torch.equal(x.grad, torch.full_like(x, 2.0))),
                    "gathered": gathered, "repeat_bitwise": same(alone[0], alone[1]),
                    "group_bitwise": same(alone[0], grouped),
                    "total_loss": grouped["metrics"]["total_loss"]},
                   Path(out_dir) / f"nccl1.{rank}.pt")
    finally:
        dist.destroy()


def dist_train_full(root: str, out_dir: Path) -> dict:
    """`sgv3d_r50_128` at its own widths, batch 2 a rank, through
    `runner.train` for DIST_TRAIN_STEPS steps as this rank of the group:
    K2 and K2b launches a step (counted from 0), the seconds of each step
    and of its gradient all-reduce (each between two synchronisations, so
    the step's own overlap is gone), the BatchNorm collectives a step, and
    whether every rank's state is the same bits after each step (digests
    gathered by `all_gather_object`)."""
    from sgv3d_tpu_torch import dist, runner
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.nn.blocks import BatchNorm
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_backward, lift_splat_forward
    from sgv3d_tpu_torch.train import sharding

    cfg = get_exp("sgv3d_r50_128")
    rec = {"per_step": [], "step_s": [], "grad_allreduce_s": [], "bn_calls": [],
           "same_state": []}
    step_fn, average = runner.train_step, sharding.average_grads
    stats_fn = BatchNorm.__dict__["_global_stats"]
    calls = [0]

    def counted_stats(xf, dims, world):
        calls[0] += 1
        return stats_fn.__func__(xf, dims, world)

    def timed_average(grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = average(grads)
        torch.cuda.synchronize()
        rec["grad_allreduce_s"].append(time.perf_counter() - t0)
        return out

    def counted(state, *args):
        before = (lift_splat_forward.launches, lift_splat_backward.launches)
        calls[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(state, *args)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        rec["per_step"].append((lift_splat_forward.launches - before[0],
                                lift_splat_backward.launches - before[1]))
        rec["bn_calls"].append(calls[0])
        rec["same_state"].append(len(set(dist.all_gather_object(
            state_digest(state.model)))) == 1)
        return metrics

    runner.train_step, sharding.average_grads = counted, timed_average
    BatchNorm._global_stats = staticmethod(counted_stats)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lift_splat_forward.launches = 0
        lift_splat_backward.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            state = runner.train(cfg, data_root=root, output_dir=str(out_dir / "train"),
                                 max_steps=DIST_TRAIN_STEPS, device="cuda",
                                 backup=False)
        torch.cuda.synchronize()
        rec["launches"] = {"lift_splat": lift_splat_forward.launches,
                           "lift_splat_bwd": lift_splat_backward.launches}
    finally:
        runner.train_step, sharding.average_grads = step_fn, average
        BatchNorm._global_stats = stats_fn
    rec.update(step=state.step, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               params=sum(p.numel() for p in state.model.parameters()))
    return rec


def dist_eval_full(root: str, ckpt: str, out_dir: Path) -> dict:
    """`bevheight_dair_r101_128`, parity-grade, batch 4 a rank, through
    `runner.evaluate` of `ckpt` as this rank of the group: its result (None
    but on rank 0), K2's launches, the peak memory."""
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward

    cfg = dataclasses.replace(get_exp("bevheight_dair_r101_128"), batch_size_per_device=4,
                              data_root=root, is_train_height=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lift_splat_forward.launches = 0
    t0 = time.perf_counter()
    result = _quiet_evaluate(cfg=cfg, ckpt_path=ckpt, output_dir=str(out_dir / "eval"),
                             device="cuda")
    return {"result": result, "evaluate_s": time.perf_counter() - t0,
            "launches": {"lift_splat": lift_splat_forward.launches},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def dist_card_worker(rank: int, world: int, init_url: str, out_dir: str,
                     train_root: str, eval_root: str, ckpt: str) -> None:
    """A spawned rank of phase_dist (b): two ranks share the card under
    gloo. The 2-rank tiny steps (DIST_CASES), then `dist_train_full`, then
    `dist_eval_full`; saves `<out_dir>/full.<rank>.pt`."""
    from sgv3d_tpu_torch import dist

    _rank_start("cuda")
    dist.init_distributed(init_url, world, rank, backend="gloo")
    try:
        out = Path(out_dir)
        dist_tiny_steps(rank, world, "cuda", out, DIST_CASES)
        rec = {"train": dist_train_full(train_root, out)}
        torch.cuda.empty_cache()
        rec["eval"] = dist_eval_full(eval_root, ckpt, out)
        torch.save(rec, out / f"full.{rank}.pt")
    finally:
        dist.destroy()


def nccl_two_card_worker(rank: int, world: int, init_url: str, out_dir: str) -> None:
    """A spawned rank of phase_dist (c), on a card of its own under NCCL:
    the 2-rank tiny steps without faults."""
    from sgv3d_tpu_torch import dist

    _rank_start("cuda")
    device = dist.init_distributed(init_url, world, rank, backend="nccl")
    try:
        dist_tiny_steps(rank, world, device, out_dir,
                        [c for c in DIST_CASES if c[3] is None])
    finally:
        dist.destroy()


def check_dist_tiny(refs: dict, out_dir: Path, where: str, faults: bool,
                    grouping_tol: float) -> dict:
    """The 2-rank tiny steps saved in `out_dir` against the one-process
    references (`refs`: config -> (cfg, state_dict, dist_references)): each
    passes the step gates, is within `grouping_tol` of the ranks' grouping
    in one process, and leaves both ranks the same bits; with `faults`,
    each planted fault fails the gates. Returns the numbers printed."""
    rows = {}
    for config, (cfg, sd, ref) in refs.items():
        got = [torch.load(out_dir / f"{config}.{r}.pt", weights_only=False)
               for r in range(DIST_WORLD)]
        stepped = dist_stepped(ref, got[0], cfg, sd)
        excess, worst = gate_excess(stepped)
        grouping = ranks_grouping_error(ref, got[0], stepped["zero_leaves"])
        same = all(torch.equal(v, got[1]["after"][k]) for k, v in got[0]["after"].items())
        row = {"gate_excess": excess, "worst": worst, "ranks_grouping_error": grouping,
               "ranks_same_state": same}
        if not (passes_step_gates(stepped) and grouping <= grouping_tol and same):
            raise AssertionError(f"{where} {config}: 2-rank step vs one process: "
                                 f"gates {'pass' if passes_step_gates(stepped) else 'FAIL'} "
                                 f"(worst {excess:.3f} of its bound, {worst}), ranks' "
                                 f"grouping {grouping:.2e} (bound {grouping_tol}), "
                                 f"ranks' states equal {same}")
        for fault in DIST_FAULTS if faults else ():
            bad = dist_stepped(ref, torch.load(out_dir / f"{config}.{fault}.0.pt",
                                               weights_only=False), cfg, sd)
            row[fault] = gate_excess(bad)
            if passes_step_gates(bad):
                raise AssertionError(f"{where} {config}: the gates passed the "
                                     f"planted fault {fault}")
        rows[config] = row
        print(f"[dist] {where} {config}, 2-rank step (dropout on) vs one process on "
              f"the concatenated batch: gates pass, worst {excess:.3f} of its bound "
              f"({worst}); vs one process summing each BatchNorm in the ranks' "
              f"grouping {grouping:.2e} of scale; ranks' states equal bitwise"
              + "".join(f"; {f} fails the gates, {row[f][0]:.0f}x its bound "
                        f"({row[f][1]})" for f in DIST_FAULTS if f in row))
    return rows


def rank_batch_infos(root: str, out_dir: Path, batch: int,
                     world: int = DIST_WORLD) -> str:
    """A copy of `root`'s val infos, written to `out_dir`, in the order
    that gives one process's loader the batches of the `world` ranks'
    round-robin shards (each rank's batch i, rank by rank, then batch
    i + 1); returns its path. On the card a frame's detections depend on
    the other frames of its batch at rounding level (K2 pools a batch's
    points in chunks laid over the whole batch, and seeded r101 weights
    saturate scores into near-ties that such rounding reorders), so the
    one-process evaluation that the ranks' gathered result is held to
    runs their batches."""
    from sgv3d_tpu_torch.runner import default_info_paths

    with open(default_info_paths(None, root)[1], "rb") as f:
        infos = pickle.load(f)
    shards = [list(range(r, len(infos), world)) for r in range(world)]
    order = [i for start in range(0, len(shards[0]), batch)
             for shard in shards for i in shard[start:start + batch]]
    if sorted(order) != list(range(len(infos))):
        raise ValueError(f"{len(infos)} frames do not split into {world} equal shards")
    path = out_dir / "val_infos_rank_batches.pkl"
    with open(path, "wb") as f:
        pickle.dump([infos[i] for i in order], f)
    return str(path)


def phase_dist(dev, smi) -> dict:
    """Distribution: (a) NCCL at world size 1 in a spawned process
    (`nccl_world1_worker`); (b) two ranks sharing the card under gloo
    (NCCL refuses two ranks on one card): the tiny BEVHeight and SGV3D
    2-rank steps with dropout on against this process's step on the
    concatenated batch under the step gates, the planted faults failing
    them; `sgv3d_r50_128` at its own widths, batch 2 a rank, through
    `runner.train` for DIST_TRAIN_STEPS steps on a fake root of
    TRAIN_FRAMES frames (finite losses, K2 / K2b launches a step on each
    rank, the ranks' states the same bits after every step, one rank-0
    checkpoint); `bevheight_dair_r101_128` parity-grade evaluation of one
    seeded checkpoint on DIST_EVAL_FRAMES frames, batch 4 a rank: rank 0's
    KITTI lines equal this process's one-process evaluation within 1e-3,
    rank 1 returns None (this process evaluates the ranks' batches,
    `rank_batch_infos`); (c) NCCL across two cards where there are two.
    Gloo on one shared card is a correctness run, not a measure of NCCL:
    its times are labelled so. On the card the ranks' tiny steps are held
    to one process's ranks' grouping within DIST_CARD_GROUPING_TOL (the
    parent's and the ranks' kernels may order their sums apart: atomics in
    cuDNN's and torch's backward kernels), the CPU test to 1e-5."""
    from sgv3d_tpu_torch.configs import get_exp
    from sgv3d_tpu_torch.data.synthetic import write_fake_kitti_root
    from sgv3d_tpu_torch.train.checkpoint import CheckpointManager
    from sgv3d_tpu_torch.weights import seeded_state_dict

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    spawn_ranks(nccl_world1_worker, (f"file://{DIST_DIR}/rendezvous_nccl1", str(DIST_DIR)),
                world=1, timeout=240)
    a = torch.load(DIST_DIR / "nccl1.0.pt", weights_only=False)
    if not (a["backend"] == "nccl" and a["sum_ok"] and a["gathered"][0]["rank"] == 0
            and a["repeat_bitwise"] and a["group_bitwise"]):
        raise AssertionError(f"NCCL at world size 1: {a}")
    out["nccl_world1"] = {**a, "s": time.perf_counter() - t0}
    print(f"[dist] (a) NCCL at world size 1 on {a['device']} (spawned): all_reduce "
          f"(autograd sum, forward and backward), all_gather_object, barrier; the tiny "
          f"BEVHeight step under the group bitwise equal to the step without one "
          f"(total_loss {a['total_loss']:.6f}; deterministic algorithms, the step "
          f"repeated bitwise too) in {out['nccl_world1']['s']:.1f} s")

    t0 = time.perf_counter()
    refs = {}
    for config, bsm in (("bevheight", False), ("sgv3d", True)):
        cfg = dist_tiny_cfg(bsm)
        sd = seeded_state_dict(cfg, seed=5)
        refs[config] = (cfg, sd, dist_references(cfg, sd, dev))
    cfg = get_exp("sgv3d_r50_128")
    train_root = write_fake_kitti_root(DIST_DIR / "train" / "rope3d-kitti", TRAIN_FRAMES,
                                       src_hw=cfg.src_hw, seed=0)
    ecfg = dataclasses.replace(get_exp("bevheight_dair_r101_128"), batch_size_per_device=4,
                               is_train_height=False)
    eval_root = write_fake_kitti_root(DIST_DIR / "eval" / "rope3d-kitti", DIST_EVAL_FRAMES,
                                      src_hw=ecfg.src_hw, seed=0)
    ecfg = dataclasses.replace(ecfg, data_root=eval_root)
    ckpt = DIST_DIR / "r101.msgpack"
    _seeded_checkpoint(ecfg, 0, ckpt)
    one_dir = DIST_DIR / "eval_one_process"
    one = _quiet_evaluate(cfg=ecfg, ckpt_path=str(ckpt), output_dir=str(one_dir), device=dev,
                          val_info_path=rank_batch_infos(eval_root, DIST_DIR, 4))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn_ranks(dist_card_worker, (f"file://{DIST_DIR}/rendezvous_gloo", str(DIST_DIR),
                                   train_root, eval_root, str(ckpt)), timeout=600)
    ranks_s = time.perf_counter() - t0
    full = [torch.load(DIST_DIR / f"full.{r}.pt", weights_only=False)
            for r in range(DIST_WORLD)]
    out["tiny"] = check_dist_tiny(refs, DIST_DIR, "(b) gloo, 2 ranks on one card",
                                  faults=True, grouping_tol=DIST_CARD_GROUPING_TOL)

    tr = [f["train"] for f in full]
    with open(DIST_DIR / "train" / "metrics.jsonl") as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    ckpts = CheckpointManager(str(DIST_DIR / "train" / "checkpoints")).all_steps()
    need = (9, 1)
    if not (all(r["step"] == DIST_TRAIN_STEPS for r in tr)
            and len(losses) == DIST_TRAIN_STEPS and all(np.isfinite(losses))
            and all(r["per_step"] == [need] * DIST_TRAIN_STEPS for r in tr)
            and all(all(r["same_state"]) and len(r["same_state"]) == DIST_TRAIN_STEPS
                    for r in tr)
            and ckpts == [DIST_TRAIN_STEPS]
            and len({tuple(r["bn_calls"]) for r in tr}) == 1 and tr[0]["bn_calls"][0] > 0):
        raise AssertionError(f"2-rank training: losses {losses}, checkpoints {ckpts}, "
                             + "; ".join(f"rank {i}: steps {r['step']}, K2 / K2b a step "
                                         f"{r['per_step']} (need {need}), same state "
                                         f"{r['same_state']}, BatchNorm collectives "
                                         f"{r['bn_calls']}" for i, r in enumerate(tr)))
    out["train"] = {
        "exp": cfg.name, "batch_per_rank": cfg.batch_size_per_device, "ranks": DIST_WORLD,
        "backend": "gloo, 2 ranks on one card", "steps": DIST_TRAIN_STEPS,
        "losses": losses, "params": tr[0]["params"],
        "s_per_step": [r["step_s"] for r in tr],
        "grad_allreduce_s": [r["grad_allreduce_s"] for r in tr],
        "bn_collectives_per_step": tr[0]["bn_calls"][0],
        "peak_mem_gib": [r["peak_mem_gib"] for r in tr],
        "launches": [r["launches"] for r in tr],
        "launches_per_step": dict(zip(("lift_splat", "lift_splat_bwd"), need))}
    print(f"[dist] (b) {cfg.name} at its own widths, batch 2 a rank, 2 ranks on one "
          f"card (gloo: a correctness run, not NCCL's speed), runner.train for "
          f"{DIST_TRAIN_STEPS} steps: losses finite {[round(v, 4) for v in losses]}; K2 / "
          f"K2b launches {need[0]} / {need[1]} a step on each rank; the ranks' states "
          f"the same bits after every step (sha256 gathered); one rank-0 checkpoint "
          f"(step {ckpts[0]}); {tr[0]['bn_calls'][0]} BatchNorm all-reduces a step; "
          f"seconds a step (synchronised) rank 0 "
          f"{[round(s, 3) for s in tr[0]['step_s']]}, rank 1 "
          f"{[round(s, 3) for s in tr[1]['step_s']]}; the gradient all-reduce of "
          f"{tr[0]['params']} floats {[round(s, 3) for s in tr[0]['grad_allreduce_s']]} s "
          f"(gloo through the host); peak torch.cuda.max_memory_allocated "
          f"{[round(r['peak_mem_gib'], 2) for r in tr]} GiB a rank ({smi})")

    ev = [f["eval"] for f in full]
    dets, lines = compare_evaluations(one_dir, DIST_DIR / "eval", tol=1e-3)
    if not (ev[1]["result"] is None and ev[0]["result"] is not None
            and abs(ev[0]["result"][0] - one[0]) <= 1e-3
            and all(e["launches"]["lift_splat"] > 0 for e in ev) and lines > 0):
        raise AssertionError(f"2-rank evaluation: rank results "
                             f"{[None if e['result'] is None else e['result'][0] for e in ev]} "
                             f"vs one process {one[0]}, K2 launches "
                             f"{[e['launches'] for e in ev]}, {lines} KITTI lines")
    out["eval"] = {"exp": ecfg.name, "frames": DIST_EVAL_FRAMES, "batch_per_rank": 4,
                   "mAP": ev[0]["result"][0], "one_process_mAP": one[0],
                   "detections": dets, "kitti_lines": lines,
                   "evaluate_s": [e["evaluate_s"] for e in ev],
                   "launches": [e["launches"] for e in ev],
                   "peak_mem_gib": [e["peak_mem_gib"] for e in ev]}
    print(f"[dist] (b) {ecfg.name} parity-grade evaluation, {DIST_EVAL_FRAMES} frames, "
          f"batch 4 a rank: rank 0's {dets} detections and {lines} KITTI lines equal "
          f"the one-process evaluation's of the same batches within 1e-3 (mAP "
          f"{ev[0]['result'][0]:.4f} vs "
          f"{one[0]:.4f}), rank 1 returned None; K2 launches "
          f"{[e['launches']['lift_splat'] for e in ev]} by rank; evaluate() "
          f"{[round(e['evaluate_s'], 2) for e in ev]} s by rank (gloo, shared card); "
          f"peak {[round(e['peak_mem_gib'], 2) for e in ev]} GiB ({smi})")
    print(f"[dist] (b) one-process references and fake roots {prep_s:.1f} s, the two "
          f"ranks' processes {ranks_s:.1f} s from spawn to exit")

    if torch.cuda.device_count() >= 2:
        cdir = DIST_DIR / "nccl2"
        cdir.mkdir()
        spawn_ranks(nccl_two_card_worker, (f"file://{DIST_DIR}/rendezvous_nccl2", str(cdir)),
                    timeout=300)
        out["nccl_2rank"] = check_dist_tiny(refs, cdir, "(c) NCCL, 2 cards", faults=False,
                                            grouping_tol=DIST_CARD_GROUPING_TOL)
    else:
        out["nccl_2rank"] = "not run (1 card)"
        print("[dist] (c) nccl_2rank: not run (1 card)")
    shutil.rmtree(DIST_DIR)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = _nvidia_smi()
    if sys.argv[1:] == ["--time-k2b"]:
        import sgv3d_tpu_torch
        rounds = [time_k2b() for _ in range(5)]
        print(json.dumps({"k2b_ms": {k: [r[k]["ms"] for r in rounds] for k in rounds[0]},
                          "digest": {k: v["digest"] for k, v in rounds[0].items()},
                          "tree": str(Path(sgv3d_tpu_torch.__file__).resolve().parent.parent),
                          "device": smi}))
        return 0
    if sys.argv[1:] == ["--time-k2"]:
        import sgv3d_tpu_torch
        rounds = [time_k2() for _ in range(5)]
        print(json.dumps({"k2_ms": {k: [r[k]["ms"] for r in rounds] for k in rounds[0]},
                          "digest": {k: v["digest"] for k, v in rounds[0].items()},
                          "tree": str(Path(sgv3d_tpu_torch.__file__).resolve().parent.parent),
                          "device": smi}))
        return 0
    if sys.argv[1:] == ["--sweep-k2b"]:
        print(json.dumps({"k2b_variants": sweep_k2b(), "device": smi}))
        return 0
    if sys.argv[1:] == ["--time-k1"]:
        import sgv3d_tpu_torch
        times = [time_k1() for _ in range(5)]
        print(json.dumps({"k1_serving_ms": times, "tree": str(
            Path(sgv3d_tpu_torch.__file__).resolve().parent.parent),
            "device": smi}))
        return 0
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False     # as the predictor sets it
    phase_build()
    kernels = phase_kernels(dev, smi) + [phase_k3(dev, smi)]
    k4 = phase_k4(dev, smi)
    phase_tiny(dev)
    launches_r101, full = phase_full(dev, smi)
    launches, forwards, sgv3d = phase_sgv3d(dev, smi)
    phase_eval_tiny(dev)
    evaluation = phase_eval_full(dev, smi)
    k2b = phase_k2b(dev, smi)
    c4 = phase_c4(dev, smi)
    phase_train_tiny(dev)
    training = phase_train_full(dev, smi)
    sam = phase_sam(dev, smi)
    distributed = phase_dist(dev, smi)
    k2b["launches"] = training["launches"]["lift_splat_bwd"]
    k2b["launches_per_step"] = training["launches_per_step"]["lift_splat_bwd"]
    kernels.append(k2b)
    topk = training["train_lift_top_k"]
    for entry in kernels:
        if entry["name"] in topk["launches"]:
            entry["launches_train_topk"] = topk["launches"][entry["name"]]
            entry["launches_train_topk_per_step"] = topk["launches_per_step"][entry["name"]]
    for entry in kernels:
        if entry["name"] in distributed["train"]["launches_per_step"]:
            entry["launches_dist_train"] = [r[entry["name"]]
                                            for r in distributed["train"]["launches"]]
            entry["launches_dist_train_per_step"] = \
                distributed["train"]["launches_per_step"][entry["name"]]
        if entry["name"] in distributed["eval"]["launches"][0]:
            entry["launches_dist_eval"] = [r[entry["name"]]
                                           for r in distributed["eval"]["launches"]]
    for entry in kernels[:-1]:
        entry["launches"] = launches[entry["name"]]
        entry["launches_per_forward"] = launches[entry["name"]] // forwards
        if entry["name"] in training["launches"]:
            entry["launches_train"] = training["launches"][entry["name"]]
            entry["launches_train_per_step"] = training["launches_per_step"][entry["name"]]
            entry.update({f"{k}_train": v for k, v in k2b.pop("k2_train").items()})
        if entry["name"] in launches_r101:
            entry["launches_r101"] = launches_r101[entry["name"]]
        for path, row in evaluation.items():
            if entry["name"] in row["launches"]:
                entry[f"launches_eval_{path}"] = row["launches"][entry["name"]]
                entry["max_abs_err"] = max(
                    entry["max_abs_err"],
                    row.get(f"{entry['name']}_max_abs_err", 0.0))
    print(f"[env] chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels + k4, "sgv3d_full_width": sgv3d,
                      "r101_full_width": full, "r101_eval": evaluation,
                      "sgv3d_train": training, "sam_vit_b": sam,
                      "dist": distributed, "c4": c4}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
