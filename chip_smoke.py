#!/usr/bin/env python3
"""Smoke run of the torch port (`sgv3d_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. build the CUDA kernels from `sgv3d_tpu_torch/csrc` (one nvcc a source,
     all started together; sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, batch 4:
     K1 top-k-with-cells exactly (its lanes a pixel printed) and K2
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
     their scale, decoded boxes equal as a tie-aware set;
  4. `bevheight_dair_r101_128` at 864x1536, uint8 images, batch 4, seeded
     weights, serving defaults (bf16 backbone, static rig, pixel cull,
     top-16 lift): `__call__` once and `stream` over 3 batches, with the
     kernels' launch counts set to 0 just before and read just after, then
     20 timed batches each way; then the exact all-bin lift;
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
     that the DCN's offsets are float32 under bf16 autocast.
The line before the last is the card's name and power limit from
nvidia-smi; the last line is {"ok": true, "device": {...}}. Needs no jax.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
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
        # K1 at (4, hw, 90), k = 16: softmax rows, rows of exact ties, and
        # rows padded with -inf (some with fewer than k finite bins)
        h = torch.softmax(torch.randn(n, hw, d, generator=g, device=dev) * 3, -1)
        h[:, ::7] = torch.randint(0, 4, (n, len(range(0, hw, 7)), d), generator=g,
                                  device=dev).float() / 4
        h[:, 1::11, 50:] = float("-inf")
        h[:, 2::13, 5:] = float("-inf")
        cells = torch.randint(0, num_cells + 1, (n, hw, d), generator=g,
                              device=dev, dtype=torch.int32)
        lanes = lanes_per_pixel(n * hw)
        got = topk_with_cells(h, cells, k)
        ref = topk_cells_plain(h, cells, k)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            bad = (got[0] != ref[0]) | (got[1] != ref[1])
            raise AssertionError(f"K1 ({path}) differs from its plain version "
                                 f"at {int(bad.sum())} of {bad.numel()} outputs")
        k1["ms" + suffix] = _graph_ms(lambda: topk_with_cells(h, cells, k))
        k1["call_ms" + suffix] = _cuda_ms(lambda: topk_with_cells(h, cells, k))
        k1["plain_ms" + suffix] = _cuda_ms(lambda: topk_cells_plain(h, cells, k))
        k1["library_ms" + suffix] = _graph_ms(lambda: torch.topk(h, k, dim=-1))
        # one compare a candidate bin, on the fp32 cores
        k1["bound_ms" + suffix], k1["bound_by" + suffix] = _bound(
            (h, cells) + tuple(got), h.numel(), PEAK_FP32_FLOPS)
        k1["shape" + suffix] = [n, hw, d, k]
        k1["lanes_per_pixel" + suffix] = lanes
        print(f"[kernels] K1 topk_cells {path} ({n}, {hw}, {d}) k={k}, {lanes} "
              f"lanes a pixel: exact; "
              f"kernel {k1['ms' + suffix]:.4f} ms (wrapper call "
              f"{k1['call_ms' + suffix]:.4f} ms), plain "
              f"{k1['plain_ms' + suffix]:.4f} ms, torch.topk "
              f"{k1['library_ms' + suffix]:.4f} ms, bound "
              f"{k1['bound_ms' + suffix]:.4f} ms ({k1['bound_by' + suffix]}) "
              f"({smi})")

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
    return [k1, k2]


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
                      "heightnet_ms": hn["heightnet_ms"], "dcn_ms": hn["dcn_ms"]}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = _nvidia_smi()
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
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["launches_per_forward"] = launches[entry["name"]] // forwards
        if entry["name"] in launches_r101:
            entry["launches_r101"] = launches_r101[entry["name"]]
        for path, row in evaluation.items():
            if entry["name"] in row["launches"]:
                entry[f"launches_eval_{path}"] = row["launches"][entry["name"]]
                entry["max_abs_err"] = max(
                    entry["max_abs_err"],
                    row.get(f"{entry['name']}_max_abs_err", 0.0))
    print(json.dumps({"kernels": kernels + k4, "sgv3d_full_width": sgv3d,
                      "r101_full_width": full, "r101_eval": evaluation}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
