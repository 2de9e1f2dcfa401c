"""Probe of the lift pair, K1 (`csrc/topk_cells.cu`) and K2
(`csrc/lift_splat.cu`), at the shapes of both served paths, batch 4.

    python -m sgv3d_tpu_torch.tools.lift_probe

Times with CUDA events (mean of 20 calls after a warm-up) K1 at each
number of lanes a pixel (`topk_cells.LANES`, the kernel's own choice
marked), and K2 whole and split into its prep (the key placement) and its
pool, each launched alone, with each kernel's device time from
`torch.profiler`. Two kinds of cells: uniform ones with a quarter in the
trash cell (the inputs of `chip_smoke.py`), and the cells of each exp's own
synthetic rig after the pixel cull (skewed: near cells dense, far cells
empty), with K1's top-k of seeded softmax heights feeding K2. It needs an
NVIDIA GPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
import subprocess
import sys
import time

import numpy as np
import torch

from sgv3d_tpu_torch.configs import get_exp
from sgv3d_tpu_torch.data.synthetic import make_batch
from sgv3d_tpu_torch.nn.lss_fpn import compute_lift_cells, compute_valid_pixels
from sgv3d_tpu_torch.ops import cuda_lib
from sgv3d_tpu_torch.ops.lift_splat import lift_splat_forward, workspace
from sgv3d_tpu_torch.ops.topk_cells import LANES, lanes_per_pixel, topk_with_cells
from sgv3d_tpu_torch.ops.voxel_pooling import apply_pixel_cull, cull_pixel_indices

BATCH = 4
# exp, context channels into the lift
EXPS = (("sgv3d_r50_128", 87), ("bevheight_dair_r101_128", 80))


def _cuda_ms(fn, iters: int = 20) -> float:
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


def rig_cells(cfg, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The exp's synthetic rig (seed 0) as the predictor sees it: top-k
    layout cells (N, HW_kept, D) after the cull, and all-bin cells
    (N, D, HW)."""
    _, mats, *_ = make_batch(cfg, batch=BATCH, seed=0, num_objs=1, max_objs=1)
    cpu = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in mats.items()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    bb = cfg.backbone
    num_cells = int(bb.voxel_grid.voxel_num[0]) * int(bb.voxel_grid.voxel_num[1])
    cells = compute_lift_cells(bb, card)
    pix_np, n_valid = cull_pixel_indices(
        compute_valid_pixels(bb, cpu).any(0).numpy())
    cells = apply_pixel_cull(cells, torch.from_numpy(pix_np).to(dev), n_valid,
                             num_cells)
    all_bin = compute_lift_cells(dataclasses.replace(bb, lift_top_k=None), card)
    n = all_bin.shape[0] * all_bin.shape[1]
    return cells, all_bin.reshape(n, bb.num_height_bins, -1)


def _segments(cells: torch.Tensor, batch: int, num_cells: int) -> str:
    n = cells.shape[0]
    cams = torch.arange(n, device=cells.device) // (n // batch)
    live = cells < num_cells
    keys = (cells.long() + (cams * num_cells)[:, None, None])[live]
    counts = torch.bincount(keys, minlength=batch * num_cells)
    busy = int((counts > 0).sum())
    return (f"trash share {1 - float(live.float().mean()):.3f}, non-empty "
            f"cells {busy} of {counts.numel()}, points a non-empty cell mean "
            f"{float(counts.sum()) / max(busy, 1):.1f} max {int(counts.max())}")


def topk_launcher(h, cells, k: int, lanes: int):
    """A closure that launches K1 at `lanes` lanes a row (one of
    topk_cells.LANES), uncounted, and the (vals, cells) it writes."""
    n, hw, d = h.shape
    vals = torch.empty((n, k, hw), dtype=torch.float32, device=h.device)
    out = torch.empty((n, k, hw), dtype=torch.int32, device=h.device)
    lib = cuda_lib.library()

    def launch():
        cuda_lib.check(lib.topk_cells_launch(
            h.data_ptr(), cells.data_ptr(), vals.data_ptr(), out.data_ptr(),
            n * hw, d, k, hw, lanes,
            torch.cuda.current_stream(h.device).cuda_stream), "topk_cells_launch")

    return launch, (vals, out)


def k2_launchers(height, ctx, cells, batch: int, num_cells: int):
    """Closures that launch K2's prep alone and its pool alone (over the
    prep's workspace), uncounted and without a sync, for timing."""
    n, j, hw = height.shape
    c = ctx.shape[-1]
    dev = height.device
    ws = torch.empty(workspace(n, j, hw, batch, num_cells, c)[0],
                     dtype=torch.int32, device=dev)
    out = torch.empty((batch, num_cells, c), dtype=torch.float32, device=dev)
    lib = cuda_lib.library()
    launched = ctypes.c_int(0)

    def prep():
        cuda_lib.check(lib.lift_prep_launch(
            height.data_ptr(), cells.data_ptr(), ws.data_ptr(), ws.numel(),
            None, batch, num_cells, n, j, hw, ctypes.byref(launched),
            torch.cuda.current_stream(dev).cuda_stream), "lift_prep_launch")

    def pool():
        cuda_lib.check(lib.lift_pool_launch(
            ctx.data_ptr(), ws.data_ptr(), ws.numel(), out.data_ptr(), batch,
            num_cells, n, j, hw, c, ctypes.byref(launched),
            torch.cuda.current_stream(dev).cuda_stream), "lift_pool_launch")

    prep()
    return prep, pool


def kernel_us(fn, iters: int = 10) -> dict:
    """Device time of each kernel (and memset) that `fn` launches, in us a
    call, from `torch.profiler` over `iters` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            m = re.search(r"(\w+)(<[^()]*>)?\(", evt.key)
            out[m.group(1) + (m.group(2) or "") if m else evt.key[:32]] = us / iters
    return out


def host_us(fn, iters: int = 20) -> float:
    """Host time to enqueue one call of `fn`, in us (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def k2_split(height, ctx, cells, batch, num_cells) -> dict:
    prep, pool = k2_launchers(height, ctx, cells, batch, num_cells)
    return {"prep": _cuda_ms(prep), "pool": _cuda_ms(pool),
            "total": _cuda_ms(lambda: lift_splat_forward(height, ctx, cells, batch,
                                                         num_cells))}


def _warm_up(dev) -> None:
    """About a second of back-to-back work, so the first timing does not
    read a card still raising its clocks."""
    a = torch.randn(4096, 4096, device=dev)
    for _ in range(200):
        a = a @ a
        a = a / a.abs().max()
    torch.cuda.synchronize()


def _line(label: str, parts: dict) -> str:
    return f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())


def run(dev) -> list[str]:
    lines = []

    def emit(line):
        lines.append(line)
        print(line, flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    _warm_up(dev)
    for exp, c in EXPS:
        cfg = get_exp(exp)
        d, k = cfg.backbone.num_height_bins, cfg.backbone.lift_top_k
        num_cells = int(np.prod(cfg.backbone.voxel_grid.voxel_num[:2]))
        top_cells, all_cells = rig_cells(cfg, dev)
        n, hw, _ = top_cells.shape
        hw_all = all_cells.shape[-1]
        # uniform cells, a quarter in the trash cell (chip_smoke's inputs)
        uni = {}
        for layout, jj, hwl in (("top-k", k, hw), ("all-bin", d, hw_all)):
            cl = torch.randint(0, num_cells, (n, jj, hwl), generator=g,
                               device=dev, dtype=torch.int32)
            trash = torch.rand(n, jj, hwl, generator=g, device=dev) < 0.25
            uni[layout] = torch.where(trash, num_cells, cl).to(torch.int32)
        h_hwd = torch.softmax(torch.randn(n, hw, d, generator=g, device=dev) * 3, -1)
        cells_hwd = torch.randint(0, num_cells + 1, (n, hw, d), generator=g,
                                  device=dev, dtype=torch.int32)
        for kind, cl in (("uniform", cells_hwd), ("rig", top_cells)):
            launchers = {lanes: topk_launcher(h_hwd, cl, k, lanes)[0]
                         for lanes in LANES}
            ms = {lanes: _cuda_ms(fn) for lanes, fn in launchers.items()}
            dev_us = {lanes: sum(kernel_us(fn).values())
                      for lanes, fn in launchers.items()}
            own = lanes_per_pixel(n * hw)
            shown = [f"{lanes}: {t:.4f} ("
                     + (f"{dev_us[lanes]:.1f}" if dev_us[lanes] else "not traced")
                     + (") (own)" if lanes == own else ")")
                     for lanes, t in ms.items()]
            enqueue = host_us(lambda: topk_with_cells(h_hwd, cl, k))
            emit(f"{exp} K1 ({n}, {hw}, {d}) k={k} {kind} cells, by lanes a "
                 f"pixel, ms (device us): {', '.join(shown)}; host enqueue "
                 f"{enqueue:.1f} us a call")
        vals, rig_top = topk_with_cells(h_hwd, top_cells, k)
        for layout, jj, hwl, rig in (("top-k", k, hw, rig_top),
                                     ("all-bin", d, hw_all, all_cells)):
            ctx = torch.randn(n, hwl, c, generator=g, device=dev)
            height = (vals if layout == "top-k" else
                      torch.softmax(torch.randn(n, d, hwl, generator=g,
                                                device=dev) * 3, 1))
            for kind, cl in (("uniform", uni[layout]), ("rig", rig)):
                label = f"{exp} K2 {layout} ({n}, {jj}, {hwl}) x C={c} {kind} cells"
                emit(f"{label}: {_segments(cl, BATCH, num_cells)}")
                args = (height.contiguous(), ctx, cl.contiguous(), BATCH, num_cells)
                emit(_line(label, k2_split(*args)))
                def fwd():
                    return lift_splat_forward(*args)

                per = ", ".join(f"{name} {us:.1f}" for name, us in kernel_us(fwd).items())
                emit(f"{label}: device us a call by kernel: {per}; host enqueue "
                     f"{host_us(fwd):.1f} us a call")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("lift_probe: needs an NVIDIA GPU (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"lift_probe on {torch.cuda.get_device_name(0)} ({smi})")
    run(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
