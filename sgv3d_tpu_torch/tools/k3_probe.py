"""Probe of K3, the fused identity bottleneck (`csrc/fused_bottleneck.cu`),
at the four ResNet-50 stage shapes of a batch of 4 at 864x1536.

    python -m sgv3d_tpu_torch.tools.k3_probe

builds copies of the kernel's source into `build/k3_probe/` and prints, for
each stage, the time of a call (CUDA events, mean of 20 after a warm-up) of
the kernel as it is and of other output tiles and ring depths (the
template arguments of its launch at that width), and the median time each
block spends in set-up and in its three phases (`%globaltimer` stamps
written by one thread of each block). Every variant is checked against the
plain version. It needs an NVIDIA GPU.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from sgv3d_tpu_torch.nn.resnet import Bottleneck
from sgv3d_tpu_torch.ops import cuda_lib
from sgv3d_tpu_torch.ops.fused_bottleneck import (
    fold_bottleneck, fused_bottleneck_plain, ring_stages, smem_bytes, tile_shape)
from sgv3d_tpu_torch.weights import random_init

# (P, H, W) of each ResNet-50 stage at 864x1536, batch 4
STAGES = ((64, 216, 384), (128, 108, 192), (256, 54, 96), (512, 27, 48))
# other (TH, TW, ring stages) to time at each P beside the kernel's own
ALTERNATIVES = {64: ((8, 8, 2), (8, 8, 3)), 128: ((8, 16, 4), (8, 16, 3)),
                256: ((8, 16, 3), (8, 8, 3)), 512: ((8, 8, 2),)}
OUT = cuda_lib.BUILD_ROOT.parent / "k3_probe"

# phase stamps: after set-up, phase 1, phase 2, and at the block's end
_STAMPS = (
    ("namespace {\n", "__device__ unsigned long long g_stamps[1 << 16][5];\n"
     "namespace {\n__device__ __forceinline__ unsigned long long stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  auto halo_inside", "  const unsigned long long t0 = stamp();\n"
     "  auto halo_inside"),
    ("  __syncthreads();\n\n  if (warp == kConsumerWarps) {",
     "  __syncthreads();\n  const unsigned long long t1 = stamp();\n\n"
     "  if (warp == kConsumerWarps) {"),
    ("  consumer_sync();  // y1 complete; every x stage consumed\n",
     "  consumer_sync();  // y1 complete; every x stage consumed\n"
     "  const unsigned long long t2 = stamp();\n"),
    ("  consumer_sync();      // y2 complete\n",
     "  consumer_sync();      // y2 complete\n"
     "  const unsigned long long t3 = stamp();\n"),
    ("}\n\nusing EncodeTiled",
     "  consumer_sync();\n  if (threadIdx.x == 0 && blockIdx.x < (1 << 16)) {\n"
     "    unsigned long long* r = g_stamps[blockIdx.x];\n"
     "    r[0] = t0; r[1] = t1; r[2] = t2; r[3] = t3; r[4] = stamp();\n  }\n"
     "}\n\nusing EncodeTiled"),
)


def _variant_source(p: int, tile: tuple[int, int], stages: int) -> str:
    src = (cuda_lib.CSRC / "fused_bottleneck.cu").read_text()
    for old, new in _STAMPS:
        if old not in src:
            raise RuntimeError(f"k3_probe: anchor {old!r} not in the source")
        src = src.replace(old, new, 1)
    src, n = re.subn(rf"launch<Cfg<{p}, \d+, \d+, \d+>>",
                     f"launch<Cfg<{p}, {tile[0]}, {tile[1]}, {stages}>>", src)
    if n != 1:
        raise RuntimeError(f"k3_probe: no launch of Cfg<{p}, ...> to replace")
    return src + ('\nextern "C" int k3_stamps(void* dst, int blocks) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                  "      dst, g_stamps, static_cast<size_t>(blocks) * 40));\n}\n")


def _build(variants: dict) -> dict:
    """One nvcc a variant, all started together -> name: ctypes library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (p, tile, stages) in variants.items():
        (OUT / f"{name}.cu").write_text(_variant_source(p, tile, stages))
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"k3_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.fused_bottleneck_launch.argtypes = cuda_lib.SIGNATURES[
            "fused_bottleneck_launch"]
        lib.k3_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


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


def run(dev) -> list[str]:
    variants = {}
    for p, _, _ in STAGES:
        for tile_stages in ((*tile_shape(p), ring_stages(p)),) + ALTERNATIVES[p]:
            th, tw, st = tile_stages
            variants[f"p{p}_{th}x{tw}_{st}"] = (p, (th, tw), st)
    libs = _build(variants)
    lines = []
    g = torch.Generator(device=dev).manual_seed(3)
    for p, h, w in STAGES:
        block = Bottleneck(4 * p, p)
        random_init(block, p)
        fb = fold_bottleneck(block.to(dev).eval())
        x = torch.randn(4, h, w, 4 * p, generator=g, device=dev).to(torch.bfloat16)
        ref = fused_bottleneck_plain(x, fb).float()
        out = torch.empty_like(x)
        for name, (vp, tile, st) in variants.items():
            if vp != p:
                continue
            lib = libs[name]

            def call():
                err = lib.fused_bottleneck_launch(
                    x.data_ptr(), fb.w1.data_ptr(), fb.b1.data_ptr(),
                    fb.w2.data_ptr(), fb.b2.data_ptr(), fb.w3.data_ptr(),
                    fb.b3.data_ptr(), out.data_ptr(), 4, h, w, p, *tile,
                    smem_bytes(p, tile, st), torch.cuda.current_stream().cuda_stream)
                cuda_lib.check(err, name)

            ms = _cuda_ms(call)
            call()
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max() / ref.abs().max())
            if not err <= 2e-2:
                raise AssertionError(f"k3_probe {name}: {err:.3e} of scale")
            blocks = 4 * -(-h // tile[0]) * -(-w // tile[1])
            stamps = np.zeros((blocks, 5), np.uint64)
            cuda_lib.check(lib.k3_stamps(stamps.ctypes.data, blocks), "k3_stamps")
            us = np.median(np.diff(stamps.astype(np.int64), axis=1), axis=0) / 1e3
            own = "  (the kernel's own)" if (tile, st) == (tile_shape(p),
                                                            ring_stages(p)) else ""
            lines.append(
                f"P={p} (4, {h}, {w}, {4 * p}) tile {tile[0]}x{tile[1]}, {st} "
                f"stages, {smem_bytes(p, tile, st)} B, {blocks} blocks: "
                f"{ms:.4f} ms a call; a block's median us: set-up {us[0]:.2f}, "
                f"phase 1 {us[1]:.2f}, phase 2 {us[2]:.2f}, phase 3 "
                f"{us[3]:.2f}{own}")
            print(lines[-1], flush=True)
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_probe: needs an NVIDIA GPU (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"k3_probe on {torch.cuda.get_device_name(0)} ({smi})")
    run(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
