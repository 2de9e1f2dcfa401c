"""Build and load the port's hand-written CUDA kernels.

Each source in `sgv3d_tpu_torch/csrc/*.cu` is compiled by its own `nvcc`
for `sm_90a`, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with `ctypes`. The build
happens at first use, into `build/kernels/<hash>/` at the repository root
(listed in `.gitignore`), keyed by a hash of the sources and flags, so a
fresh checkout builds everything on its first kernel call. There is no
fallback: a missing `nvcc` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argtypes. Every function returns 0 or the CUDA
# error of its launches (-1 for arguments it refuses); `launched` gets the
# number of launches a call made.
SIGNATURES = {
    # (h, cells, out_vals, out_cells, out_bins or None, rows, d, k, hw,
    #  lanes, stream)
    "topk_cells_launch": [_P] * 5 + [_I] * 5 + [_P],
    # (batch, num_cells, n, j, hw, c, out[2])
    "lift_splat_layout": [_I] * 6 + [_P],
    # (height, cells, ws, ws_ints, order, batch, num_cells, n, j, hw,
    #  launched, stream)
    "lift_prep_launch": [_P, _P, _P, _L, _P] + [_I] * 5 + [_IP, _P],
    # (context, ws, ws_ints, out, batch, num_cells, n, j, hw, c, launched,
    #  stream)
    "lift_pool_launch": [_P, _P, _L, _P] + [_I] * 6 + [_IP, _P],
    # (height, context, cells, ws, ws_ints, out, batch, num_cells, n, j, hw,
    #  c, launched, stream)
    "lift_splat_launch": [_P, _P, _P, _P, _L, _P] + [_I] * 6 + [_IP, _P],
    # (j, c, out[5])
    "lift_splat_bwd_plan": [_I, _I, _P],
    # (grad, height, context, cells, d_height, d_ctx, served or None, batch,
    #  num_cells, n, j, hw, feat_w or 0, c, launched, stream)
    "lift_splat_bwd_launch": [_P] * 7 + [_I] * 7 + [_IP, _P],
    # (x, w1, b1, w2, b2, w3, b3, out, batch, h, w, p, th, tw, smem, stream)
    "fused_bottleneck_launch": [_P] * 8 + [_I] * 7 + [_P],
    # (ctx, idx, out, m, hw, c, stream)
    "spike_take_launch": [_P, _P, _P, _I, _I, _I, _P],
    "spike_take_along_launch": [_P, _P, _P, _I, _I, _I, _P],
    "spike_onehot_launch": [_P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH); the port's "
                           "kernels are built from source at first use")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has not been built yet and
    return its path; the compilers' reports go to `nvcc.log` beside it.
    The library is written to a temporary file first, so a concurrent or
    interrupted build never leaves a half-written one behind."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libsgv3d_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.o"
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    # ptxas' register / shared-memory / spill report for each kernel
    (out_dir / "nvcc.log").write_text("".join(log) + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err == -1:
        raise ValueError(f"{name}: the kernel refused its arguments")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
