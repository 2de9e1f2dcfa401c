"""Exact top-k height bins per pixel with their BEV cell ids (kernel K1).

Port of the TPU kernel `sgv3d_tpu.ops.pallas_topk.pallas_topk_with_cells`.
On a CUDA tensor `topk_with_cells` launches `csrc/topk_cells.cu`; on a CPU
tensor it runs `topk_cells_plain`, the same function in plain torch. There
is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from sgv3d_tpu_torch.ops import cuda_lib

MAX_BINS = 256      # a block's rows of heights in shared memory
MAX_K = 32          # the longest register-resident list a lane keeps
LANES = (2, 4)      # lanes a row the kernel takes


def topk_cells_plain(height_hwd: torch.Tensor, cell_hwd: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable descending sort along D, first k, paired cell gather, in the
    (N, k, HW) layout. Ties go to the lowest bin, as with `lax.top_k`."""
    vals, idx = torch.sort(height_hwd, dim=-1, descending=True, stable=True)
    cells = torch.take_along_dim(cell_hwd, idx[..., :k], dim=-1)
    return (vals[..., :k].transpose(1, 2).contiguous(),
            cells.transpose(1, 2).contiguous())


def lanes_per_pixel(rows: int) -> int:
    """Lanes that share a row: two from 32768 rows up (SGV3D-r50's 73728),
    else four (r101's 18432), the faster of LANES at each of those two
    shapes in `tools/lift_probe.py`'s timing on an H100."""
    return 2 if rows >= 32768 else 4


def topk_with_cells(height_hwd: torch.Tensor, cell_hwd: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """height_hwd (N, HW, D) float32, cell_hwd (N, HW, D) int32 ->
    (vals (N, k, HW) float32 descending, cells (N, k, HW) int32)."""
    if height_hwd.device.type == "cpu":
        return topk_cells_plain(height_hwd, cell_hwd, k)
    if height_hwd.device.type != "cuda" or cell_hwd.device != height_hwd.device:
        raise ValueError(f"topk_with_cells: unsupported devices "
                         f"{height_hwd.device}, {cell_hwd.device}")
    if height_hwd.dtype != torch.float32 or cell_hwd.dtype != torch.int32:
        raise TypeError(f"topk_with_cells: need float32 heights and int32 "
                        f"cells, got {height_hwd.dtype}, {cell_hwd.dtype}")
    if height_hwd.dim() != 3 or cell_hwd.shape != height_hwd.shape:
        raise ValueError(f"topk_with_cells: shapes {tuple(height_hwd.shape)} "
                         f"and {tuple(cell_hwd.shape)} are not one (N, HW, D)")
    n, hw, d = height_hwd.shape
    if d > MAX_BINS or not 0 < k <= min(d, MAX_K):
        raise ValueError(f"topk_with_cells: need D <= {MAX_BINS} and "
                         f"0 < k <= min(D, {MAX_K}); got D={d}, k={k}")
    h = height_hwd.contiguous()
    if h.data_ptr() % 16:       # the kernel's bulk copy needs 16 bytes
        h = h.clone()
    c = cell_hwd.contiguous()
    vals = torch.empty((n, k, hw), dtype=torch.float32, device=h.device)
    cells = torch.empty((n, k, hw), dtype=torch.int32, device=h.device)
    err = cuda_lib.library().topk_cells_launch(
        h.data_ptr(), c.data_ptr(), vals.data_ptr(), cells.data_ptr(),
        n * hw, d, k, hw, lanes_per_pixel(n * hw),
        torch.cuda.current_stream(h.device).cuda_stream)
    cuda_lib.check(err, "topk_cells_launch")
    topk_with_cells.launches += 1
    return vals, cells


topk_with_cells.launches = 0
