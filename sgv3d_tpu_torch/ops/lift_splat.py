"""Lift-splat BEV pooling forward (kernel K2).

Port of the TPU kernel `sgv3d_tpu.ops.pallas_lift_splat` and so of the
forward of `sgv3d_tpu.ops.voxel_pooling.lift_splat_pool`:
BEV[b, cell, :] = sum of height[n, j, p] * context[n, p, :] over the points
of the cameras of b whose cell is `cell`; cell `num_cells` is the trash.

Both layouts are (N, J, HW): J = k for the top-k lift, J = D for the
all-bin lift. The prep places every live point (cell in [0, num_cells)) in
its slot of the order of key b * num_cells + cell, ties by flat point
index: a stable sort's order with the trash left out, which the kernel
builds by its own LSD radix over the key range's bits. On a CUDA tensor
`lift_splat_forward` launches `csrc/lift_splat.cu` (prep and pool); on a
CPU tensor it runs `lift_splat_plain`, the same function in plain torch on
`lift_prep_plain` (`torch.sort(stable=True)`). There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from sgv3d_tpu_torch.ops import cuda_lib

MAX_CHANNELS = 128
POINT_CHUNK = 1 << 20   # points a gather + index_add_ in the plain version


def lift_prep_plain(cells: torch.Tensor, batch: int,
                    num_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's prep in plain torch: (offsets (batch * num_cells + 1,),
    order (live points,)) int64. Segment g = b * num_cells + cell holds the
    flat point indices order[offsets[g]:offsets[g + 1]], ascending: the
    offsets are the exclusive scan of the per-key counts, the order a
    stable sort of the live points' keys."""
    flat = cells.reshape(-1).long()
    per_b = flat.numel() // batch
    live = torch.nonzero((flat >= 0) & (flat < num_cells)).reshape(-1)
    keys = (live // per_b) * num_cells + flat[live]
    counts = torch.bincount(keys, minlength=batch * num_cells)
    offsets = torch.zeros(batch * num_cells + 1, dtype=torch.long,
                          device=cells.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, live[torch.sort(keys, stable=True).indices]


def lift_splat_plain(height: torch.Tensor, context: torch.Tensor,
                     cells: torch.Tensor, batch: int,
                     num_cells: int) -> torch.Tensor:
    """fp32 height * context rows of the prep's order, `index_add_`ed into
    their cells POINT_CHUNK points at a time (bounding the live product to
    POINT_CHUNK * C floats)."""
    n, j, hw = height.shape
    c = context.shape[-1]
    offsets, order = lift_prep_plain(cells, batch, num_cells)
    keys = torch.repeat_interleave(
        torch.arange(batch * num_cells, device=height.device), offsets.diff())
    rows = (order // (j * hw)) * hw + order % hw
    h_flat = height.reshape(-1).float()
    ctx = context.reshape(-1, c).float()
    out = torch.zeros(batch * num_cells, c, dtype=torch.float32,
                      device=height.device)
    for s in range(0, order.numel(), POINT_CHUNK):
        sl = slice(s, s + POINT_CHUNK)
        out.index_add_(0, keys[sl], h_flat[order[sl], None] * ctx[rows[sl]])
    return out.reshape(batch, num_cells, c)


def workspace(n: int, j: int, hw: int, batch: int, num_cells: int, c: int = 0,
              lib=None) -> tuple[int, int]:
    """(ints of the kernel's int32 workspace for these shapes and a pool of
    C channels, int offset in it of the prep's (row, weight) pairs), as
    `lib` (default: the port's kernels) lays it out."""
    if lib is None:
        return _layout(n, j, hw, batch, num_cells, c)
    out = (ctypes.c_longlong * 2)()
    cuda_lib.check(lib.lift_splat_layout(batch, num_cells, n, j, hw, c, out),
                   "lift_splat_layout")
    return out[0], out[1]


@functools.lru_cache(maxsize=64)
def _layout(n: int, j: int, hw: int, batch: int, num_cells: int,
            c: int) -> tuple[int, int]:
    return workspace(n, j, hw, batch, num_cells, c, cuda_lib.library())


def _check(name, height, cells, batch, context=None):
    dev = height.device
    if dev.type != "cuda" or cells.device != dev or (
            context is not None and context.device != dev):
        raise ValueError(f"{name}: unsupported devices {dev}, {cells.device}"
                         + ("" if context is None else f", {context.device}"))
    if height.dtype != torch.float32 or cells.dtype != torch.int32 or (
            context is not None and context.dtype != torch.float32):
        raise TypeError(f"{name}: need float32 heights and context and int32 "
                        f"cells; got {height.dtype}, {cells.dtype}"
                        + ("" if context is None else f", {context.dtype}"))
    n, j, hw = height.shape
    if cells.shape != height.shape or n % batch or (context is not None and (
            context.dim() != 3 or context.shape[:2] != (n, hw)
            or context.shape[-1] > MAX_CHANNELS)):
        raise ValueError(
            f"{name}: bad shapes height {tuple(height.shape)}, cells "
            f"{tuple(cells.shape)}, batch {batch}" + (
                "" if context is None else
                f", context {tuple(context.shape)} (C <= {MAX_CHANNELS})"))


def lift_splat_prep(height: torch.Tensor, cells: torch.Tensor, batch: int,
                    num_cells: int) -> dict:
    """The kernel's prep alone, on the card (for checks and probes):
    'offsets' (batch * num_cells + 1,) and, for the live points in slot
    order, 'order' (flat point index), 'rows' (context row n * HW + p) and
    'weights' (height), each int32 / float32 of that many points."""
    _check("lift_splat_prep", height, cells, batch)
    n, j, hw = height.shape
    h, cl = height.contiguous(), cells.contiguous()
    keys = batch * num_cells
    ints, pairs_at = workspace(n, j, hw, batch, num_cells)
    ws = torch.empty(ints, dtype=torch.int32, device=h.device)
    order = torch.empty(n * j * hw, dtype=torch.int32, device=h.device)
    launched = ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().lift_prep_launch(
        h.data_ptr(), cl.data_ptr(), ws.data_ptr(), ws.numel(),
        order.data_ptr(), batch, num_cells, n, j, hw, ctypes.byref(launched),
        torch.cuda.current_stream(h.device).cuda_stream), "lift_prep_launch")
    lift_splat_prep.launches += launched.value
    offsets = ws[:keys + 1]
    live = int(offsets[-1])
    pairs = ws[pairs_at:pairs_at + 2 * live].view(live, 2)
    return {"offsets": offsets, "order": order[:live], "rows": pairs[:, 0],
            "weights": pairs[:, 1].view(torch.float32)}


def lift_splat_forward(height: torch.Tensor, context: torch.Tensor,
                       cells: torch.Tensor, batch: int,
                       num_cells: int) -> torch.Tensor:
    """height (N, J, HW) float32, context (N, HW, C) float32, cells
    (N, J, HW) int32 in [0, num_cells] -> (B, num_cells, C) float32.
    N must be a multiple of `batch`; camera n pools into grid n // (N // B).
    On the card one call makes several launches (the prep's memset and
    kernels, then the pool's), each counted in `launches`."""
    if height.device.type == "cpu":
        return lift_splat_plain(height, context, cells, batch, num_cells)
    _check("lift_splat_forward", height, cells, batch, context)
    n, j, hw = height.shape
    c = context.shape[-1]
    h, ctx, cl = height.contiguous(), context.contiguous(), cells.contiguous()
    ws = torch.empty(workspace(n, j, hw, batch, num_cells, c)[0],
                     dtype=torch.int32, device=h.device)
    out = torch.empty((batch, num_cells, c), dtype=torch.float32, device=h.device)
    launched = ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().lift_splat_launch(
        h.data_ptr(), ctx.data_ptr(), cl.data_ptr(), ws.data_ptr(), ws.numel(),
        out.data_ptr(), batch, num_cells, n, j, hw, c, ctypes.byref(launched),
        torch.cuda.current_stream(h.device).cuda_stream), "lift_splat_launch")
    lift_splat_forward.launches += launched.value
    return out


lift_splat_forward.launches = 0
lift_splat_prep.launches = 0
