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

The backward (kernel K2b, `csrc/lift_splat_bwd.cu`; on the TPU it was XLA
gathers in the custom VJP `_lift_splat_bwd`, not Pallas) is
`lift_splat_backward`, with `lift_splat_backward_plain` beside it. Given
the feature map's width it tiles the map in 2-D patches, whose points share
BEV cells, and reads each patch's rows of g once (`backward_plan`); the
autograd function `LiftSplat` pairs the two directions, on the card K2 and
K2b, on the CPU the plain versions. `TopkCells`, the autograd function of
the top-k training lift's pick (K1 with its bins on the card), feeds it
the (N, k, HW) layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from sgv3d_tpu_torch.ops import cuda_lib
from sgv3d_tpu_torch.ops.topk_cells import topk_with_cells

MAX_CHANNELS = 128
POINT_CHUNK = 1 << 20   # points a gather + index_add_ in the plain version
D_CHUNK = 10            # bins a step of the plain backward (the JAX scan's)


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
    with torch.cuda.device(h.device):
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
    # the CUDA runtime launches on the thread's current card, not the
    # tensors': a rank on cuda:1 must launch from cuda:1
    with torch.cuda.device(h.device):
        cuda_lib.check(cuda_lib.library().lift_splat_launch(
            h.data_ptr(), ctx.data_ptr(), cl.data_ptr(), ws.data_ptr(), ws.numel(),
            out.data_ptr(), batch, num_cells, n, j, hw, c, ctypes.byref(launched),
            torch.cuda.current_stream(h.device).cuda_stream), "lift_splat_launch")
    lift_splat_forward.launches += launched.value
    return out


def lift_splat_backward_plain(grad: torch.Tensor, height: torch.Tensor,
                              context: torch.Tensor, cells: torch.Tensor,
                              batch: int, num_cells: int,
                              feat_w: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX custom VJP's backward (`_lift_splat_bwd`) in plain torch:
    gather each point's row of `grad` (B, num_cells, C) at its cell, a zero
    row for the trash (any cell outside [0, num_cells)), then
    d_height = <g_row, ctx_row> and d_ctx = sum over j of height * g_row,
    D_CHUNK bins at a time. Returns (d_height (N, J, HW), d_ctx
    (N, HW, C)) float32; cells get no gradient. `feat_w` (the kernel's
    tiling) is ignored."""
    n, j, hw = height.shape
    c = context.shape[-1]
    g_pad = torch.cat([grad.float(), grad.new_zeros(batch, 1, c, dtype=torch.float32)],
                      dim=1).reshape(batch * (num_cells + 1), c)
    cl = cells.long()
    cl = torch.where((cl >= 0) & (cl < num_cells), cl, num_cells)
    b_of_cam = torch.arange(n, device=cells.device) // (n // batch)
    gcell = cl + (b_of_cam * (num_cells + 1))[:, None, None]
    ctx = context.float()
    d_height = torch.empty(n, j, hw, dtype=torch.float32, device=height.device)
    d_ctx = torch.zeros(n, hw, c, dtype=torch.float32, device=height.device)
    for s in range(0, j, D_CHUNK):
        rows = g_pad[gcell[:, s:s + D_CHUNK]]              # (N, dc, HW, C)
        d_height[:, s:s + D_CHUNK] = torch.einsum("ndpc,npc->ndp", rows, ctx)
        d_ctx += torch.einsum("ndpc,ndp->npc", rows, height[:, s:s + D_CHUNK].float())
    return d_height, d_ctx


def lift_splat_backward(grad: torch.Tensor, height: torch.Tensor,
                        context: torch.Tensor, cells: torch.Tensor, batch: int,
                        num_cells: int, feat_w: int | None = None,
                        served: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """grad (B, num_cells, C) float32 and the forward's height, context and
    cells -> (d_height (N, J, HW), d_ctx (N, HW, C)) float32. `feat_w`: the
    feature map's width when HW is a whole fH x fW map (the kernel then
    tiles it in 2-D patches, whose points share cells); None takes HW as
    one row. On a CUDA tensor one launch of K2b, counted in `launches`;
    `served`, an int32 CUDA tensor of one element, gets the count of live
    points the kernel read from its staged rows added. On the CPU
    `lift_splat_backward_plain`."""
    hw = height.shape[-1]
    if feat_w is not None and (feat_w <= 0 or hw % feat_w):
        raise ValueError(f"lift_splat_backward: HW {hw} is not a whole number "
                         f"of rows of width {feat_w}")
    if height.device.type == "cpu":
        if served is not None:
            raise ValueError("lift_splat_backward: `served` counts the card "
                             "kernel's staged reads; the CPU has none")
        return lift_splat_backward_plain(grad, height, context, cells, batch,
                                         num_cells)
    _check("lift_splat_backward", height, cells, batch, context)
    n, j, hw = height.shape
    c = context.shape[-1]
    if grad.device != height.device or grad.dtype != torch.float32 or (
            tuple(grad.shape) != (batch, num_cells, c)):
        raise ValueError(f"lift_splat_backward: grad {tuple(grad.shape)} "
                         f"{grad.dtype} on {grad.device}; need float32 "
                         f"({batch}, {num_cells}, {c}) on {height.device}")
    if served is not None and (served.device != height.device
                               or served.dtype != torch.int32 or served.numel() != 1):
        raise ValueError("lift_splat_backward: `served` must be one int32 on "
                         f"{height.device}")
    g, h = grad.contiguous(), height.contiguous()
    ctx, cl = context.contiguous(), cells.contiguous()
    d_height = torch.empty_like(h)
    d_ctx = torch.empty_like(ctx)
    launched = ctypes.c_int(0)
    with torch.cuda.device(h.device):
        cuda_lib.check(cuda_lib.library().lift_splat_bwd_launch(
            g.data_ptr(), h.data_ptr(), ctx.data_ptr(), cl.data_ptr(),
            d_height.data_ptr(), d_ctx.data_ptr(),
            None if served is None else served.data_ptr(), batch, num_cells,
            n, j, hw, feat_w or 0, c, ctypes.byref(launched),
            torch.cuda.current_stream(h.device).cuda_stream), "lift_splat_bwd_launch")
    lift_splat_backward.launches += launched.value
    return d_height, d_ctx


def backward_plan(j: int, c: int) -> dict:
    """K2b's tile for J bins and C channels, from the kernel: 'tile' (TH,
    TW) pixels a block, 'rows' of g it can stage, 'smem' bytes a block,
    'blocks_per_sm'."""
    out = (ctypes.c_int * 5)()
    cuda_lib.check(cuda_lib.library().lift_splat_bwd_plan(j, c, out),
                   "lift_splat_bwd_plan")
    return {"tile": (out[0], out[1]), "rows": out[2], "smem": out[3],
            "blocks_per_sm": out[4]}


class LiftSplat(torch.autograd.Function):
    """`lift_splat_forward` with `lift_splat_backward` as its gradient:
    (height (N, J, HW), context (N, HW, C), cells, batch, num_cells,
    feat_w=None) -> (B, num_cells, C); `feat_w` (the feature map's width,
    or None) goes to the backward's tiling. Gradients reach height and
    context; the other arguments get none."""

    @staticmethod
    def forward(ctx, height, context, cells, batch: int, num_cells: int,
                feat_w: int | None = None):
        ctx.save_for_backward(height, context, cells)
        ctx.batch, ctx.num_cells, ctx.feat_w = batch, num_cells, feat_w
        return lift_splat_forward(height, context, cells, batch, num_cells)

    @staticmethod
    def backward(ctx, grad):
        height, context, cells = ctx.saved_tensors
        d_height, d_ctx = lift_splat_backward(grad.contiguous(), height, context,
                                              cells, ctx.batch, ctx.num_cells,
                                              ctx.feat_w)
        return d_height, d_ctx, None, None, None, None


class TopkCells(torch.autograd.Function):
    """The top-k training lift's pick: (height_hwd (N, HW, D) float32,
    cell_hwd (N, HW, D) int32, k) -> (vals (N, k, HW), cells (N, k, HW)),
    by `topk_with_cells` with its bins (K1 on the card, the stable sort on
    the CPU). The backward puts each pick's gradient on the bin it came
    from, as `lax.top_k`'s gradient does: bins not picked get exactly zero
    (the documented approximation of `train_lift_top_k`); ties went to the
    lowest bin in the forward, so that bin takes the gradient. The cells
    get none."""

    @staticmethod
    def forward(ctx, height_hwd, cell_hwd, k: int):
        vals, cells, bins = topk_with_cells(height_hwd, cell_hwd, k,
                                            return_bins=True)
        ctx.save_for_backward(bins)
        ctx.d = height_hwd.shape[-1]
        ctx.mark_non_differentiable(cells)
        return vals, cells

    @staticmethod
    def backward(ctx, d_vals, _d_cells):
        (bins,) = ctx.saved_tensors
        n, _, hw = bins.shape
        d_height = d_vals.new_zeros(n, hw, ctx.d)
        d_height.scatter_(-1, bins.transpose(1, 2).long(), d_vals.transpose(1, 2))
        return d_height, None, None


lift_splat_forward.launches = 0
lift_splat_prep.launches = 0
lift_splat_backward.launches = 0
