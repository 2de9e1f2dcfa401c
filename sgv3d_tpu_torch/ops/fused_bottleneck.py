"""Fused identity-bottleneck block (kernel K3), inference only.

Port of the TPU kernel `sgv3d_tpu.ops.pallas_bottleneck`
(`fused_bottleneck_stack`, body `_kernel`, with `fold_bottleneck_params`):
one stride-1 identity bottleneck of a ResNet stage, 1x1 -> 3x3 -> 1x1 with
BatchNorm folded into the convs, ReLUs and the residual add, in one launch
that reads the input once and writes the output once.

Rounding points, as in the TPU kernel: y1 = relu(x.w1 + b1) and
y2 = relu(conv3x3(y1, w2) + b2) are rounded to bf16; the output
relu(y2.w3 + b3 + x) is summed in float32 and rounded to bf16. conv2's zero
padding lives in y1-space: y1 is exactly zero outside the image.

On a CUDA tensor `fused_bottleneck` launches `csrc/fused_bottleneck.cu`; on
a CPU tensor it runs `fused_bottleneck_plain`. There is no fallback from one
to the other.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from sgv3d_tpu_torch.ops import cuda_lib

SMEM_LIMIT = 232448     # bytes of shared memory a block may use on sm_90
KERNEL_P = (64, 128, 256, 512)   # the widths the kernel is built for
RING_K = 64             # K elements of a ring stage


def ring_stages(p: int) -> int:
    """Stages of the kernel's ring at width P, as timed on an H100: two at
    P <= 128, where two blocks then share an SM, four at P = 256, and at
    P = 512 the three that fit beside y1 and y2."""
    return {64: 2, 128: 2, 256: 4}.get(p, 3)


def ring_tile(p: int) -> tuple[int, int]:
    """(NB, KC) of the weight ring at width P: a stage holds NB output
    channels by KC input channels (NB = min(P, 128), KC = min(P, 64), so
    any power-of-two P >= 8 packs; the kernel runs P >= 64)."""
    return min(p, 128), min(p, RING_K)


def _swizzled(t: torch.Tensor) -> torch.Tensor:
    """(..., nb, g, 8) -> the same with group j of row n taken from group
    j ^ (n % g); its own inverse."""
    nb, g = t.shape[-3], t.shape[-2]
    if g & (g - 1):
        raise ValueError(f"ring stage of {g} 16-byte groups; need a power of 2")
    rows = torch.arange(nb, device=t.device)[:, None]
    groups = torch.arange(g, device=t.device)[None, :]
    return t[..., rows, groups ^ (rows % g), :]


def pack_weight(w: torch.Tensor, p: int) -> torch.Tensor:
    """A folded (N, K) weight, output channel major, -> the same shape in
    the ring's order: (N / NB, K / KC) tiles, output tile major, each tile
    NB rows of KC with the 16-byte group j of row n stored at j ^ (n % g)
    (g = KC / 8 groups): at KC = 64, wgmma's K-major layout with the
    128-byte swizzle, so a ring stage is one contiguous copy."""
    nb, kc = ring_tile(p)
    n, k = w.shape
    t = w.reshape(n // nb, nb, k // kc, kc // 8, 8).permute(0, 2, 1, 3, 4)
    return _swizzled(t).reshape(n, k).contiguous()


def unpack_weight(w: torch.Tensor, p: int) -> torch.Tensor:
    """The inverse of `pack_weight`."""
    nb, kc = ring_tile(p)
    n, k = w.shape
    t = _swizzled(w.reshape(n // nb, k // kc, nb, kc // 8, 8))
    return t.permute(0, 2, 1, 3, 4).reshape(n, k)


@dataclasses.dataclass(frozen=True)
class FoldedBottleneck:
    """One identity bottleneck with inference BatchNorm folded in. The
    matrices (output channel major, input channel contiguous) are w1 (P, C),
    w2 (P, 9 * P) with the taps in (dy, dx) row-major order and input
    channels fastest, w3 (C, P), all bf16, each stored in the kernel's ring
    order (`pack_weight`; `unpack_weight` gives the matrix back); b1, b2
    (P,), b3 (C,) float32. C = 4P."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.w1, self.b1, self.w2, self.b2, self.w3, self.b3)


def fold_bottleneck(block, eps: float = 1e-5) -> FoldedBottleneck:
    """Fold a `nn.resnet.Bottleneck`'s eval BatchNorms into its convs:
    k = gamma / sqrt(var + eps) in float32, weights scaled by k and cast to
    bf16, biases beta - mean * k kept float32 (`fold_bottleneck_params`)."""
    if block.project:
        raise ValueError("fold_bottleneck: a projection block does not fuse")

    def fold(conv, bn):
        k = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
        w = conv.weight.float() * k[:, None, None, None]
        return w, bn.bias.float() - bn.running_mean.float() * k

    with torch.no_grad():
        w1, b1 = fold(block.conv1, block.bn1)
        w2, b2 = fold(block.conv2, block.bn2)
        w3, b3 = fold(block.conv3, block.bn3)
        p = w1.shape[0]
        return FoldedBottleneck(
            w1=pack_weight(w1.reshape(p, -1).to(torch.bfloat16), p),
            b1=b1.contiguous(),
            w2=pack_weight(w2.permute(0, 2, 3, 1).reshape(p, 9 * p)
                           .to(torch.bfloat16), p),
            b2=b2.contiguous(),
            w3=pack_weight(w3.reshape(-1, p).to(torch.bfloat16), p),
            b3=b3.contiguous())


def fused_bottleneck_plain(x: torch.Tensor, fb: FoldedBottleneck) -> torch.Tensor:
    """Three float32 convs on the bf16 values, rounding y1 and y2 to bf16,
    the residual added in float32, the output rounded to bf16."""
    p, c = fb.w1.shape
    w1, w2, w3 = (unpack_weight(w, p).float() for w in (fb.w1, fb.w2, fb.w3))
    xf = x.permute(0, 3, 1, 2).float()
    y1 = F.relu(F.conv2d(xf, w1.reshape(p, c, 1, 1), fb.b1))
    y1 = y1.to(torch.bfloat16).float()
    w2 = w2.reshape(p, 3, 3, p).permute(0, 3, 1, 2)
    y2 = F.relu(F.conv2d(y1, w2, fb.b2, padding=1)).to(torch.bfloat16).float()
    y3 = F.conv2d(y2, w3.reshape(c, p, 1, 1), fb.b3)
    return F.relu(y3 + xf).to(torch.bfloat16).permute(0, 2, 3, 1)


def tile_shape(p: int) -> tuple[int, int]:
    """The kernel's output tile (TH, TW), as timed on an H100: 8x16 at
    P = 64, 8x8 above it (more blocks in flight; at P = 512 a 16-wide
    tile's y1 halo alone would not fit)."""
    return (8, 16) if p <= 64 else (8, 8)


def smem_bytes(p: int, tile: tuple[int, int] | None = None,
               stages: int | None = None) -> int:
    """Shared memory of one block, as the kernel lays it out for width P
    (with its own tile and ring depth unless given): 1024 bytes to align
    what follows; the ring's weight stages; one area that holds the ring's
    x stages in phase 1 (the halo rows, 128 bytes each, a stage rounded to
    1024 bytes, and room for the reads of the halo's padding to a multiple
    of 64 rows) and y2 after; the bf16 y1 halo tile (phase 3's residual
    and output box after); two mbarriers a stage and one for that box.
    Rows of y1 and y2 are padded by 8 elements against bank conflicts."""
    th, tw = tile or tile_shape(p)
    nb, kc = ring_tile(p)
    stages = stages or ring_stages(p)
    halo = (th + 2) * (tw + 2)
    m1 = -(-halo // 64) * 64
    x_stage = -(-halo * kc * 2 // 1024) * 1024
    area = max(stages * x_stage + (m1 - halo) * kc * 2, th * tw * (p + 8) * 2)
    y1 = halo * (p + 8) * 2
    return 1024 + area + y1 + stages * (nb * kc * 2 + 16) + 8


def fused_bottleneck(x: torch.Tensor, fb: FoldedBottleneck) -> torch.Tensor:
    """x (B, H, W, C) bf16 -> (B, H, W, C) bf16, one identity bottleneck.
    On CUDA, x must be contiguous NHWC (a channels_last NCHW tensor
    permuted to NHWC is), C = 4P with P one of `KERNEL_P`."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, fb)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in fb.tensors()):
        raise ValueError(f"fused_bottleneck: x on {dev} and weights on "
                         f"{[str(t.device) for t in fb.tensors()]}")
    if x.dtype != torch.bfloat16 or fb.w1.dtype != torch.bfloat16 \
            or fb.b1.dtype != torch.float32:
        raise TypeError(f"fused_bottleneck: need bf16 x and weights, float32 "
                        f"biases; got {x.dtype}, {fb.w1.dtype}, {fb.b1.dtype}")
    p, c = fb.w1.shape
    if (x.dim() != 4 or x.shape[-1] != c or c != 4 * p or p not in KERNEL_P
            or fb.w2.shape != (p, 9 * p) or fb.w3.shape != (c, p)
            or fb.b1.shape != (p,) or fb.b2.shape != (p,) or fb.b3.shape != (c,)):
        raise ValueError(f"fused_bottleneck: x {tuple(x.shape)} with w1 "
                         f"{tuple(fb.w1.shape)}, w2 {tuple(fb.w2.shape)}, w3 "
                         f"{tuple(fb.w3.shape)}; need (B, H, W, 4P), P in {KERNEL_P}")
    if not x.is_contiguous() or any(t.data_ptr() % 16 for t in (
            x, fb.w1, fb.w2, fb.w3)) or not all(
            t.is_contiguous() for t in fb.tensors()):
        raise ValueError("fused_bottleneck: x (NHWC) and the folded weights "
                         "must be contiguous and 16-byte aligned")
    smem = smem_bytes(p)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_bottleneck: P={p} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    b, h, w, _ = x.shape
    th, tw = tile_shape(p)
    out = torch.empty_like(x)
    err = cuda_lib.library().fused_bottleneck_launch(
        x.data_ptr(), fb.w1.data_ptr(), fb.b1.data_ptr(), fb.w2.data_ptr(),
        fb.b2.data_ptr(), fb.w3.data_ptr(), fb.b3.data_ptr(), out.data_ptr(),
        b, h, w, p, th, tw, smem, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "fused_bottleneck_launch")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
