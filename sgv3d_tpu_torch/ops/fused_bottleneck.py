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


@dataclasses.dataclass(frozen=True)
class FoldedBottleneck:
    """One identity bottleneck with inference BatchNorm folded in, in the
    kernel's layout (output channel major, input channel contiguous):
    w1 (P, C), w2 (P, 9 * P) with the taps in (dy, dx) row-major order and
    input channels fastest, w3 (C, P), all bf16; b1, b2 (P,), b3 (C,)
    float32. C = 4P."""
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
            w1=w1.reshape(p, -1).to(torch.bfloat16).contiguous(),
            b1=b1.contiguous(),
            w2=w2.permute(0, 2, 3, 1).reshape(p, 9 * p).to(torch.bfloat16)
            .contiguous(),
            b2=b2.contiguous(),
            w3=w3.reshape(-1, p).to(torch.bfloat16).contiguous(),
            b3=b3.contiguous())


def fused_bottleneck_plain(x: torch.Tensor, fb: FoldedBottleneck) -> torch.Tensor:
    """Three float32 convs on the bf16 values, rounding y1 and y2 to bf16,
    the residual added in float32, the output rounded to bf16."""
    p, c = fb.w1.shape
    xf = x.permute(0, 3, 1, 2).float()
    y1 = F.relu(F.conv2d(xf, fb.w1.float().reshape(p, c, 1, 1), fb.b1))
    y1 = y1.to(torch.bfloat16).float()
    w2 = fb.w2.float().reshape(p, 3, 3, p).permute(0, 3, 1, 2)
    y2 = F.relu(F.conv2d(y1, w2, fb.b2, padding=1)).to(torch.bfloat16).float()
    y3 = F.conv2d(y2, fb.w3.float().reshape(c, p, 1, 1), fb.b3)
    return F.relu(y3 + xf).to(torch.bfloat16).permute(0, 2, 3, 1)


def tile_shape(p: int) -> tuple[int, int]:
    """The kernel's output tile (TH, TW): 8x16 for the narrow first stage,
    8x8 above it, so that the y1 halo and y2 fit in shared memory."""
    return (8, 16) if p <= 64 else (8, 8)


def smem_bytes(p: int) -> int:
    """Shared memory of one block: the bf16 y1 halo tile, then one buffer
    that holds the staged x chunk (phase 1) and later y2, rows padded to
    32 and each row padded by 8 elements against bank conflicts."""
    th, tw = tile_shape(p)
    halo = -(-(th + 2) * (tw + 2) // 32) * 32
    y1 = halo * (p + 8) * 2
    return y1 + max(halo * (64 + 8) * 2, th * tw * (p + 8) * 2)


def fused_bottleneck(x: torch.Tensor, fb: FoldedBottleneck) -> torch.Tensor:
    """x (B, H, W, C) bf16 -> (B, H, W, C) bf16, one identity bottleneck.
    On CUDA, x must be contiguous NHWC (a channels_last NCHW tensor
    permuted to NHWC is), C = 4P with P a multiple of 32."""
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
    if (x.dim() != 4 or x.shape[-1] != c or c != 4 * p or p % 32
            or fb.w2.shape != (p, 9 * p) or fb.w3.shape != (c, p)
            or fb.b1.shape != (p,) or fb.b2.shape != (p,) or fb.b3.shape != (c,)):
        raise ValueError(f"fused_bottleneck: x {tuple(x.shape)} with w1 "
                         f"{tuple(fb.w1.shape)}, w2 {tuple(fb.w2.shape)}, w3 "
                         f"{tuple(fb.w3.shape)}; need (B, H, W, 4P), P % 32 == 0")
    if not x.is_contiguous() or x.data_ptr() % 16 or not all(
            t.is_contiguous() for t in fb.tensors()):
        raise ValueError("fused_bottleneck: x (NHWC, 16-byte aligned) and the "
                         "folded weights must be contiguous")
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
