"""The reference's precisions. `configured`: what the configuration states
(the image side in bfloat16, its camera MLPs and the deformable
convolution's sampling in float32; the rest float32, TF32 off).
`lowered`, the control: one step below, the image side as configured but
every tensor its convolutions read or write (input, weight, output) in
float8 e4m3 under a per-tensor scale of amax / 448, and the head (float32
with TF32 off) with TF32 on."""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from portbench.reference.model import DeformConv

E4M3_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in its dtype."""
    scale = x.abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)


def _fp8_layers(image_side: nn.Module):
    """The image side's convolutions (its MLPs are `nn.Linear`, left out)."""
    return [m for m in image_side.modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DeformConv))]


@contextlib.contextmanager
def lowered(model: nn.Module):
    """Within the block, `model` (a reference `Detector`) computes at the
    control's precision; its weights are restored on exit."""
    saved, handles = [], []
    with torch.no_grad():
        for m in _fp8_layers(model.backbone):
            saved.append((m.weight, m.weight.detach().clone()))
            m.weight.copy_(to_fp8(m.weight))
            handles += [m.register_forward_pre_hook(
                            lambda _m, args: (to_fp8(args[0]),) + tuple(args[1:])),
                        m.register_forward_hook(lambda _m, _args, out: to_fp8(out))]
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def tf32(on):
        def hook(*_):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
        return hook

    handles += [model.head.register_forward_pre_hook(tf32(True)),
                model.head.register_forward_hook(tf32(False))]
    try:
        with configured(model):
            yield model
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for w, orig in saved:
                w.copy_(orig)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@contextlib.contextmanager
def configured(model: nn.Module):
    """Within the block, `model` computes at the configuration's own
    precision: the image side under bfloat16 autocast, its camera MLPs and
    the deformable convolution's sampling and contraction in float32 (on
    bfloat16 inputs); the rest float32 with TF32 off."""
    from portbench.reference.model import Mlp

    handles, exits = [], []
    dev = next(model.parameters()).device.type

    def enter(_m, args):
        ctx = torch.autocast(dev, enabled=False)
        ctx.__enter__()
        exits.append(ctx)
        return tuple(a.float() if torch.is_tensor(a) else a for a in args)

    def leave(*_):
        exits.pop().__exit__(None, None, None)

    for m in model.backbone.modules():
        if isinstance(m, (Mlp, DeformConv)):
            handles += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    def bf16(_m, _args):
        ctx = torch.autocast(dev, dtype=torch.bfloat16)
        ctx.__enter__()
        exits.append(ctx)

    for name, m in model.backbone.named_children():
        if name != "assist_layer":
            handles += [m.register_forward_pre_hook(bf16), m.register_forward_hook(leave)]
    try:
        yield model
    finally:
        for h in handles:
            h.remove()
