"""Seeded weights for both sides, drawn on the device in two calls.

The names and shapes are the plain reference's `state_dict` (built on the
meta device), which are the served model's. The draw is the serving point
at which the image side in bfloat16 stays well conditioned at 864x1536
(kernels N(0, 0.9^2 / fan_in), biases N(0, 0.1^2), BatchNorm scales
1 + N(0, 0.2^2), running means N(0, 0.3^2), running variances U(0.5, 1.5),
the deformable convolutions' offset convs at about half a pixel,
0.5 / sqrt(fan_in)): one `randn` over every normal leaf and one `rand`
over the variances, from a `torch.Generator` on the device seeded with
`--seed`, then scaled leaf by leaf as views of the two buffers.
"""
from __future__ import annotations

import math

import torch

GAIN = 0.9


def _rule(name: str, shape) -> tuple[str, float, float]:
    """(kind, mean or low, std or high) of one leaf, by its name and shape."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return "uniform", 0.5, 1.5
    if leaf == "running_mean":
        return "normal", 0.0, 0.3
    if leaf == "bias":
        return "normal", 0.0, 0.1
    if len(shape) == 1:                                  # a BatchNorm scale
        return "normal", 1.0, 0.2
    if "deconv" in name:                                # (cin, cout, kh, kw)
        fan = shape[0] * math.prod(shape[2:])
    else:                                                # (cout, cin/g, kh, kw), (out, in)
        fan = math.prod(shape[1:])
    std = (0.5 if "offset_conv" in name else GAIN) / math.sqrt(fan)
    return "normal", 0.0, std


def draw(names_shapes: list[tuple[str, tuple]], seed: int,
         device: torch.device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every (name, shape)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    rules = [(n, s, *_rule(n, s)) for n, s in names_shapes]
    normal = [r for r in rules if r[2] == "normal"]
    uniform = [r for r in rules if r[2] == "uniform"]
    out = {}
    for group, sample in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [math.prod(s) for _, s, *_ in group]
        buf = sample(sum(sizes), generator=gen, device=device)
        for (name, shape, kind, a, b), part in zip(group, torch.split(buf, sizes)):
            out[name] = (part * b + a if kind == "normal" else part * (b - a) + a).view(shape)
    return out


def names_shapes(model: torch.nn.Module) -> list[tuple[str, tuple]]:
    return [(n, tuple(t.shape)) for n, t in model.state_dict().items()]
