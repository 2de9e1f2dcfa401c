"""Bilinear resize with both torch alignment conventions (torch port of
`sgv3d_tpu.ops.resize`), NHWC (or HWC) at the public function.

`align_corners=False` is `jax.image.resize(..., "bilinear")`: half-pixel
centred bilinear, which for upsampling (the BSM head's x2) is
`F.interpolate(align_corners=False)`, edge rows included, and which widens
its kernel when downsampling, as `F.interpolate(antialias=True)` does
(tests/test_torch_bsm.py pins both). `align_corners=True` is two separable
corner-aligned interpolation matmuls in float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) corner-aligned linear interpolation matrix."""
    a = np.zeros((dst, src), np.float32)
    if dst == 1 or src == 1:
        a[:, 0] = 1.0
        return a
    pos = np.arange(dst) * (src - 1) / (dst - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = (pos - lo).astype(np.float32)
    a[np.arange(dst), lo] += 1.0 - frac
    a[np.arange(dst), hi] += frac
    return a


def resize_bilinear(x: torch.Tensor, scale: float | None = None,
                    size: tuple[int, int] | None = None,
                    align_corners: bool = False) -> torch.Tensor:
    """Resize x (..., H, W, C) bilinearly to `size` or by `scale`."""
    h, w = x.shape[-3], x.shape[-2]
    if size is None:
        if scale is None:
            raise ValueError("resize_bilinear: give scale or size")
        size = (int(h * scale), int(w * scale))
    out_h, out_w = size
    if (out_h, out_w) == (h, w):
        return x
    if not align_corners:
        lead = x.shape[:-3]
        x4 = x.reshape(-1, h, w, x.shape[-1]).permute(0, 3, 1, 2)
        y = F.interpolate(x4, size=(out_h, out_w), mode="bilinear",
                          align_corners=False,
                          antialias=out_h < h or out_w < w)
        return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, x.shape[-1])
    ah = torch.from_numpy(_interp_matrix(h, out_h)).to(x.device)
    aw = torch.from_numpy(_interp_matrix(w, out_w)).to(x.device)
    out = torch.einsum("oh,...hwc->...owc", ah, x.float())
    out = torch.einsum("pw,...owc->...opc", aw, out)
    return out.to(x.dtype)
