"""Operations and bytes from shapes, on the plain reference (frozen here,
so that a kernel swapped in the program cannot move the yardstick).

`model_flops`: the forward's FLOPs for one image (`FlopCounterMode` over
the reference's image side and head on the meta device: convolutions,
matrix products and the deformable convolution's contraction; the lift's
gathers and sums count no FLOPs). `lift_bytes`: the least bytes the lift
moves for one batch, each read or written once: the heights and the
context of every pixel (float32), the cell table and the k picked
(height, cell) pairs of every kept pixel, and the BEV map written.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import Detector


def feat_hw(bc: dict) -> tuple[int, int]:
    d = bc["downsample_factor"] // (2 if bc["is_bsm"] else 1)
    return bc["final_dim"][0] // d, bc["final_dim"][1] // d


def lifted_channels(bc: dict) -> int:
    return bc["output_channels"] + (bc["semantic_channels"] if bc["is_bsm"] else 0)


def num_cells(bc: dict) -> int:
    return (int(round((bc["x_bound"][1] - bc["x_bound"][0]) / bc["x_bound"][2]))
            * int(round((bc["y_bound"][1] - bc["y_bound"][0]) / bc["y_bound"][2])))


def model_flops(cfg: dict) -> int:
    bc = cfg["backbone"]
    with torch.device("meta"):
        model = Detector(cfg).eval()
        x = torch.empty(1, 3, *bc["final_dim"])
        cam = torch.empty(1, 27)
        nx = int(round((bc["x_bound"][1] - bc["x_bound"][0]) / bc["x_bound"][2]))
        bev = torch.empty(1, num_cells(bc) // nx, nx, lifted_channels(bc))
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model.backbone.image_side(x, cam)
            model.head(bev)
    return int(counter.get_total_flops())


def lift_bytes(cfg: dict, batch: int, kept_pixels: int) -> int:
    bc = cfg["backbone"]
    h, w = feat_hw(bc)
    d, k = int(bc["d_bound"][2]), bc["lift_top_k"] or int(bc["d_bound"][2])
    c = lifted_channels(bc)
    per_frame = 4 * (h * w * (d + c) + kept_pixels * (d + 2 * k))
    return batch * (per_frame + 4 * num_cells(bc) * c)
