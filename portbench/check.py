"""The reference's side of `correct`: after the window, the plain reference
(float32, TF32 off) runs over a sample of the frames the window served,
in blocks, on the seeded weights drawn again, and each frame's served
detections are judged by `compare`. Also the lift's byte count, which
needs the rig's kept pixels, is worked out here from the reference's own
geometry."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import compare, weights
from portbench.flops import feat_hw
from portbench.reference.decode import decode_frame
from portbench.reference.model import Detector, lift_cells
from portbench.reference.precision import configured

BLOCK = 4   # frames a reference call


@contextlib.contextmanager
def full_float32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_model(cfg: dict, seed: int, device: torch.device) -> Detector:
    """The reference on the seeded weights (the same draw the program got)."""
    with torch.device("meta"):
        model = Detector(cfg)
    drawn = weights.draw(weights.names_shapes(model), seed, device)
    model.load_state_dict(drawn, strict=True, assign=True)
    return model.eval()


def frame_mats(rig: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in rig.items()}


def stack_mats(mats: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in mats]) for k in mats[0]}


@torch.inference_mode()
def reference_outputs(model: Detector, frames: list, rigs: list,
                      device: torch.device) -> list:
    """The dense head outputs of each frame (a list over tasks of dicts of
    (h, w, c) tensors), `BLOCK` frames a call."""
    out = []
    with full_float32():
        for s in range(0, len(frames), BLOCK):
            imgs = torch.stack([torch.as_tensor(f).to(device) for f in frames[s:s + BLOCK]])
            mats = stack_mats([frame_mats(r, device) for r in rigs[s:s + BLOCK]])
            preds = model(imgs, mats)
            out += [[{k: v[i] for k, v in task.items()} for task in preds]
                    for i in range(imgs.shape[0])]
    return out


def judge_sample(cfg: dict, model: Detector, frames: list, rigs: list, served: list,
                 device: torch.device) -> dict:
    """`compare`'s numbers over the sample: frames (H, W, 3) uint8, their
    rigs, and the served (boxes, scores, labels) of each; the reference
    runs in float32 and at the configuration's own precision."""
    hc = cfg["head"]
    per, own = [], []
    for s in range(0, len(frames), BLOCK):
        block = frames[s:s + BLOCK], rigs[s:s + BLOCK], device
        refs = reference_outputs(model, *block)
        with configured(model):
            mine = [decode_frame(hc, p) for p in reference_outputs(model, *block)]
        per += [compare.frame_numbers(hc, sv, ref) for sv, ref in zip(served[s:s + BLOCK], refs)]
        own += [compare.frame_numbers(hc, sv, ref) for sv, ref in zip(mine, refs)]
    return compare.combine(per, own)


@torch.inference_mode()
def kept_pixels(cfg: dict, rigs: list, device: torch.device) -> int:
    """Pixels of the lift's map with an in-grid cell in some camera of
    the rig: what the served lift has to touch."""
    bc = cfg["backbone"]
    hw = feat_hw(bc)
    any_ok = None
    for r in rigs:
        ok = (lift_cells(bc, stack_mats([frame_mats(r, device)]), hw) >= 0).any(-1)[0]
        any_ok = ok if any_ok is None else any_ok | ok
    return int(any_ok.sum())
