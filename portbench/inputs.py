"""The benchmark's inputs, made from `--seed`: roadside rigs (one synthetic
calibration a camera, in the ranges of a pole-mounted camera 7 m up, pitched
12 degrees down, f = 2100 px at 1920x1080, resized to the exp's input) and
a pool of uniform-noise uint8 frames drawn on the device and held in
pinned host memory, laid out as whole batches.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(axis_angle))
    if theta < 1e-12:
        return np.eye(3)
    k = axis_angle / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + math.sin(theta) * K + (1.0 - math.cos(theta)) * (K @ K)


def ground_plane(ego2cam: np.ndarray) -> np.ndarray:
    """The ego ground plane z = 0 in camera coordinates, negated (the
    DAIR-V2X / Rope3D `denorm` convention)."""
    pts = (ego2cam @ np.array([[0.0, 0, 0, 1], [0, 1, 0, 1], [1, 1, 0, 1]]).T).T
    normal = np.cross(pts[1, :3] - pts[0, :3], pts[2, :3] - pts[0, :3])
    return -np.array([*normal, -np.dot(normal, pts[0, :3])])


def sensor2virtual(denorm: np.ndarray) -> np.ndarray:
    """The rotation taking the (negated) ground normal onto camera +y."""
    origin = np.array([0.0, 1.0, 0.0])
    target = -denorm[:3] / np.linalg.norm(denorm[:3])
    theta = math.acos(float(np.clip(np.inner(target, origin), -1.0, 1.0)))
    n = np.cross(target, origin)
    out = np.eye(4, dtype=np.float32)
    if np.linalg.norm(n) < 1e-12:
        return out
    out[:3, :3] = rodrigues(n / np.linalg.norm(n) * theta)
    return out


def calibration(rng: np.random.Generator, final_dim, orig_hw=(1080, 1920)) -> dict:
    """One camera's matrices, as the served model takes them."""
    pitch = np.deg2rad(12.0 + rng.normal(0, 1.0))
    cam2ego = np.eye(4, dtype=np.float32)
    cam2ego[:3, :3] = (np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
                       @ rodrigues(np.array([pitch, 0, 0])).T)
    cam2ego[:3, 3] = [0, 0, 7.0 + rng.normal(0, 0.2)]
    denorm = ground_plane(np.linalg.inv(cam2ego.astype(np.float64)))
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 2100.0 + rng.normal(0, 50)
    K[0, 2], K[1, 2] = orig_hw[1] / 2, orig_hw[0] / 2
    resize = final_dim[1] / orig_hw[1]
    ida = np.eye(4, dtype=np.float32)
    ida[0, 0] = ida[1, 1] = resize
    ida[1, 3] = -(int(orig_hw[0] * resize) - final_dim[0])        # bottom crop
    ref_h = abs(denorm[3]) / np.linalg.norm(denorm[:3])
    return {"sensor2ego_mats": cam2ego, "sensor2virtual_mats": sensor2virtual(denorm),
            "intrin_mats": K, "ida_mats": ida,
            "sensor2sensor_mats": np.eye(4, dtype=np.float32),
            "reference_heights": np.float32(ref_h),
            "bda_mat": np.eye(4, dtype=np.float32)}


def rigs(seed: int, cameras: int, final_dim) -> list[dict]:
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
    return [calibration(rng, final_dim) for _ in range(cameras)]


def batch_mats(cams: list[dict]) -> dict:
    """The served model's mats for a batch of single-camera frames:
    (B, 1, 1, 4, 4) matrices, (B, 1, 1) heights, (B, 4, 4) bda."""
    out = {}
    for k in cams[0]:
        a = np.stack([c[k] for c in cams])
        out[k] = a if k == "bda_mat" else a[:, None, None]
    return out


def frame_pool(seed: int, batches: int, batch: int, final_dim,
               device: torch.device) -> torch.Tensor:
    """(batches, batch, 1, 1, H, W, 3) uint8 noise frames in pinned host
    memory (on the CPU: plain memory), drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 17) % (1 << 63))
    shape = (batches, batch, 1, 1, *final_dim, 3)
    frames = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=device)
    if device.type != "cuda":
        return frames
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(frames)
    return host
