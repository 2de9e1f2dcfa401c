"""User-facing inference API (torch port of `sgv3d_tpu.api`).

`BEVHeightPredictor` takes NCHW or NHWC images and a dict of 4x4 mats, and
returns per-sample numpy [boxes (M, 9), scores (M,), labels (M,)].
"""
from __future__ import annotations

from typing import Iterable, List, Mapping

import numpy as np
import torch

from sgv3d_tpu_torch.config import ExpConfig
from sgv3d_tpu_torch.decode import Detections, decode
from sgv3d_tpu_torch.models.bev_height import BEVHeight
from sgv3d_tpu_torch.nn.lss_fpn import compute_lift_cells, compute_valid_pixels
from sgv3d_tpu_torch.ops.voxel_pooling import apply_pixel_cull, cull_pixel_indices

_RIG_KEYS = ("sensor2ego_mats", "sensor2virtual_mats", "intrin_mats",
             "ida_mats", "reference_heights", "bda_mat")


class BEVHeightPredictor:
    """End-to-end inference: images + calib -> 3D boxes.

    `static_rig` (default True) caches the lift cells per calibration, keyed
    on the host calibration bytes, so a fixed roadside rig skips the
    geometry on every frame after its first. `cull_pixels` (default: on when
    the rig is static and the lift is top-k) drops, once per rig, the pixels
    whose whole height ray misses the BEV grid. `use_bf16` runs the image
    backbone, neck and HeightNet (MSCThead) in bf16 on CUDA; everything else
    is float32 with TF32 off. `fused_convs` (opt-in, as in the JAX package)
    runs the image ResNet's identity bottlenecks through the fused kernel
    K3; it needs the bf16 image side on CUDA and a ResNet of depth >= 50,
    and raises `ValueError` where it cannot be honoured.
    """

    def __init__(self, cfg: ExpConfig, state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda", use_bf16: bool = True,
                 static_rig: bool = True, cull_pixels: bool | None = None,
                 fused_convs: bool = False):
        if cull_pixels is None:
            cull_pixels = static_rig and cfg.backbone.lift_top_k is not None
        elif cull_pixels and (not static_rig or cfg.backbone.lift_top_k is None):
            raise ValueError("cull_pixels=True requires static_rig=True and a "
                             "top-k lift (cfg.backbone.lift_top_k)")
        self.cfg = cfg
        self.static_rig = static_rig
        self.cull_pixels = cull_pixels
        self.device = torch.device(device)
        on_cuda = self.device.type == "cuda"
        use_bf16 = use_bf16 and on_cuda
        if fused_convs and (not use_bf16 or cfg.backbone.resnet_depth < 50):
            raise ValueError(
                f"fused_convs=True requires the bf16 image side on CUDA and a "
                f"ResNet of depth >= 50; got device {self.device}, use_bf16="
                f"{use_bf16}, depth {cfg.backbone.resnet_depth}")
        # cuDNN's float32 convs default to TF32; the geometry and the head
        # must keep float32's digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = BEVHeight(cfg, use_bf16=use_bf16, fused_convs=fused_convs)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        if on_cuda:     # the bf16 image side; the fp32 head stays NCHW
            self.model.backbone.to(memory_format=torch.channels_last)
        if fused_convs:     # once per predictor, on the device
            self.model.backbone.img_backbone.fold()
        grid = cfg.backbone.voxel_grid
        self._num_cells = int(grid.voxel_num[0]) * int(grid.voxel_num[1])
        self._cells = None          # (cells, pix_keep or None) once cached
        self._cells_key = None
        self._copy_stream = torch.cuda.Stream(self.device) if on_cuda else None

    def _rig_cells(self, host_mats, mats):
        """Cached lift cells (and cull), recomputed when the calibration
        bytes change. The cull's validity mask is computed on the host CPU
        from the host mats, once per rig."""
        key = tuple((k, np.asarray(host_mats[k]).tobytes())
                    for k in _RIG_KEYS if k in host_mats)
        if key != self._cells_key:
            cells = compute_lift_cells(self.cfg.backbone, mats)
            pix = None
            if self.cull_pixels:
                cpu_mats = {k: torch.from_numpy(np.asarray(v, np.float32))
                            for k, v in host_mats.items()}
                valid = compute_valid_pixels(self.cfg.backbone, cpu_mats).any(0)
                out = cull_pixel_indices(valid.numpy())
                if out is not None:
                    pix_np, n_valid = out
                    pix = torch.from_numpy(pix_np).to(self.device)
                    cells = apply_pixel_cull(cells, pix, n_valid, self._num_cells)
            self._cells = (cells, pix)
            self._cells_key = key
        return self._cells

    def _upload(self, arr) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        copy from pageable memory would synchronise the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _inputs(self, sweep_imgs, mats_dict):
        imgs = np.asarray(sweep_imgs)
        if imgs.shape[3] == 3 and imgs.shape[-1] != 3:
            imgs = np.transpose(imgs, (0, 1, 2, 4, 5, 3))        # NCHW -> NHWC
        imgs = self._upload(imgs)
        mats = {k: self._upload(v) for k, v in mats_dict.items()}
        cells, pix = (self._rig_cells(mats_dict, mats) if self.static_rig
                      else (None, None))
        return imgs, mats, cells, pix

    @torch.inference_mode()
    def predict_heads(self, sweep_imgs, mats_dict) -> list:
        """The head's per-task dict of (B, H, W, c) tensors, before decode."""
        imgs, mats, cells, pix = self._inputs(sweep_imgs, mats_dict)
        return self.model(imgs, mats, cells, pix)[0]

    @torch.inference_mode()
    def _dispatch(self, sweep_imgs, mats_dict) -> Detections:
        """Enqueue one batch on the device; returns its detections."""
        imgs, mats, cells, pix = self._inputs(sweep_imgs, mats_dict)
        return decode(self.cfg.head, self.model(imgs, mats, cells, pix)[0])

    @staticmethod
    def _collect(dets: Detections) -> List[list]:
        boxes, scores, labels, valid = (t.cpu().numpy() for t in dets)
        return [[boxes[i][valid[i]], scores[i][valid[i]], labels[i][valid[i]]]
                for i in range(boxes.shape[0])]

    def __call__(self, sweep_imgs, mats_dict) -> List[list]:
        """sweep_imgs: (B, S, N, 3, H, W) NCHW or (B, S, N, H, W, 3) NHWC,
        normalised float32 or raw uint8. Returns per-sample
        [boxes (M, 9), scores (M,), labels (M,)] numpy arrays."""
        return self._collect(self._dispatch(sweep_imgs, mats_dict))

    @torch.inference_mode()
    def _start_copy(self, dets: Detections):
        """Copy one batch's detections to pinned host buffers on a side
        stream, after the compute that made them; returns (host, event)."""
        compute = torch.cuda.current_stream(self.device)
        self._copy_stream.wait_stream(compute)
        with torch.cuda.stream(self._copy_stream):
            host = []
            for t in dets:
                t.record_stream(self._copy_stream)
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return Detections(*host), done

    def stream(self, batches: Iterable) -> Iterable[List[list]]:
        """Pipelined serving over (sweep_imgs, mats_dict) batches: batch i is
        enqueued before batch i-1's results are read, and the device-to-host
        copy of i-1 runs on a side stream while i computes. Yields the same
        per-batch results as sequential `__call__`s."""
        if self.device.type != "cuda":
            for batch in batches:
                yield self(*batch)
            return
        pending = None
        for batch in batches:
            current = self._start_copy(self._dispatch(*batch))
            if pending is not None:
                yield self._wait_collect(*pending)
            pending = current
        if pending is not None:
            yield self._wait_collect(*pending)

    def _wait_collect(self, host: Detections, done) -> List[list]:
        done.synchronize()
        return self._collect(host)
