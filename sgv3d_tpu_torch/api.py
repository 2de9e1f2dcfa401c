"""User-facing inference API (torch port of `sgv3d_tpu.api`).

`BEVHeightPredictor` takes NCHW or NHWC images and a dict of 4x4 mats, and
returns per-sample numpy [boxes (M, 9), scores (M,), labels (M,)], on one
device or over a mesh of them (`train.sharding.make_mesh`).
"""
from __future__ import annotations

from typing import Iterable, List, Mapping

import numpy as np
import torch

from sgv3d_tpu_torch.config import ExpConfig
from sgv3d_tpu_torch.decode import Detections, decode
from sgv3d_tpu_torch.models.bev_height import BEVHeight
from sgv3d_tpu_torch.nn.bev_slabs import canonical_device
from sgv3d_tpu_torch.nn.lss_fpn import compute_lift_cells, compute_valid_pixels
from sgv3d_tpu_torch.ops.voxel_pooling import apply_pixel_cull, cull_pixel_indices
from sgv3d_tpu_torch.train.profiling import span
from sgv3d_tpu_torch.train.sharding import Mesh
from sgv3d_tpu_torch.utils.pipeline import pipelined

_RIG_KEYS = ("sensor2ego_mats", "sensor2virtual_mats", "intrin_mats",
             "ida_mats", "reference_heights", "bda_mat")


class _Row:
    """One data row of the mesh (without one, the whole batch): the model
    replica that serves it, on the row's first device, its side stream for
    the detections' copy to the host, and its static-rig cell cache with
    its lookups counted (`rig_hits`, `rig_misses`)."""

    def __init__(self, model: BEVHeight, device: torch.device):
        self.model = model
        self.device = device
        self.copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                            else None)
        self.cells = None           # (cells, pix_keep or None) once cached
        self.cells_key = None
        self.rig_hits = 0
        self.rig_misses = 0


class _Handle(list):
    """`submit`'s handle: each row's (detections, copy event or None), and
    the batch's sequence number `seq`."""

    def __init__(self, rows, seq: int):
        super().__init__(rows)
        self.seq = seq


class BEVHeightPredictor:
    """End-to-end inference: images + calib -> 3D boxes.

    `static_rig` (default True) caches the lift cells per calibration, keyed
    on the host calibration bytes, so a fixed roadside rig skips the
    geometry on every frame after its first. `cull_pixels` (default: on when
    the rig is static and the lift is top-k, off under a mesh) drops, once
    per rig, the pixels whose whole height ray misses the BEV grid.
    `use_bf16` runs the image
    backbone, neck and HeightNet (MSCThead) in bf16 on CUDA, `bf16_head`
    (opt-in, a serving approximation beyond the reference, which pins the
    head to float32) the BEV head's convs on CUDA, with float32 outputs;
    everything else is float32 with TF32 off. `fused_convs` (opt-in, as
    in the JAX package) runs the image ResNet's identity bottlenecks
    through the fused kernel K3; it needs the bf16 image side on CUDA and
    a ResNet of depth >= 50, and raises `ValueError` where it cannot be
    honoured.

    `mesh` (`train.sharding.make_mesh`; it takes the place of `device`) serves
    over a (data, bev) grid of devices in this one process, as the JAX
    predictor's mesh does: the batch, whose size must be divisible by the
    mesh's data size, is split over the data rows, one model replica for
    each distinct row (devices may repeat: `["cuda:0"] * 4` is a mesh)
    runs its row's image side and lift on the row's first device, a row of
    two or more devices splits its BEV maps into row slabs over them
    before the head (`models.bev_height.BEVHeight(bev_devices=)`), and the
    detections come back to the host in batch order. Each row keeps its
    own static-rig cache, keyed on its frames' calibration bytes. A mesh
    of one device is the plain path; `cull_pixels=True` under a mesh
    raises `ValueError`.

    Tracing: while a `torch.profiler` runs, each call is a tree of spans
    in its trace (`train.profiling.span`): `sgv3d.submit` (`upload`,
    `rig_cells`, `forward` with the model's `image`, `lift` and `head`,
    `decode` with `decode.rank` and `decode.nms`, `copy`) and
    `sgv3d.fetch` (`fetch.wait`, `collect`); `submit` and `fetch` carry
    the batch's sequence number. `batches` counts the batches submitted.
    """

    def __init__(self, cfg: ExpConfig, state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda", use_bf16: bool = True,
                 static_rig: bool = True, cull_pixels: bool | None = None,
                 fused_convs: bool = False, bf16_head: bool = False,
                 mesh: Mesh | None = None):
        if mesh is not None and mesh.size == 1:     # the plain path
            device, mesh = mesh.grid[0][0], None
        if cull_pixels is None:
            cull_pixels = (static_rig and mesh is None
                           and cfg.backbone.lift_top_k is not None)
        elif cull_pixels:
            if not static_rig or cfg.backbone.lift_top_k is None:
                raise ValueError("cull_pixels=True requires static_rig=True and a "
                                 "top-k lift (cfg.backbone.lift_top_k)")
            if mesh is not None:
                raise ValueError("cull_pixels=True is unsupported under a mesh")
        self.cfg = cfg
        self.static_rig = static_rig
        self.cull_pixels = cull_pixels
        self.mesh = mesh
        if mesh is None:
            self.device = torch.device(device)
            row_devices = [[self.device]]
        else:
            row_devices = [[canonical_device(d) for d in row] for row in mesh.grid]
            self.device = row_devices[0][0]
            kinds = {d.type for row in row_devices for d in row}
            if len(kinds) > 1:
                raise ValueError(f"a mesh of one kind of device, not {sorted(kinds)}")
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

        def replica(devices) -> BEVHeight:
            model = BEVHeight(
                cfg, use_bf16=use_bf16, fused_convs=fused_convs,
                head_dtype=torch.bfloat16 if (bf16_head and on_cuda) else None,
                bev_devices=devices)
            model.load_state_dict(state_dict, strict=True)
            model.to(devices[0]).eval()
            if on_cuda:     # the bf16 image side; the head stays NCHW
                model.backbone.to(memory_format=torch.channels_last)
            if fused_convs:     # once per replica, on its device
                model.backbone.img_backbone.fold()
            if model.bev_devices is not None:
                model.replicate_head()
            return model

        replicas = {}
        for devices in row_devices:
            if tuple(devices) not in replicas:
                replicas[tuple(devices)] = replica(devices)
        self._rows = [_Row(replicas[tuple(devices)], devices[0])
                      for devices in row_devices]
        self.model = self._rows[0].model
        grid = cfg.backbone.voxel_grid
        self._num_cells = int(grid.voxel_num[0]) * int(grid.voxel_num[1])
        self.batches = 0

    @property
    def _cells(self):
        return self._rows[0].cells

    @property
    def _cells_key(self):
        return self._rows[0].cells_key

    def _rig_cells(self, row: _Row, host_mats, mats):
        """The row's cached lift cells (and cull), recomputed when the
        calibration bytes of its frames change. The cull's validity mask is
        computed on the host CPU from the host mats, once per rig."""
        with span("rig_cells"):
            key = tuple((k, np.asarray(host_mats[k]).tobytes())
                        for k in _RIG_KEYS if k in host_mats)
            if key == row.cells_key:
                row.rig_hits += 1
            else:
                row.rig_misses += 1
                cells = compute_lift_cells(self.cfg.backbone, mats)
                pix = None
                if self.cull_pixels:
                    cpu_mats = {k: torch.from_numpy(np.asarray(v, np.float32))
                                for k, v in host_mats.items()}
                    valid = compute_valid_pixels(self.cfg.backbone, cpu_mats).any(0)
                    out = cull_pixel_indices(valid.numpy())
                    if out is not None:
                        pix_np, n_valid = out
                        pix = torch.from_numpy(pix_np).to(row.device)
                        cells = apply_pixel_cull(cells, pix, n_valid, self._num_cells)
                row.cells = (cells, pix)
                row.cells_key = key
            return row.cells

    @staticmethod
    def _upload(arr, device: torch.device) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        copy from pageable memory would synchronise the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _row_inputs(self, row: _Row, imgs: np.ndarray, mats_dict):
        """The model's inputs for `row` from its frames' host arrays."""
        with span("upload"):
            mats = {k: self._upload(v, row.device) for k, v in mats_dict.items()}
            imgs = self._upload(imgs, row.device)
        cells, pix = (self._rig_cells(row, mats_dict, mats) if self.static_rig
                      else (None, None))
        return imgs, mats, cells, pix

    @staticmethod
    def _host_images(sweep_imgs) -> np.ndarray:
        imgs = np.asarray(sweep_imgs)
        if imgs.shape[3] == 3 and imgs.shape[-1] != 3:
            imgs = np.transpose(imgs, (0, 1, 2, 4, 5, 3))        # NCHW -> NHWC
        return imgs

    def _inputs(self, sweep_imgs, mats_dict):
        """The plain path's model inputs (imgs, mats, cells, pix)."""
        return self._row_inputs(self._rows[0], self._host_images(sweep_imgs),
                                mats_dict)

    def _shares(self, sweep_imgs, mats_dict):
        """(row, its model inputs) for each data row, its share of the
        batch in batch order."""
        imgs = self._host_images(sweep_imgs)
        if len(self._rows) == 1:
            return [(self._rows[0], self._row_inputs(self._rows[0], imgs, mats_dict))]
        n, batch = len(self._rows), imgs.shape[0]
        if batch % n:
            raise ValueError(f"a batch of {batch} does not split over the "
                             f"mesh's {n} data rows")
        m = batch // n
        return [(row, self._row_inputs(
                    row, imgs[r * m:(r + 1) * m],
                    {k: np.asarray(v)[r * m:(r + 1) * m] for k, v in mats_dict.items()}))
                for r, row in enumerate(self._rows)]

    @torch.inference_mode()
    def predict_heads(self, sweep_imgs, mats_dict) -> list:
        """The head's per-task dict of (B, H, W, c) tensors, before decode
        (under a mesh, the rows' outputs on the first row's device in batch
        order)."""
        outs = [row.model(*inputs)[0] for row, inputs in self._shares(sweep_imgs, mats_dict)]
        if len(outs) == 1:
            return outs[0]
        return [{k: torch.cat([o[t][k].to(self.device) for o in outs])
                 for k in task} for t, task in enumerate(outs[0])]

    @torch.inference_mode()
    def _dispatch(self, sweep_imgs, mats_dict) -> list[Detections]:
        """Enqueue one batch on the devices; returns each row's detections."""
        out = []
        for row, inputs in self._shares(sweep_imgs, mats_dict):
            with span("forward"):
                preds = row.model(*inputs)[0]
            out.append(decode(self.cfg.head, preds))
        return out

    @staticmethod
    def _collect(dets: Detections) -> List[list]:
        boxes, scores, labels, valid = (t.cpu().numpy() for t in dets)
        return [[boxes[i][valid[i]], scores[i][valid[i]], labels[i][valid[i]]]
                for i in range(boxes.shape[0])]

    def __call__(self, sweep_imgs, mats_dict) -> List[list]:
        """sweep_imgs: (B, S, N, 3, H, W) NCHW or (B, S, N, H, W, 3) NHWC,
        normalised float32 or raw uint8. Returns per-sample
        [boxes (M, 9), scores (M,), labels (M,)] numpy arrays."""
        return [sample for dets in self._dispatch(sweep_imgs, mats_dict)
                for sample in self._collect(dets)]

    @torch.inference_mode()
    def _start_copy(self, row: _Row, dets: Detections):
        """Copy one row's detections to pinned host buffers on its side
        stream, after the compute that made them; returns (host, event)."""
        compute = torch.cuda.current_stream(row.device)
        row.copy_stream.wait_stream(compute)
        with span("copy"), torch.cuda.stream(row.copy_stream):
            host = []
            for t in dets:
                t.record_stream(row.copy_stream)
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
            done = torch.cuda.Event()
            done.record(row.copy_stream)
        return Detections(*host), done

    def submit(self, sweep_imgs, mats_dict):
        """Enqueue one batch and, on CUDA, the copy of its detections to the
        host on each row's side stream; returns a handle for `fetch`."""
        seq = self.batches
        self.batches += 1
        with span("submit", seq):
            return _Handle([
                (dets, None) if row.copy_stream is None else self._start_copy(row, dets)
                for row, dets in zip(self._rows, self._dispatch(sweep_imgs, mats_dict))],
                seq)

    def fetch(self, handle) -> List[list]:
        """The per-sample detections of a `submit`ted batch (waits for it)."""
        out = []
        with span("fetch", handle.seq):
            for dets, done in handle:
                if done is not None:
                    with span("fetch.wait"):
                        done.synchronize()
                with span("collect"):
                    out += self._collect(dets)
        return out

    def stream(self, batches: Iterable) -> Iterable[List[list]]:
        """Pipelined serving over (sweep_imgs, mats_dict) batches: batch i is
        enqueued before batch i-1's results are read, and on CUDA the
        device-to-host copy of i-1 runs on a side stream while i computes.
        Yields the same per-batch results as sequential `__call__`s."""
        yield from pipelined(batches, lambda b: self.submit(*b), self.fetch)


def checkpoint_steps(path: str) -> list[tuple[int | None, str]]:
    """The saved steps of a checkpoint directory, oldest first, each as
    (step, the directory holding it): the port's own checkpoints directory
    (`<step>/state.pt`, `train.checkpoint`) or the JAX trainer's orbax one
    (`<step>/default/_METADATA`). `path` may also be one step's directory
    of either; its step is its name, None where that is not a number.
    Empty where `path` holds no step."""
    import os

    from sgv3d_tpu_torch.train.checkpoint import is_step_dir, saved_steps
    from sgv3d_tpu_torch.weights import is_orbax_step_dir, orbax_steps

    if is_step_dir(path) or is_orbax_step_dir(path):
        name = os.path.basename(os.path.normpath(path))
        return [(int(name) if name.isdigit() else None, path)]
    return [(step, os.path.join(path, str(step)))
            for step in saved_steps(path) or orbax_steps(path)]


def load_variables(cfg: ExpConfig, ckpt_path: str) -> dict[str, torch.Tensor]:
    """The state_dict of a BEVHeight for `cfg` from a flax-msgpack FILE
    (the converters' output, or `flax.serialization.to_bytes` of
    `{"params", "batch_stats"}`), read without flax or msgpack, or from a
    checkpoint DIRECTORY (`checkpoint_steps`: a checkpoints directory,
    whose latest step is read, or one step's): the port trainer's, whose
    `state.pt` gives the model's weights alone (`train.checkpoint.
    read_weights`), or the JAX trainer's orbax one, read through
    tensorstore (`weights.read_orbax_variables`; `ImportError` where
    tensorstore is missing); a directory with no step raises
    `FileNotFoundError`. Every key and shape is checked by
    `load_state_dict(strict=True)`, as flax's `from_bytes` checks the tree
    against its template."""
    import os

    from sgv3d_tpu_torch.train.checkpoint import is_step_dir, read_weights
    from sgv3d_tpu_torch.weights import (from_flax, read_flax_msgpack,
                                         read_orbax_variables)

    if os.path.isdir(ckpt_path):
        steps = checkpoint_steps(ckpt_path)
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint in {ckpt_path}: neither <step>/state.pt (the "
                f"port's trainer) nor <step>/default/_METADATA (orbax)")
        ckpt_path = steps[-1][1]
        weights = (read_weights(ckpt_path) if is_step_dir(ckpt_path)
                   else from_flax(read_orbax_variables(ckpt_path)))
    else:
        weights = from_flax(read_flax_msgpack(ckpt_path))
    model = BEVHeight(cfg)
    model.load_state_dict(weights, strict=True)
    return model.state_dict()


def load_predictor(cfg: ExpConfig, ckpt_path: str,
                   **predictor_kwargs) -> BEVHeightPredictor:
    """A predictor on the weights of a flax-msgpack file or a checkpoint
    directory, the port's or an orbax one (`load_variables`)."""
    return BEVHeightPredictor(cfg, load_variables(cfg, ckpt_path),
                              **predictor_kwargs)
