"""Experiment runner (torch port of `sgv3d_tpu.runner`): `train` (the
train set through `train.loop.train_step`, metrics JSONL, per-epoch
checkpoints with auto-resume) and `evaluate` (the val set through the model
and `decode`, then the KITTI evaluator).

One process drives one device. Under a process group (`dist`, as
`tools/train.py --multihost` or `torchrun` starts one) every rank trains on
its shard of the loader and the step is the JAX step over a data mesh of
the ranks (`train.loop`); rank 0 alone writes the logs and checkpoints.
Evaluation runs each rank's shard on its own device and gathers the
detections to rank 0, which evaluates; the other ranks return None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Mapping

import numpy as np
import torch

from sgv3d_tpu_torch import dist
from sgv3d_tpu_torch.api import (BEVHeightPredictor, checkpoint_steps,
                                 load_variables)
from sgv3d_tpu_torch.config import ExpConfig
from sgv3d_tpu_torch.data.dataset import DataLoader, RoadSideDataset
from sgv3d_tpu_torch.evalkit.evaluator import RoadSideEvaluator
from sgv3d_tpu_torch.train import optim, profiling, sharding
from sgv3d_tpu_torch.train.checkpoint import CheckpointManager
from sgv3d_tpu_torch.train.loop import (TrainState, create_train_state, no_tf32,
                                        train_step)
from sgv3d_tpu_torch.train.metrics import MetricsLogger
from sgv3d_tpu_torch.utils.backup_files import backup_codebase
from sgv3d_tpu_torch.utils.pipeline import pipelined

def default_info_paths(cfg: ExpConfig, data_root: str):
    """Train/val info pkl resolution incl. the SSDG auto-switch
    (reference :412: prefer *_train_ssdg.pkl when present)."""
    candidates = {
        "rope3d-kitti": ("rope3d_12hz_infos_train_dair.pkl",
                         "rope3d_12hz_infos_train_ssdg.pkl",
                         "rope3d_12hz_infos_val_dair.pkl"),
        "dair-v2x-i": ("dair_12hz_infos_train.pkl", None,
                       "dair_12hz_infos_val.pkl"),
        "rope3d": ("rope3d_12hz_infos_train.pkl", None,
                   "rope3d_12hz_infos_val.pkl"),
    }
    for key, (train, ssdg, val) in candidates.items():
        if key in data_root:
            train_path = os.path.join(data_root, train)
            if ssdg and os.path.exists(os.path.join(data_root, ssdg)):
                train_path = os.path.join(data_root, ssdg)
            return train_path, os.path.join(data_root, val)
    return (os.path.join(data_root, "infos_train.pkl"),
            os.path.join(data_root, "infos_val.pkl"))


def train(cfg: ExpConfig, data_root: str | None = None,
          output_dir: str | None = None, max_steps: int | None = None,
          resume: bool = True, ckpt_every_epochs: int = 3,
          train_info_path: str | None = None, seed: int = 0,
          backup: bool = True, use_bf16: bool = True,
          trace_dir: str | None = None, device: str | torch.device = "cuda",
          stats: dict | None = None) -> TrainState:
    """Train `cfg` on one device, or on each rank's device of a process
    group; returns the final `TrainState`.

    As the JAX runner: the train set with rectify and brightness
    augmentation, shuffled and seeded, `drop_last`; `train_step` a batch;
    `metrics.jsonl` (and a TensorBoard event file under `tb/`) in
    `output_dir` (default `outputs/<exp>`); a checkpoint every
    `ckpt_every_epochs` epochs and at the end under `checkpoints/`, and,
    with `resume`, a start from the latest one there. `backup` copies the
    source into `output_dir/backup` first. `use_bf16` (default) runs the
    image side in bf16 on CUDA (geometry, softmaxes, lift, head and losses
    stay float32); `use_bf16=False` (CLI `--fp32`) trains in float32 as
    the reference does; either way float32 work runs without TF32 while
    the loop runs (`loop.no_tf32`). A per-section wall-time summary (data
    wait, step, metrics log, checkpoint) is printed at the end; `trace_dir`
    records a `torch.profiler` trace of the run (pair it with a small
    `max_steps`).

    Under a process group of W ranks (`dist.init_distributed`) each rank
    loads its round-robin shard of the shuffled set (`batch_size_per_device`
    rows of a global batch W times larger), the LR follows W devices, every
    rank restores the same checkpoint and then takes rank 0's state
    (`sharding.replicate_state`), and rank 0 alone backs up, logs and saves
    (a barrier after each save). `device` "cuda" is the rank's card (the
    current one, which `init_distributed` sets).

    `stats`, where given, receives the loop's host timing: `step_s`, the
    wall seconds from the end of one step's iteration to the end of the
    next (the metrics of step i are read at step i + 1, so in the steady
    state this is the card's step time or the loader's, whichever is
    longer), and `loader_wait_s`, `step_dispatch_s`, the seconds each step
    waited on the loader and took to enqueue.
    """
    data_root = data_root or cfg.data_root
    output_dir = output_dir or os.path.join("outputs", cfg.name)
    info_path, _ = default_info_paths(cfg, data_root)
    info_path = train_info_path or info_path
    rank, world = dist.get_rank(), dist.get_world_size()
    if backup and rank == 0:
        backup_codebase(os.path.join(output_dir, "backup"))
    device = _device(device)

    dataset = RoadSideDataset(
        cfg.ida_aug_conf, cfg.classes, data_root, info_path, is_train=True,
        return_semantic=cfg.backbone.is_bsm and cfg.is_train_height,
        max_objs=cfg.head.max_objs, seed=seed, device_normalize=True)
    loader = DataLoader(dataset, cfg.batch_size_per_device, shuffle=True,
                        drop_last=True, seed=seed, to_device=device,
                        shard_id=rank, num_shards=world)
    if len(loader) == 0:
        raise ValueError(f"dataset ({len(dataset)} samples) smaller than the "
                         f"global batch ({cfg.batch_size_per_device} x "
                         f"{world} ranks)")
    steps_per_epoch = len(loader)
    lr_of = functools.partial(optim.schedule_value, cfg, world, steps_per_epoch)

    state = create_train_state(cfg, seed, device, use_bf16, steps_per_epoch)
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
    if resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        if rank == 0:
            print(f"resumed from step {state.step}")
    sharding.replicate_state(state)
    logger = (MetricsLogger(os.path.join(output_dir, "metrics.jsonl"),
                            os.path.join(output_dir, "tb"))
              if rank == 0 else _NullLogger())

    step = state.step
    total_steps = max_steps or cfg.max_epochs * steps_per_epoch
    prof = profiling.SimpleProfiler()
    step_s = []
    trace_ctx = (profiling.trace(trace_dir) if trace_dir
                 else contextlib.nullcontext())
    try:
        with trace_ctx, no_tf32():
            t0 = time.perf_counter()
            while step < total_steps:
                for batch in profiling.profile_iter(prof, "data_wait", loader):
                    imgs, mats, gt_boxes, gt_labels, gt_semantic, _ = batch
                    with prof.profile("step_dispatch"):
                        metrics = train_step(state, imgs, mats, gt_boxes,
                                             gt_labels, gt_semantic)
                    step = state.step
                    with prof.profile("metrics_log"):
                        logger.log(step, metrics, lr=lr_of(step),
                                   epoch=step / steps_per_epoch)
                    step_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    if step >= total_steps:
                        break
                epoch = step // steps_per_epoch
                if epoch % ckpt_every_epochs == 0 or step >= total_steps:
                    with prof.profile("checkpoint"):
                        if rank == 0:
                            ckpt.save(state)
                        dist.synchronize()
                t0 = time.perf_counter()
    finally:
        # write the deferred last step even on a crash: its metrics (a NaN
        # loss, say) are what is needed to debug it
        logger.close()
        if rank == 0 and prof.counts:
            print(f"train profile (simple) [{cfg.name}]:\n{prof.summary()}")
    if stats is not None:
        stats.update(step_s=step_s, loader_wait_s=prof.times["data_wait"],
                     step_dispatch_s=prof.times["step_dispatch"])
    return state


def _device(device: str | torch.device) -> torch.device:
    """`device` with "cuda" resolved to the current card (a rank's own
    under `dist.init_distributed`)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _NullLogger:
    """The metrics sink of the ranks other than 0 (rank 0 writes the JSONL
    and TensorBoard files, as the reference's rank-0 logger does)."""

    def log(self, *args, **kwargs):
        pass

    def close(self):
        pass


def eval_config(cfg: ExpConfig, fast_lift: bool = False) -> ExpConfig:
    """The config actually evaluated by `-e`: parity-grade (exact all-bin
    lift) unless `fast_lift` opts back into the exp's deploy `lift_top_k`."""
    if not fast_lift and cfg.backbone.lift_top_k is not None:
        cfg = dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, lift_top_k=None))
    return cfg


def evaluate(cfg: ExpConfig, ckpt_path: str | None = None,
             data_root: str | None = None, output_dir: str | None = None,
             val_info_path: str | None = None,
             state_dict: Mapping[str, torch.Tensor] | None = None,
             ckpt_step: int | None = None, fast_lift: bool = False,
             bf16: bool = False, bf16_head: bool = False,
             device: str | torch.device = "cuda", stats: dict | None = None):
    """Evaluate the val set; returns (mAP, ret_dict) as the JAX runner does.

    The weights come from `ckpt_path` or from an in-memory `state_dict`.
    `ckpt_path` is a flax-msgpack file, or a checkpoint directory: the
    port trainer's `checkpoints` directory or the JAX trainer's orbax one,
    or one step's directory of either (`api.checkpoint_steps`). As the
    reference's `-e` mode, a directory is evaluated checkpoint by
    checkpoint: every saved step, oldest first, each writing its own
    `epoch_result_<mAP>.txt` through the evaluator, and the newest step's
    result is returned; `ckpt_step` evaluates that step alone (a step not
    saved raises `FileNotFoundError`). Evaluation is
    parity-grade by default: float32 with TF32 off and the exact all-bin
    lift (K2's all-bin layout). `fast_lift=True` opts into the exp's top-k
    lift (K1, then K2's top-k layout), `bf16=True` into the bf16 backbone
    under autocast and `bf16_head=True` into the bf16 BEV head (each on
    CUDA; the predictor keeps the CPU float32).

    Under a process group every rank walks the same steps in the same
    order; each rank evaluates its round-robin shard of the val set on its
    own device (`device` "cuda" is the rank's card); the
    detections and metas are gathered to rank 0 in dataset order, rank 0
    evaluates and returns (mAP, ret_dict), and the other ranks return None.

    `stats`, where given, receives the loop's host timing: `batch_s`, the
    wall seconds of each batch (from one readback to the next; the first
    includes the warm-up), `loader_wait_s`, the seconds each batch kept
    the loop waiting on the data loader, and `loader_build_s`, the seconds
    the loader's prefetch thread took to build each batch.
    """
    if (ckpt_path is None) == (state_dict is None):
        raise ValueError("evaluate needs exactly one of ckpt_path (a "
                         "flax-msgpack file or a checkpoint directory) and "
                         "state_dict")
    if ckpt_step is not None and not (ckpt_path and os.path.isdir(ckpt_path)):
        raise ValueError("ckpt_step picks a step of a checkpoint directory; "
                         f"ckpt_path {ckpt_path!r} is not one")
    data_root = data_root or cfg.data_root
    output_dir = output_dir or os.path.join("outputs", cfg.name)
    _, val_info = default_info_paths(cfg, data_root)
    val_info = val_info_path or val_info

    cfg = eval_config(cfg, fast_lift=fast_lift)
    dataset = RoadSideDataset(
        cfg.ida_aug_conf, cfg.classes, data_root, val_info, is_train=False,
        max_objs=cfg.head.max_objs, device_normalize=True)
    loader = DataLoader(dataset, cfg.batch_size_per_device,
                        shard_id=dist.get_rank(), num_shards=dist.get_world_size())
    if state_dict is not None:
        weights = [(None, lambda: state_dict)]
    elif os.path.isdir(ckpt_path):
        saved = checkpoint_steps(ckpt_path)
        steps = [(step, step_dir) for step, step_dir in saved
                 if ckpt_step is None or step == ckpt_step]
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint{'' if ckpt_step is None else f' of step {ckpt_step}'} "
                f"in {ckpt_path} (saved: {[step for step, _ in saved]})")
        weights = [(step, functools.partial(load_variables, cfg, step_dir))
                   for step, step_dir in steps]
    else:
        weights = [(None, functools.partial(load_variables, cfg, ckpt_path))]
    out = None
    for step, read in weights:
        if step is not None and dist.get_rank() == 0:
            print(f"evaluating checkpoint step {step}")
        # no rig cache: every val frame carries its own calibration, and the
        # JAX eval step computes its lift cells each batch too
        predictor = BEVHeightPredictor(cfg, read(), device=_device(device),
                                       use_bf16=bf16, static_rig=False,
                                       bf16_head=bf16_head)
        out = _evaluate_state(cfg, predictor, loader, dataset, data_root,
                              output_dir, stats)
    return out


def _evaluate_state(cfg: ExpConfig, predictor: BEVHeightPredictor, loader,
                    dataset, data_root: str, output_dir: str,
                    stats: dict | None = None):
    local_batch = cfg.batch_size_per_device
    results, img_metas = [], []

    def dispatch(batch):
        """Enqueue one eval batch; returns (handle, n, metas)."""
        imgs, mats, _, _, _, metas = batch
        n_real = imgs.shape[0]
        if n_real < local_batch:
            # pad the ragged final batch by repeating the last sample, as
            # the JAX runner does (the padding is dropped below)
            pad = local_batch - n_real
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            mats = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                    for k, v in mats.items()}
        return predictor.submit(imgs, mats), n_real, metas

    def collect(handle, n_real, metas):
        results.extend(predictor.fetch(handle)[:n_real])
        img_metas.extend(metas[:n_real])

    # dispatch batch i, then read back batch i-1 while i computes
    prof, batch_s = profiling.SimpleProfiler(), []
    batches = profiling.profile_iter(prof, "data_wait", loader)
    t0 = time.perf_counter()
    for _ in pipelined(batches, dispatch, lambda p: collect(*p)):
        batch_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    if stats is not None:
        # each batch's wait; the last wait is the `next` that found the
        # loader done
        stats.update(batch_s=batch_s, loader_wait_s=prof.times["data_wait"][:-1],
                     loader_build_s=loader.build_s)

    dist.synchronize()
    if dist.get_world_size() > 1:
        results = dist.interleave_shards(dist.all_gather_object(results),
                                         len(dataset))
        img_metas = dist.interleave_shards(dist.all_gather_object(img_metas),
                                           len(dataset))
    else:
        results = results[:len(dataset)]
        img_metas = img_metas[:len(dataset)]
    # every frame exactly once: nothing evaluates a prefix of the val set,
    # so a short gather is a lost batch, not a shorter evaluation
    if len(results) != len(dataset) or len(img_metas) != len(dataset):
        raise ValueError(f"evaluation gathered {len(results)} results and "
                         f"{len(img_metas)} metas for {len(dataset)} frames")
    if dist.get_rank() != 0:
        return None
    evaluator = RoadSideEvaluator(
        class_names=cfg.classes,
        current_classes=["Car", "Pedestrian", "Cyclist"],
        data_root=data_root,
        gt_label_path=default_gt_label_path(data_root),
        output_dir=output_dir)
    return evaluator.evaluate(results, img_metas)


def default_gt_label_path(data_root: str) -> str:
    """GT label dir per dataset (reference exp conventions): rope3d trees use
    the class-merged `label_eval`; DAIR evaluates against the KITTI-format
    tree's `label_2` (for raw dair roots, the sibling `dair-v2x-i-kitti`)."""
    root = data_root.rstrip("/")
    if "rope3d" in root:
        return os.path.join(root, "training/label_eval")
    if root.endswith("dair-v2x-i"):
        sibling = os.path.join(os.path.dirname(root), "dair-v2x-i-kitti")
        return os.path.join(sibling, "training/label_2")
    return os.path.join(root, "training/label_2")
