"""The system under test, `sgv3d_tpu_torch`, as the benchmark drives it: its
exp config built from a configuration file, its predictor with the file's
serving knobs on the benchmark's seeded weights, the forward hooks that
open a `record_function` range around each layer in a traced run, and its
kernels' launch counters. This is the only module of the benchmark that
imports the program.
"""
from __future__ import annotations

import contextlib

import torch

# the model's layers as the traced run's ranges, by module path in the
# served model; a path the model lacks is left out
LAYER_MODULES = {
    "pb.forward": "",
    "pb.backbone": "backbone",
    "pb.image:img_backbone": "backbone.img_backbone",
    "pb.image:img_neck": "backbone.img_neck",
    "pb.image:img_neck_16": "backbone.img_neck_16",
    "pb.image:img_neck_8": "backbone.img_neck_8",
    "pb.image:height_net": "backbone.height_net",
    "pb.image:assist_layer": "backbone.assist_layer",
    "pb.head": "head",
}


def exp_config(cfg: dict):
    """The program's `ExpConfig` from a configuration file's `exp`."""
    from sgv3d_tpu_torch.config import BackboneConfig, ExpConfig, HeadConfig, Task

    e = dict(cfg)
    head = dict(e.pop("head"))
    head["tasks"] = tuple(Task(tuple(t)) for t in head["tasks"])
    head["common_heads"] = tuple((n, tuple(v)) for n, v in head["common_heads"])
    head = {k: tuple(v) if isinstance(v, list) else v for k, v in head.items()}
    back = {k: tuple(v) if isinstance(v, list) else v for k, v in e.pop("backbone").items()}
    e = {k: tuple(v) if isinstance(v, list) else v for k, v in e.items()}
    return ExpConfig(backbone=BackboneConfig(**back), head=HeadConfig(**head), **e)


def predictor(config: dict, state_dict: dict, device: torch.device):
    """`api.BEVHeightPredictor` with the configuration's serving knobs."""
    from sgv3d_tpu_torch.api import BEVHeightPredictor

    knobs = config["serving"]
    pred = BEVHeightPredictor(exp_config(config["exp"]), state_dict, device=device,
                              use_bf16=knobs["use_bf16"], static_rig=knobs["static_rig"],
                              cull_pixels=knobs["cull_pixels"],
                              fused_convs=knobs["fused_convs"], bf16_head=knobs["bf16_head"])
    if knobs["use_bf16"] and device.type == "cpu":     # the CPU tests' bf16 side
        pred.model.backbone.use_bf16 = True
    return pred


@contextlib.contextmanager
def layer_ranges(model: torch.nn.Module):
    """Within the block, each of LAYER_MODULES' modules that `model` has
    runs inside a `record_function` range of its name."""
    handles = []
    for name, path in LAYER_MODULES.items():
        try:
            mod = model.get_submodule(path)
        except AttributeError:
            continue
        stack = []

        def pre(_m, _args, name=name, stack=stack):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def kernel_counters() -> dict:
    """The port's kernel wrappers by name; each counts its launches in
    `.launches` (absent: the counter is not read)."""
    from sgv3d_tpu_torch.ops import fused_bottleneck, lift_splat, topk_cells

    found = {"K1 topk_cells": getattr(topk_cells, "topk_with_cells", None),
             "K2 lift_splat": getattr(lift_splat, "lift_splat_forward", None),
             "K3 fused_bottleneck": getattr(fused_bottleneck, "fused_bottleneck", None)}
    return {k: v for k, v in found.items() if hasattr(v, "launches")}
