"""What the metric files under `metrics/` share: each reads one number from
a finished run, or None where the run has nothing to read (the metric is
then left out of the result line)."""
from __future__ import annotations

import numpy as np

from portbench.spec import H100_BF16_FLOPS, H100_HBM_BYTES


def traced(run, key: str):
    """A traced window's number by key (None outside a traced run)."""
    return None if run.trace is None else run.trace.get(key)


def on_device(run) -> bool:
    """A traced run in which the device ran something."""
    return run.trace is not None and run.trace["device_events"] > 0


def idle_share(run):
    if not on_device(run):
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu(run):
    """The model's FLOPs over the traced window's completed images, as a
    share (%) of the H100's dense bf16 peak."""
    if not on_device(run) or not run.window.completed:
        return None
    rate = run.window.completed / run.trace["window_s"]
    return 100.0 * run.cfg["flops_per_image"] * rate / H100_BF16_FLOPS


def lift_roofline(run):
    """The lift's least time (its bytes over HBM bandwidth) over its device
    time, a share (%)."""
    ms = traced(run, "lift_ms")
    if not ms or run.lift_bytes is None:
        return None
    return 100.0 * run.lift_bytes / H100_HBM_BYTES / (ms / 1e3)


def latency_ms(run, q: float):
    if not run.window.latency_s:
        return None
    return float(np.percentile(np.asarray(run.window.latency_s) * 1e3, q))


def mean_ms(values):
    return float(np.mean(values)) * 1e3 if values else None
