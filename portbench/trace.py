"""The traced run's reduction: `torch.profiler` events to the layers' device
times, the device's busy time and the idle gaps.

Host ranges are the harness's `record_function` spans (`pb.*`: the window,
each `submit` and `fetch`, and the model's layers by forward hooks). A
device event (kernel, copy or fill) belongs to every range that was open
on the host when it was launched: its runtime call's timestamp, found by
the correlation id the two share. A layer's self time is the device time
of what it launched less what its child ranges launched.
"""
from __future__ import annotations

import dataclasses

import numpy as np

COPY_MARKERS = ("memcpy", "memset")


@dataclasses.dataclass
class Timeline:
    """Plain arrays of one traced window (microseconds)."""
    ranges: dict            # name -> (starts, ends) sorted by start
    launch: np.ndarray      # each device event's launch time on the host
    start: np.ndarray       # device start
    end: np.ndarray         # device end
    names: list             # device event names
    copy: np.ndarray        # bool: a copy or fill, not a kernel


def from_profiler(prof) -> Timeline:
    """A Timeline from a stopped `torch.profiler.profile`, read from its raw
    kineto events (no `FunctionEvent` tree is built)."""
    from torch.autograd import DeviceType

    ranges, runtime, ops, dev = {}, {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("pb."):
                ranges.setdefault(name, []).append((e.start_ns() / 1e3, e.end_ns() / 1e3))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = e.start_ns() / 1e3
            else:
                ops[e.correlation_id()] = e.start_ns() / 1e3
        elif e.device_type() == DeviceType.CUDA and not name.startswith("pb."):
            # (a `pb.*` event on the device is the range's own annotation)
            dev.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3,
                        e.correlation_id(), e.linked_correlation_id()))
    # the runtime call that launched it; else the op it is linked to
    pairs = [(d, runtime.get(d[3], ops.get(d[4]))) for d in dev]
    dev = [d for d, t in pairs if t is not None]
    launch = [t for _, t in pairs if t is not None]
    return Timeline(
        ranges={k: tuple(np.array(x) for x in zip(*sorted(v))) for k, v in ranges.items()},
        launch=np.array(launch, float),
        start=np.array([d[1] for d in dev], float),
        end=np.array([d[2] for d in dev], float),
        names=[d[0] for d in dev],
        copy=np.array([any(m in d[0].lower() for m in COPY_MARKERS) for d in dev], bool))


def inside(tl: Timeline, prefix: str) -> np.ndarray:
    """Mask of the device events launched inside a range whose name is
    `prefix` or starts with `prefix` + ':'."""
    mask = np.zeros(len(tl.launch), bool)
    for name, (s, e) in tl.ranges.items():
        if name != prefix and not name.startswith(prefix + ":"):
            continue
        i = np.searchsorted(s, tl.launch, side="right") - 1
        ok = i >= 0
        mask[ok] |= tl.launch[ok] <= e[i[ok]]
    return mask


def device_ms(tl: Timeline, mask: np.ndarray) -> float | None:
    """Kernel milliseconds (copies and fills left out) under `mask`; None
    where no kernel is."""
    m = mask & ~tl.copy
    return float((tl.end[m] - tl.start[m]).sum()) / 1e3 if m.any() else None


def busy_intervals(tl: Timeline, lo: float, hi: float) -> np.ndarray:
    """The union of the device events' intervals, clipped to [lo, hi]:
    (k, 2) sorted and disjoint."""
    s, e = np.clip(tl.start, lo, hi), np.clip(tl.end, lo, hi)
    order = np.argsort(s)
    out = []
    for a, b in zip(s[order], e[order]):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out, float).reshape(-1, 2)


def innermost(tl: Timeline, t: float) -> str:
    """The name of the latest-opened `pb.*` range that holds time t."""
    best, name = -np.inf, "outside any range"
    for n, (s, e) in tl.ranges.items():
        i = np.searchsorted(s, t, side="right") - 1
        if i >= 0 and t <= e[i] and s[i] > best:
            best, name = s[i], n
    return name


def summary(tl: Timeline) -> dict:
    """The window's layer times (ms a batch), busy and window seconds, and
    the breakdown (top device ops, idle time by the host's range)."""
    ws, we = tl.ranges["pb.window"][0][0], tl.ranges["pb.window"][1][-1]
    batches = max(len(tl.ranges.get("pb.submit", ((), ()))[0]), 1)
    busy = busy_intervals(tl, ws, we)
    gaps = np.stack([np.r_[ws, busy[:, 1]], np.r_[busy[:, 0], we]], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    by_host = {}
    for a, b in gaps:
        key = innermost(tl, (a + b) / 2)
        by_host[key] = by_host.get(key, 0.0) + (b - a) / 1e6
    ops = {}
    for n, a, b in zip(tl.names, tl.start, tl.end):
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
    image, backbone = inside(tl, "pb.image"), inside(tl, "pb.backbone")
    forward, submit = inside(tl, "pb.forward"), inside(tl, "pb.submit")
    subs = tl.ranges.get("pb.submit")

    def per_batch(mask):
        ms = device_ms(tl, mask)
        return None if ms is None else ms / batches

    return {
        "batches": batches,
        "device_events": len(tl.launch),
        "window_s": (we - ws) / 1e6,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e6,
        "image_ms": per_batch(image),
        "lift_ms": per_batch(backbone & ~image),
        "head_ms": per_batch(inside(tl, "pb.head")),
        "forward_ms": per_batch(forward),
        "decode_ms": per_batch(submit & ~forward),
        "dispatch_ms": float(np.mean(subs[1] - subs[0])) / 1e3 if subs else None,
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda x: -x[1])[:10],
        },
    }
