"""Tracing and profiling (torch port of `sgv3d_tpu.train.profiling`): a
`torch.profiler` trace context, the program's own named spans in it, a
device fence and a call timer (the one every measuring tool of
`sgv3d_tpu_torch.tools` times through), and a per-section wall-clock
profiler in the shape of Lightning's 'simple' profiler."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` over the block (CPU, and CUDA where there is a
    card), written to `log_dir` as a TensorBoard / Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def span(name: str, seq: int | None = None):
    """A context manager: while a `torch.profiler` runs, the block is a
    range `sgv3d.<name>` in its trace, on the clock of the device's events,
    with the batch's sequence number `seq` (where given) as its keyword
    input `seq` (recorded under `record_shapes=True`). With no profiler
    running it costs one test of a flag and records nothing. The range is
    an operator-level one, not a user annotation: it adds no event of its
    own to the device's track, so a trace's device events are those of the
    kernels and copies alone."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast("sgv3d." + name, [], {} if seq is None else {"seq": seq})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _cuda_device(tree) -> torch.device | None:
    """The device of the first CUDA tensor in `tree`, else None."""
    return next((t.device for t in _leaves(tree)
                 if torch.is_tensor(t) and t.device.type == "cuda"), None)


def fence(tree) -> None:
    """Wait for the work that makes the tensors of `tree` (nested dicts,
    lists and tuples): synchronise the current stream of each card a
    tensor of it lives on. CPU tensors are ready when returned."""
    seen = set()
    for t in _leaves(tree):
        if torch.is_tensor(t) and t.device.type == "cuda" and t.device not in seen:
            seen.add(t.device)
            torch.cuda.current_stream(t.device).synchronize()


class Timing(NamedTuple):
    """`time_fn`'s result: the median and the interquartile spread of the
    timed calls, and each call's time, in seconds."""
    median_s: float
    spread_s: float
    times_s: list

    def ms(self) -> dict:
        return {"median_ms": 1e3 * self.median_s, "iqr_ms": 1e3 * self.spread_s,
                "iters": len(self.times_s)}


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            device: torch.device | str | None = None, **kwargs) -> Timing:
    """`fn(*args, **kwargs)` called `warmup` times, then `iters` timed
    times, each call fenced (`fence` of its result). On a card (`device`,
    else that of the first CUDA tensor in the arguments, else in the first
    call's result) each call is timed by a pair of CUDA events on the
    card's current stream; on the CPU by `time.perf_counter`. Returns the
    median and interquartile spread of the calls (`Timing`). The JAX
    package's `time_fn` returns the mean of the same calls."""
    dev = torch.device(device) if device is not None else _cuda_device((args, kwargs))
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        dev = dev or _cuda_device(out)
        fence(out)
    times = []
    for _ in range(iters):
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args, **kwargs)
            end.record(stream)
            fence(out)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
            continue
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dev = _cuda_device(out)
        fence(out)
        times.append(time.perf_counter() - t0)
    q75, q50, q25 = np.percentile(times, [75, 50, 25]) if times else (0.0, 0.0, 0.0)
    return Timing(float(q50), float(q75 - q25), times)


def time_back_to_back(fn: Callable, calls: int = 20,
                      device: torch.device | str = "cuda") -> float:
    """The ms a call of `fn()` over `calls` calls made back to back as one
    timed call of `time_fn` (after one such round untimed): on a card the
    kernels' rate when each launch is queued behind the last, which a fence
    after every call would hide behind the host's launch."""
    t = time_fn(lambda: [fn() for _ in range(calls)], iters=1, warmup=1, device=device)
    return 1e3 * t.median_s / calls


def profile_iter(prof: "SimpleProfiler", name: str, iterable):
    """Yield from `iterable`, charging each `next()` wait to `prof[name]`
    (the training loop's data-loader stall, apart from the step)."""
    it = iter(iterable)
    while True:
        with prof.profile(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


class SimpleProfiler:
    """Per-section wall times: totals, counts and each call's seconds. Each
    section is also the span `sgv3d.train.<name>` in a running profiler's
    trace (`span`)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("train." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.times[name].append(dt)

    def summary(self) -> str:
        lines = [f"{'Action':<40}{'Mean (s)':>12}{'Total (s)':>12}{'Calls':>8}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            cnt = self.counts[name]
            lines.append(f"{name:<40}{tot / cnt:>12.4f}{tot:>12.2f}{cnt:>8}")
        return "\n".join(lines)
