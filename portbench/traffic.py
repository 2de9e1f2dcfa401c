"""The one traffic generator: a mix file's parameters drive one of two
loops over the predictor's `submit` / `fetch`.

- `closed_ahead`: one client that keeps one batch in flight, as
  `BEVHeightPredictor.stream` does: batch i is submitted before batch
  i - 1 is fetched. Batches are submitted until `seconds` have passed
  since the first; the one in flight then completes. Every batch is
  `batch` cameras of one rig, each camera its own calibration, with the
  next batch of frames of the pool.
- `open_ticks`: `batch` cameras triggered together; tick k is due at
  k / `rate_hz` seconds after the start, for every k due inside
  `seconds`. One caller submits each tick when it is due (or as soon as
  the previous tick returns, if that is later: the lateness is recorded)
  and waits for its detections; a tick's latency runs from its due time.

A failed call counts its frames as failed; a failed tick's latency is
FAILED_LATENCY_S, later than any tick that completes.
"""
from __future__ import annotations

import dataclasses
import time

import torch
from torch.autograd.profiler import record_function

FAILED_LATENCY_S = 3600.0


@dataclasses.dataclass
class Window:
    """What one window did, on the host's clock (seconds)."""
    start: float = 0.0
    end: float = 0.0                 # the last completion
    batch: int = 0
    attempted: int = 0               # frames submitted
    failed: int = 0                  # frames of failed calls
    completed: int = 0               # frames whose detections reached the host
    latency_s: list = dataclasses.field(default_factory=list)
    late_s: list = dataclasses.field(default_factory=list)
    served: dict = dataclasses.field(default_factory=dict)   # batch index -> per-frame dets

    @property
    def seconds(self) -> float:
        return self.end - self.start


def _submit(pred, win: Window, frames, mats):
    try:
        with record_function("pb.submit"):
            handle = pred.submit(frames, mats)
    except Exception as e:       # a failed call is counted, not fatal
        print(f"# submit failed: {e!r}", flush=True)
        handle = None
    win.attempted += win.batch
    return handle


def _fetch(pred, win: Window, index: int, handle) -> bool:
    if handle is not None:
        try:
            with record_function("pb.fetch"):
                dets = pred.fetch(handle)
            if len(dets) == win.batch:
                win.served[index] = dets
                win.completed += win.batch
                return True
        except Exception as e:
            print(f"# fetch failed: {e!r}", flush=True)
    win.failed += win.batch
    return False


def closed_ahead(pred, pool: torch.Tensor, mats: dict, seconds: float, **_) -> Window:
    win = Window(batch=pool.shape[1])
    nb = pool.shape[0]
    win.start = time.perf_counter()
    prev, i = None, 0
    while True:
        cur = None
        if time.perf_counter() - win.start < seconds:
            cur = (i, _submit(pred, win, pool[i % nb].numpy(), mats))
            i += 1
        if prev is not None:
            _fetch(pred, win, *prev)
            win.end = time.perf_counter()
        if cur is None:
            return win
        prev = cur


def open_ticks(pred, pool: torch.Tensor, mats: dict, seconds: float, rate_hz: float,
               **_) -> Window:
    win = Window(batch=pool.shape[1])
    nb = pool.shape[0]
    ticks = int(seconds * rate_hz)
    win.start = time.perf_counter()
    for k in range(ticks):
        due = win.start + k / rate_hz
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        win.late_s.append(time.perf_counter() - due)
        ok = _fetch(pred, win, k, _submit(pred, win, pool[k % nb].numpy(), mats))
        win.end = time.perf_counter()
        win.latency_s.append(win.end - due if ok else FAILED_LATENCY_S)
    return win


LOOPS = {"closed_ahead": closed_ahead, "open_ticks": open_ticks}
