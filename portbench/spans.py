"""The program's own spans (`sgv3d.*`, `sgv3d_tpu_torch.train.profiling.span`)
and counters in a traced window: the reduction that `trace.py` and `run.py`
do not make, and a probe that runs it on a cell.

    python3 -m portbench.spans --workload <name> --seed <n> [--seconds <s>]

The probe makes the cell's set-up and one traced window as `run.py
--trace 1` does (the mix's `trace_seconds` unless `--seconds`), with the
harness's ranges, and prints one JSON line: `trace.summary` of the window
as the benchmark reads it, whether it is the same with every `sgv3d.*`
event dropped, the per-batch numbers of `values`, the idle gaps named by
the innermost program span (`name_gaps`), the program's counters over the
window, and where the host was (`host_ops`): the idle time and the
synchronising calls' time by program span and innermost host op. It does
not judge the detections (`run.py` does).

A program span's time is host time on the profiler's clock, the clock of
the device's events. A synchronising runtime call is one that waits for
the device (`synchronising`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from types import SimpleNamespace

import numpy as np

from portbench import trace

PREFIX = "sgv3d."
BLOCKING = ("cudaMemcpy", "cudaMemcpy2D", "cudaMalloc", "cudaFree", "cudaHostAlloc",
            "cudaFreeHost")


def synchronising(name: str) -> bool:
    """A CUDA runtime call that waits for the device or for the host's
    allocator to drain it."""
    return "Synchronize" in name or name in BLOCKING


@dataclasses.dataclass
class Spans:
    """The program's spans and the synchronising runtime calls of one
    traced window (microseconds), each name -> (starts, ends) by start."""
    spans: dict
    sync: dict


def _intervals(found: dict) -> dict:
    return {k: tuple(np.array(x, float) for x in zip(*sorted(v))) for k, v in found.items()}


def from_profiler(prof) -> Spans:
    """The window's `sgv3d.*` host events and synchronising runtime calls,
    from a stopped `torch.profiler.profile`'s raw kineto events."""
    from torch.autograd import DeviceType

    spans, sync = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith(PREFIX):
            spans.setdefault(name, []).append((e.start_ns() / 1e3, e.end_ns() / 1e3))
        elif synchronising(name):
            sync.setdefault(name, []).append((e.start_ns() / 1e3, e.end_ns() / 1e3))
    return Spans(_intervals(spans), _intervals(sync))


def without_spans(prof):
    """A stand-in for `prof` whose events leave out the program's spans:
    `trace.from_profiler` of it reads the window as a program without
    them would give it."""
    events = [e for e in prof.profiler.kineto_results.events()
              if not e.name().startswith(PREFIX)]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _inside(ranges: dict, name: str, t: np.ndarray) -> np.ndarray:
    """Mask of times t inside a range called `name`."""
    if name not in ranges:
        return np.zeros(len(t), bool)
    s, e = ranges[name]
    i = np.searchsorted(s, t, side="right") - 1
    ok = i >= 0
    out = np.zeros(len(t), bool)
    out[ok] = t[ok] <= e[i[ok]]
    return out


def _host_ms(ranges: dict, name: str) -> float:
    if name not in ranges:
        return 0.0
    s, e = ranges[name]
    return float((e - s).sum()) / 1e3


def _gaps(tl: trace.Timeline) -> np.ndarray:
    """The window's idle gaps, (k, 2) in us, as `trace.summary` finds them."""
    ws, we = tl.ranges["pb.window"][0][0], tl.ranges["pb.window"][1][-1]
    busy = trace.busy_intervals(tl, ws, we)
    gaps = np.stack([np.r_[ws, busy[:, 1]], np.r_[busy[:, 0], we]], 1)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def _innermost_many(ranges: dict, t: np.ndarray) -> np.ndarray:
    """For each time of t the name of the latest-opened range of `ranges`
    that holds it, else None."""
    best = np.full(len(t), -np.inf)
    found = np.full(len(t), None, object)
    for n, (s, e) in ranges.items():
        i = np.searchsorted(s, t, side="right") - 1
        j = np.maximum(i, 0)
        hit = (i >= 0) & (t <= e[j]) & (s[j] > best)
        best[hit], found[hit] = s[j][hit], n
    return found


def name_gaps(tl: trace.Timeline, sp: Spans) -> list:
    """The window's idle gaps (as `trace.summary` finds them) by name,
    seconds, largest first: the innermost `sgv3d.*` span open on the host
    at the gap's midpoint, else the innermost harness range; where the
    midpoint falls inside a synchronising runtime call, its name after a
    space. Each entry is [name, seconds, the harness range's name]."""
    gaps = _gaps(tl)
    mids = gaps.mean(1)
    named = {}
    for (a, b), mid, name, call in zip(gaps, mids, _innermost_many(sp.spans, mids),
                                       _innermost_many(sp.sync, mids)):
        outer = trace.innermost(tl, mid)
        name = name or outer
        key = (name + " " + call if call else name, outer)
        named[key] = named.get(key, 0.0) + (b - a) / 1e6
    return sorted(([k[0], v, k[1]] for k, v in named.items()), key=lambda x: -x[1])


def host_ops(prof, tl: trace.Timeline, sp: Spans, top: int = 15) -> dict:
    """Where the host was: the idle gaps' seconds by (innermost program
    span, innermost host op or runtime call at the gap's midpoint), and
    the synchronising calls' seconds by (program span, the op that made
    the call, the call), largest first."""
    from torch.autograd import DeviceType

    found = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() == DeviceType.CPU and not name.startswith(PREFIX)
                and not name.startswith("pb.")):
            found.setdefault(name, []).append((e.start_ns() / 1e3, e.end_ns() / 1e3))
    ops = _intervals(found)
    gaps = _gaps(tl)
    mids = gaps.mean(1)
    idle = {}
    for (a, b), span_name, op in zip(gaps, _innermost_many(sp.spans, mids),
                                     _innermost_many(ops, mids)):
        key = f"{span_name} | {op}"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    callers = {k: v for k, v in ops.items() if not k.startswith("cu")}
    waits = {}
    for call, (s, e) in sp.sync.items():
        for t, u, span_name, op in zip(s, e, _innermost_many(sp.spans, s),
                                       _innermost_many(callers, s)):
            key = f"{span_name} | {op} | {call}"
            waits[key] = waits.get(key, 0.0) + (u - t) / 1e6

    def largest(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda x: -x[1])[:top]

    return {"idle_s": largest(idle), "sync_s": largest(waits)}


def values(tl: trace.Timeline, sp: Spans, counters: tuple[dict, dict] | None = None) -> dict:
    """The per-batch numbers the program's spans give (None where the
    window has nothing to read):

    - `upload_ms`: host ms a batch in `sgv3d.upload`;
    - `decode_enqueue_ms`: host ms a batch in `sgv3d.decode`;
    - `nms_kernels`: device kernels a batch launched inside `sgv3d.decode.nms`;
    - `sync_ms`: host ms a batch in synchronising runtime calls that start
      inside `sgv3d.submit` and outside `sgv3d.fetch.wait`;
    - `rig_hit_rate`: rig-cache hits over lookups (%) between `counters`
      (before, after)."""
    subs = sp.spans.get(PREFIX + "submit")
    out = dict.fromkeys(("upload_ms", "decode_enqueue_ms", "nms_kernels", "sync_ms",
                         "rig_hit_rate"))
    if subs is not None:
        n = len(subs[0])
        out["upload_ms"] = _host_ms(sp.spans, PREFIX + "upload") / n
        out["decode_enqueue_ms"] = _host_ms(sp.spans, PREFIX + "decode") / n
        kernels = ~tl.copy & _inside(sp.spans, PREFIX + "decode.nms", tl.launch)
        out["nms_kernels"] = float(kernels.sum()) / n if len(tl.launch) else None
        total = 0.0
        for s, e in sp.sync.values():
            keep = (_inside(sp.spans, PREFIX + "submit", s)
                    & ~_inside(sp.spans, PREFIX + "fetch.wait", s))
            total += float((e[keep] - s[keep]).sum())
        out["sync_ms"] = total / 1e3 / n
    if counters is not None:
        before, after = counters
        hits = after.get("rig_hits", 0) - before.get("rig_hits", 0)
        looks = hits + after.get("rig_misses", 0) - before.get("rig_misses", 0)
        out["rig_hit_rate"] = 100.0 * hits / looks if looks else None
    return out


def program_counters(pred) -> dict:
    """The predictor's counters (absent on a program without them: {})."""
    rows = getattr(pred, "_rows", [])
    if not hasattr(pred, "batches") or not all(hasattr(r, "rig_hits") for r in rows):
        return {}
    return {"batches": pred.batches, "rig_hits": sum(r.rig_hits for r in rows),
            "rig_misses": sum(r.rig_misses for r in rows)}


def probe(name: str, seed: int, seconds: float | None = None, device: str = "cuda",
          base=None) -> dict:
    """One traced window of cell `name` (see the module's docstring)."""
    import torch
    from torch.autograd.profiler import record_function

    from portbench import inputs, program, spec, weights
    from portbench.reference.model import Detector
    from portbench.run import warm_up
    from portbench.traffic import LOOPS

    cell = spec.cell(name, base or spec.HERE)
    cfg, mix = cell["cfg"], cell["mix"]
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dim = cfg["exp"]["backbone"]["final_dim"]
    with torch.device("meta"):
        shapes = weights.names_shapes(Detector(cfg["exp"]))
    pred = program.predictor(cfg, weights.draw(shapes, seed, dev), dev)
    mats = inputs.batch_mats(inputs.rigs(seed, mix["batch"], dim))
    pool = inputs.frame_pool(seed, mix["pool_batches"], mix["batch"], dim, dev)
    warm_up(pred, pool, mats, mix["warmup_batches"])
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = program_counters(pred)
    with program.layer_ranges(pred.model), torch.profiler.profile(activities=acts) as prof:
        with record_function("pb.window"):
            win = LOOPS[mix["loop"]](pred, pool, mats, seconds or mix["trace_seconds"], **mix)
        sync()
    after = program_counters(pred)
    tl = trace.from_profiler(prof)
    summary = trace.summary(tl)
    sp = from_profiler(prof)
    gaps = name_gaps(tl, sp)
    where = host_ops(prof, tl, sp)
    idle = sum(g[1] for g in gaps)
    outer = sum(g[1] for g in gaps if g[2] in ("pb.submit", "pb.head"))
    named = sum(g[1] for g in gaps if g[2] in ("pb.submit", "pb.head")
                and g[0].startswith(PREFIX))
    return {
        "cell": name, "seed": seed, "completed": win.completed, "failed": win.failed,
        "summary": summary,
        "summary_unchanged": summary == trace.summary(trace.from_profiler(without_spans(prof))),
        "spans": {k: len(v[0]) for k, v in sorted(sp.spans.items())},
        "values": values(tl, sp, (before, after)),
        "counters": {"before": before, "after": after},
        "idle_s": idle,
        "idle_named_share": named / outer if outer else None,
        "gaps": gaps[:20],
        "host_ops": where,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    a = p.parse_args(argv)
    from portbench.run import cache_dirs

    cache_dirs()
    print(json.dumps(probe(a.workload, a.seed, a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
