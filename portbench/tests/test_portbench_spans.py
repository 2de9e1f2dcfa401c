"""The reduction of the program's spans (`portbench/spans.py`) on the CPU:
the benchmark's own summary is the same with and without the program's
spans and runtime calls in a trace, the per-batch numbers and the named
idle gaps of a synthetic window worked out by hand, and the probe on the
tiny cells.

    python -m pytest -q -p no:cacheprovider portbench/tests
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from portbench import spans, spec, trace


class _Event:
    """A kineto event as `trace.from_profiler` and `spans.from_profiler`
    read it (times in us)."""

    def __init__(self, name, start, end, device=DeviceType.CPU, corr=0, linked=0):
        self._v = (name, device, start, end, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2] * 1e3

    def end_ns(self):
        return self._v[3] * 1e3

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _harness_events():
    """A window of two batches as the harness traces a program without
    spans: its ranges, ops, runtime launches and device kernels and a copy."""
    cuda = DeviceType.CUDA
    ev = [_Event("pb.window", 0, 100), _Event("pb.submit", 0, 30),
          _Event("pb.submit", 50, 80), _Event("pb.forward", 1, 20),
          _Event("pb.head", 10, 19), _Event("pb.fetch", 31, 45),
          _Event("pb.head", 10, 19, cuda, corr=90)]     # the range's own annotation
    launches = [(2, 3, 9, "conv"), (11, 12, 18, "gemm"), (22, 23, 25, "nms_and"),
                (24, 26, 27, "Memcpy DtoH"), (55, 56, 70, "conv")]
    for i, (t, s, e, name) in enumerate(launches):
        ev += [_Event("aten::op", t - 0.5, t + 0.8, corr=100 + i),
               _Event("cudaLaunchKernel", t, t + 0.5, corr=i + 1, linked=100 + i),
               _Event(name, s, e, cuda, corr=i + 1, linked=100 + i)]
    return ev


def _program_events():
    """The program's spans and synchronising calls in the same window; one
    span's id is the linked id of a kernel launched with no op between."""
    ev = [_Event("sgv3d.submit", 0.2, 29.8, corr=200), _Event("sgv3d.forward", 0.5, 20.5, corr=201),
          _Event("sgv3d.head", 9.5, 19.5, corr=202), _Event("sgv3d.decode", 21, 28, corr=203),
          _Event("sgv3d.decode.nms", 21.5, 27.5, corr=204),
          _Event("sgv3d.fetch", 31, 45, corr=205), _Event("sgv3d.fetch.wait", 32, 44, corr=206),
          _Event("cudaStreamSynchronize", 33, 43, corr=300),
          _Event("cudaDeviceSynchronize", 28.5, 29, corr=301)]
    return ev


def test_harness_summary_unchanged_by_program_spans():
    bare = trace.summary(trace.from_profiler(_prof(_harness_events())))
    both = _harness_events() + _program_events()
    traced = trace.summary(trace.from_profiler(_prof(both)))
    assert traced == bare
    assert bare["batches"] == 2 and bare["head_ms"] == pytest.approx(6 / 1e3 / 2)
    assert traced == trace.summary(trace.from_profiler(spans.without_spans(_prof(both))))
    # the readers of the accepted metrics read the same
    for name in ("serve.dispatch_ms", "serve.head_ms", "serve.decode_ms",
                 "serve.image_ms", "serve.idle_share"):
        read = spec.reader(name)
        assert read(SimpleNamespace(trace=traced)) == read(SimpleNamespace(trace=bare))


def test_program_spans_and_sync_calls_collected():
    sp = spans.from_profiler(_prof(_harness_events() + _program_events()))
    assert sorted(sp.spans) == sorted(e.name() for e in _program_events()
                                      if e.name().startswith("sgv3d."))
    assert sorted(sp.sync) == ["cudaDeviceSynchronize", "cudaStreamSynchronize"]
    assert "cudaLaunchKernel" not in sp.sync


@pytest.mark.parametrize("name,sync", [
    ("cudaStreamSynchronize", True), ("cudaEventSynchronize", True),
    ("cudaDeviceSynchronize", True), ("cudaMemcpy", True), ("cudaMemcpy2D", True),
    ("cudaMalloc", True), ("cudaFree", True), ("cudaHostAlloc", True),
    ("cudaFreeHost", True), ("cudaMemcpyAsync", False), ("cudaMemcpy2DAsync", False),
    ("cudaLaunchKernel", False), ("cudaEventRecord", False), ("cudaMallocAsync", False)])
def test_synchronising_calls(name, sync):
    assert spans.synchronising(name) is sync


def _window():
    """Window [0, 100] us, two batches (see the test's arithmetic)."""
    def iv(*pairs):
        return (np.array([p[0] for p in pairs], float), np.array([p[1] for p in pairs], float))

    ranges = {"pb.window": iv((0, 100)), "pb.submit": iv((0.1, 30), (50, 80))}
    # (launch, start, end, copy)
    ev = [(5, 5, 20, False), (22.5, 22.5, 23, False), (24, 24, 25, False),
          (25, 25, 26, True), (26.5, 27, 28, False), (73, 73, 74, False)]
    a = np.array([e[:3] for e in ev], float)
    tl = trace.Timeline(ranges=ranges, launch=a[:, 0], start=a[:, 1], end=a[:, 2],
                        names=[f"k{i}" for i in range(len(ev))],
                        copy=np.array([e[3] for e in ev]))
    sp = spans.Spans(
        spans={"sgv3d.submit": iv((0.2, 30), (50, 80)), "sgv3d.upload": iv((1, 3), (51, 52)),
               "sgv3d.forward": iv((4, 20), (53, 70)), "sgv3d.decode": iv((21, 28), (71, 78)),
               "sgv3d.decode.nms": iv((22, 27), (72, 77)), "sgv3d.fetch": iv((31, 45), (81, 95)),
               "sgv3d.fetch.wait": iv((32, 44), (82, 94))},
        sync={"cudaStreamSynchronize": iv((23, 26), (33, 43), (83, 93)),
              "cudaMemcpy": iv((60, 62))})
    return tl, sp


def test_values_by_hand():
    tl, sp = _window()
    v = spans.values(tl, sp, ({"rig_hits": 1, "rig_misses": 1},
                              {"rig_hits": 20, "rig_misses": 2}))
    assert v["upload_ms"] == pytest.approx((2 + 1) / 1e3 / 2)
    assert v["decode_enqueue_ms"] == pytest.approx((7 + 7) / 1e3 / 2)
    # kernels launched at 22.5, 24, 26.5 and 73 (the copy at 25 is not one)
    assert v["nms_kernels"] == 2.0
    # [23, 26] and [60, 62] start in submit; [33, 43] and [83, 93] do not
    assert v["sync_ms"] == pytest.approx((3 + 2) / 1e3 / 2)
    assert v["rig_hit_rate"] == pytest.approx(100.0 * 19 / 20)


def test_values_of_a_program_without_spans_are_none():
    tl, _ = _window()
    v = spans.values(tl, spans.Spans({}, {}), ({}, {}))
    assert v == dict.fromkeys(("upload_ms", "decode_enqueue_ms", "nms_kernels",
                               "sync_ms", "rig_hit_rate"))
    assert spans.program_counters(SimpleNamespace(_rows=[SimpleNamespace()])) == {}


def test_gaps_named_by_the_innermost_program_span():
    tl, sp = _window()
    gaps = spans.name_gaps(tl, sp)
    want = {("sgv3d.submit", "pb.submit"): 45, ("sgv3d.fetch.wait cudaStreamSynchronize",
                                                 "pb.window"): 26,
            ("sgv3d.upload", "pb.submit"): 5, ("sgv3d.decode", "pb.submit"): 2.5,
            ("sgv3d.decode.nms cudaStreamSynchronize", "pb.submit"): 1,
            ("sgv3d.decode.nms", "pb.submit"): 1}
    got = {(g[0], g[2]): float(g[1]) * 1e6 for g in gaps}
    assert sorted(got) == sorted(want)
    assert all(got[k] == pytest.approx(want[k]) for k in want)
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    # the same gaps as the benchmark's own breakdown, by the harness's names
    by_outer = {}
    for name, s, outer in gaps:
        by_outer[outer] = by_outer.get(outer, 0.0) + s
    harness = dict(trace.summary(tl)["breakdown"]["idle_gaps"])
    assert sorted(by_outer) == sorted(harness)
    assert all(by_outer[k] == pytest.approx(harness[k]) for k in harness)
    # no program span: the harness's range names the gap
    assert {g[0] for g in spans.name_gaps(tl, spans.Spans({}, {}))} == {
        "pb.submit", "pb.window"}


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny_bsm.serve", "tiny.ticks"])
def test_probe_on_the_tiny_cells(cell):
    out = spans.probe(cell, 3000000007, 0.4, "cpu", base=spec.HERE / "tests" / "data")
    assert out["summary_unchanged"] and out["failed"] == 0
    batches = out["summary"]["batches"]
    assert batches >= 1
    assert out["counters"]["after"]["batches"] - out["counters"]["before"]["batches"] == batches
    assert set(out["spans"].values()) == {batches}
    assert out["values"]["rig_hit_rate"] == 100.0 and out["values"]["sync_ms"] == 0.0
    assert out["values"]["upload_ms"] > 0 and out["values"]["nms_kernels"] is None
