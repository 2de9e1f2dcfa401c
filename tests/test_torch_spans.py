"""The port's own spans and counters (`train.profiling.span`): on only while
a `torch.profiler` runs, nested as the serving path's layers are, the
batch's sequence number on `submit` and `fetch`, decode's NMS loop visible
op by op, the lift's pick and pool apart, the static-rig cache's hits and
misses, and the `SimpleProfiler` sections as `sgv3d.train.*` ranges. On
the CPU, with the tiny serving exps; the card's `copy` and `fetch.wait`
spans are in `test_torch_cuda.py`.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import chip_smoke
from sgv3d_tpu_torch.api import BEVHeightPredictor
from sgv3d_tpu_torch.data.synthetic import make_batch
from sgv3d_tpu_torch.train import profiling
from sgv3d_tpu_torch.weights import seeded_state_dict

# each span of one batch on the CPU and the nearest span it nests in
PARENTS = {
    "sgv3d.submit": None,
    "sgv3d.upload": "sgv3d.submit",
    "sgv3d.rig_cells": "sgv3d.submit",
    "sgv3d.forward": "sgv3d.submit",
    "sgv3d.image": "sgv3d.forward",
    "sgv3d.lift": "sgv3d.forward",
    "sgv3d.lift.topk": "sgv3d.lift",
    "sgv3d.lift.splat": "sgv3d.lift",
    "sgv3d.head": "sgv3d.forward",
    "sgv3d.head.trunk": "sgv3d.head",
    "sgv3d.head.neck": "sgv3d.head",
    "sgv3d.head.shared_conv": "sgv3d.head",
    "sgv3d.head.branches": "sgv3d.head",
    "sgv3d.decode": "sgv3d.submit",
    "sgv3d.decode.rank": "sgv3d.decode",
    "sgv3d.decode.nms": "sgv3d.decode",
    "sgv3d.fetch": None,
    "sgv3d.collect": "sgv3d.fetch",
}


def _setup(is_bsm: bool):
    cfg = chip_smoke.tiny_serving_exp(4, is_bsm)
    imgs, mats, *_ = make_batch(cfg, batch=2, seed=1, num_objs=2)
    pred = BEVHeightPredictor(cfg, seeded_state_dict(cfg, seed=1), device="cpu")
    return cfg, pred, imgs, mats


def _serve(pred, imgs, mats, batches: int = 2):
    """`batches` batches, one kept in flight as `stream` does."""
    handles = [pred.submit(imgs, mats) for _ in range(batches)]
    return [pred.fetch(h) for h in handles]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        out = fn()
    return out, prof.events()


def _span_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("sgv3d."):
        p = p.cpu_parent
    return None if p is None else p.name


def _descendants(e):
    for child in e.cpu_children:
        yield child
        yield from _descendants(child)


def _same(a, b):
    for sa, sb in zip(a, b, strict=True):
        for da, db in zip(sa, sb, strict=True):
            for xa, xb in zip(da, db, strict=True):
                assert np.array_equal(xa, xb)


def test_no_profiler_enters_no_range(monkeypatch):
    """With no profiler running the spans never build a range, and the
    detections are bitwise those of a profiled run."""
    _, pred, imgs, mats = _setup(False)
    traced, _ = _profiled(lambda: _serve(pred, imgs, mats))

    def refuse(*_a, **_k):
        raise AssertionError("a range was entered with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _same(_serve(pred, imgs, mats), traced)


@pytest.mark.parametrize("is_bsm", [False, True], ids=["bevheight", "sgv3d"])
def test_every_span_once_a_batch_nested(is_bsm):
    _, pred, imgs, mats = _setup(is_bsm)
    _, events = _profiled(lambda: _serve(pred, imgs, mats, batches=3))
    spans = [e for e in events if e.name.startswith("sgv3d.")]
    assert sorted({e.name for e in spans}) == sorted(PARENTS)
    for name, parent in PARENTS.items():
        mine = [e for e in spans if e.name == name]
        assert len(mine) == 3, name
        assert {_span_parent(e) for e in mine} == {parent}, name
        for e in mine:      # inside its parent's interval
            p = e.cpu_parent
            while p is not None and p.name != parent:
                p = p.cpu_parent
            if parent is not None:
                assert p.time_range.start <= e.time_range.start
                assert e.time_range.end <= p.time_range.end


@pytest.mark.parametrize("top_k", [4, None], ids=["top_k", "all_bins"])
def test_lift_spans_split_the_pick_from_the_pool(top_k):
    """`sgv3d.lift` holds `sgv3d.lift.topk` (K1's pick of the bins and their
    cells) before `sgv3d.lift.splat` (K2's pooling); the all-bin lift picks
    nothing, so it opens the pool's span alone."""
    cfg = chip_smoke.tiny_serving_exp(top_k, True)
    imgs, mats, *_ = make_batch(cfg, batch=2, seed=1, num_objs=2)
    pred = BEVHeightPredictor(cfg, seeded_state_dict(cfg, seed=1), device="cpu")
    _, events = _profiled(lambda: _serve(pred, imgs, mats, batches=1))
    (lift,) = [e for e in events if e.name == "sgv3d.lift"]
    inner = [d for d in _descendants(lift) if d.name.startswith("sgv3d.")]
    want = ["sgv3d.lift.topk", "sgv3d.lift.splat"] if top_k else ["sgv3d.lift.splat"]
    assert [e.name for e in sorted(inner, key=lambda e: e.time_range.start)] == want
    (splat,) = [e for e in inner if e.name == "sgv3d.lift.splat"]
    assert [d for d in _descendants(splat) if d.name.startswith("aten::")]


def test_submit_and_fetch_carry_the_batch_sequence_number():
    _, pred, imgs, mats = _setup(False)
    pred.fetch(pred.submit(imgs, mats))         # batch 0, untraced
    _, events = _profiled(lambda: _serve(pred, imgs, mats, batches=2))
    seqs = {n: [e.kwinputs["seq"] for e in sorted(events, key=lambda e: e.time_range.start)
                if e.name == n] for n in ("sgv3d.submit", "sgv3d.fetch")}
    assert seqs == {"sgv3d.submit": [1, 2], "sgv3d.fetch": [1, 2]}
    assert pred.batches == 3
    # a child span carries none: it is its batch's by nesting
    assert all(not e.kwinputs for e in events if e.name == "sgv3d.forward")


@pytest.mark.parametrize("max_per_task", [12, 32, 10_000], ids=["k12", "k32", "k_hw"])
def test_nms_loop_is_three_bitwise_ops_a_step(max_per_task):
    """`sgv3d.decode.nms` holds, per step of circle_nms's loop, `&`, `~` and
    `&=`; before the loop two `&` build the suppression mask. The loop has
    k = min(max_per_task, H * W) steps."""
    cfg, _, imgs, mats = _setup(False)
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(cfg.head,
                                                            max_per_task=max_per_task))
    pred = BEVHeightPredictor(cfg, seeded_state_dict(cfg, seed=1), device="cpu")
    _, events = _profiled(lambda: _serve(pred, imgs, mats, batches=1))
    _, h, w, _ = pred.predict_heads(imgs, mats)[0]["heatmap"].shape
    k = min(max_per_task, h * w)
    (nms,) = [e for e in events if e.name == "sgv3d.decode.nms"]
    ops = [d.name for d in _descendants(nms)]
    assert (ops.count("aten::bitwise_and"), ops.count("aten::bitwise_not"),
            ops.count("aten::bitwise_and_")) == (k + 2, k, k)


def test_rig_cache_counts_hits_and_misses():
    _, pred, imgs, mats = _setup(False)
    row = pred._rows[0]
    assert (row.rig_hits, row.rig_misses) == (0, 0)
    pred.fetch(pred.submit(imgs, mats))
    assert (row.rig_hits, row.rig_misses) == (0, 1)
    pred.fetch(pred.submit(imgs, mats))
    assert (row.rig_hits, row.rig_misses) == (1, 1)
    moved = dict(mats, reference_heights=np.asarray(mats["reference_heights"]) + 0.5)
    pred.fetch(pred.submit(imgs, moved))
    assert (row.rig_hits, row.rig_misses) == (1, 2)
    pred.fetch(pred.submit(imgs, moved))
    assert (row.rig_hits, row.rig_misses) == (2, 2)


def test_simple_profiler_sections_are_train_spans():
    prof = profiling.SimpleProfiler()

    def run():
        for _ in range(2):
            with prof.profile("data_wait"):
                time.sleep(0.002)
        with prof.profile("step_dispatch"):
            pass

    _, events = _profiled(run)
    names = [e.name for e in events if e.name.startswith("sgv3d.")]
    assert sorted(names) == ["sgv3d.train.data_wait"] * 2 + ["sgv3d.train.step_dispatch"]
    assert dict(prof.counts) == {"data_wait": 2, "step_dispatch": 1}
    assert prof.totals["data_wait"] >= 0.004
    assert prof.totals["data_wait"] == pytest.approx(sum(prof.times["data_wait"]))


def test_span_off_is_one_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("submit", 3) is profiling.span("decode")
    with profiling.span("submit", 3) as got:
        assert got is None
