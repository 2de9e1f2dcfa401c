"""The harness on the CPU: every part found by name, BENCHMARK.json's shape,
the metric arithmetic on synthetic timelines, the FLOP and byte counts
from shapes, and no module of JAX or the JAX package in a run.

    python -m pytest -q -p no:cacheprovider portbench/tests
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import flops, readers, spec, trace, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved), m["name"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found_by_name(workload):
    cell = spec.cell(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert cell["mix"]["loop"] in traffic.LOOPS
    assert set(cell["limits"]) == {"sound_gap", "sound_ratio", "miss_gap", "nms_pairs"}
    for trace_run in (False, True):
        for name in spec.metric_names(workload, trace_run):
            assert callable(spec.reader(name))
    assert "setup_s" in spec.metric_names(workload, False)
    assert spec.metric_names(workload, True)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = spec.load_json("configs", config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == config for w in BENCH["workloads"])


def _window(**kw):
    w = traffic.Window(batch=16)
    for k, v in kw.items():
        setattr(w, k, v)
    return w


def test_rate_over_the_whole_window():
    run = SimpleNamespace(window=_window(start=10.0, end=12.5, completed=160))
    assert spec.reader("serve_images_per_s")(run) == pytest.approx(64.0)
    assert spec.reader("serve_images_per_s")(SimpleNamespace(window=_window())) is None


def test_p95_over_all_ticks_counts_failures_last():
    lat = [0.1 + 0.001 * i for i in range(99)] + [traffic.FAILED_LATENCY_S]
    run = SimpleNamespace(window=_window(latency_s=lat))
    p95 = spec.reader("frame_latency_p95_ms")(run)
    assert p95 == pytest.approx(np.percentile(np.array(lat) * 1e3, 95))
    ok = SimpleNamespace(window=_window(latency_s=lat[:-1]))
    assert p95 > spec.reader("frame_latency_p95_ms")(ok)
    late = [traffic.FAILED_LATENCY_S] * 6 + lat[:94]
    assert spec.reader("frame_latency_p95_ms")(
        SimpleNamespace(window=_window(latency_s=late))) > 1e6


def _timeline():
    """Window [0, 100] us; two batches. Batch 1: submit [0, 30], forward
    [1, 25], backbone [2, 20], image child [3, 10], head [21, 24]. Device
    events: kernels and one copy, overlapping at 40-50."""
    ranges = {"pb.window": ([0.0], [100.0]),
              "pb.submit": ([0.0, 50.0], [30.0, 80.0]),
              "pb.forward": ([1.0, 51.0], [25.0, 75.0]),
              "pb.backbone": ([2.0, 52.0], [20.0, 70.0]),
              "pb.image:img_backbone": ([3.0, 53.0], [10.0, 60.0]),
              "pb.head": ([21.0, 71.0], [24.0, 74.0])}
    ranges = {k: (np.array(a), np.array(b)) for k, (a, b) in ranges.items()}
    # (launch, start, end, copy)
    ev = [(4, 10, 20, False),     # image
          (15, 20, 30, False),    # lift (backbone, not image)
          (22, 30, 45, False),    # head
          (26, 40, 50, False),    # decode (submit, not forward)
          (27, 42, 48, True),     # a copy in decode: busy, not decode_ms
          (54, 60, 64, False),    # image, batch 2
          (90, 95, 99, False)]    # outside any submit
    a = np.array([e[:3] for e in ev], float)
    return trace.Timeline(ranges=ranges, launch=a[:, 0], start=a[:, 1], end=a[:, 2],
                          names=[f"k{i}" for i in range(len(ev))],
                          copy=np.array([e[3] for e in ev]))


def test_self_time_is_a_range_less_its_children():
    s = trace.summary(_timeline())
    assert s["batches"] == 2
    assert s["image_ms"] == pytest.approx((10 + 4) / 1e3 / 2)
    assert s["lift_ms"] == pytest.approx(10 / 1e3 / 2)
    assert s["head_ms"] == pytest.approx(15 / 1e3 / 2)
    assert s["decode_ms"] == pytest.approx(10 / 1e3 / 2)
    assert s["dispatch_ms"] == pytest.approx(30 / 1e3)


def test_idle_share_is_the_union_of_device_intervals():
    s = trace.summary(_timeline())
    # busy: [10, 50] (overlaps merged), [60, 64], [95, 99]
    assert s["busy_s"] == pytest.approx((40 + 4 + 4) / 1e6)
    assert s["window_s"] == pytest.approx(100 / 1e6)
    run = SimpleNamespace(trace=s)
    assert readers.idle_share(run) == pytest.approx(52.0)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(52 / 1e6)
    # gaps by the host's innermost range at their midpoints: [0, 10] and
    # [50, 60] in the image ranges, [64, 95] in submit, [99, 100] the window
    assert gaps["pb.image:img_backbone"] == pytest.approx(20 / 1e6)
    assert gaps["pb.submit"] == pytest.approx(31 / 1e6)
    assert gaps["pb.window"] == pytest.approx(1 / 1e6)


def test_a_layer_with_no_kernel_reads_nothing():
    tl = _timeline()
    tl.ranges.pop("pb.head")
    assert trace.summary(tl)["head_ms"] is None


@pytest.mark.parametrize("config", ["bevheight_dair_r101_128", "sgv3d_r50_128"])
def test_flops_recomputed_from_shapes(config):
    cfg = spec.load_json("configs", config)
    assert flops.model_flops(cfg["exp"]) == cfg["flops_per_image"]


def test_conv_flops_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        conv = torch.nn.Conv2d(64, 32, 3, padding=1)
        x = torch.empty(2, 64, 10, 12)
    counter = FlopCounterMode(display=False)
    with counter:
        conv(x)
    assert counter.get_total_flops() == 2 * 2 * 32 * 64 * 9 * 10 * 12


def test_lift_bytes_by_hand():
    cfg = spec.load_json("configs", "bevheight_dair_r101_128")["exp"]
    h, w, d, k, c, cells = 54, 96, 90, 16, 80, 128 * 128
    kept = 4000
    want = 16 * (4 * (h * w * (d + c) + kept * (d + 2 * k)) + 4 * cells * c)
    assert flops.lift_bytes(cfg, 16, kept) == want
    bsm = spec.load_json("configs", "sgv3d_r50_128")["exp"]
    assert flops.feat_hw(bsm["backbone"]) == (108, 192)
    assert flops.lifted_channels(bsm["backbone"]) == 87


def test_mfu_and_roofline_arithmetic():
    cfg = {"flops_per_image": 989e9}
    run = SimpleNamespace(trace={"window_s": 2.0, "device_events": 5, "lift_ms": 1.0},
                          window=_window(completed=200), cfg=cfg, lift_bytes=3.35e9 / 2)
    assert readers.mfu(run) == pytest.approx(100.0 * 989e9 * 100 / 989e12)
    assert readers.lift_roofline(run) == pytest.approx(50.0)
    assert math.isfinite(readers.mfu(run))


BLOCKED_PROBE = r"""
import sys
from portbench import run, spec, control
import torch
base = spec.HERE / "tests" / "data"
run.run_cell("tiny.serve", 7, 0.3, True, "cpu", metrics=["serve.dispatch_ms"], base=base)
control.control_numbers(spec.cell("tiny_bsm.serve", base), 7, torch.device("cpu"))
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_no_jax_module_in_a_run():
    out = subprocess.run([sys.executable, "-c", BLOCKED_PROBE], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "sgv3d_tpu"}
    assert "sgv3d_tpu_torch" in tops and "portbench" in tops


def test_no_card_exits_without_a_result(capsys):
    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "bevheight_r101.serve_b16", "--seed", "3000000007",
                     "--seconds", "30", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_blocked_modules_compare_whole_top_level_names(monkeypatch):
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "sgv3d_tpu_torch_probe", types.ModuleType("x"))
    assert "sgv3d_tpu" not in run.blocked_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "sgv3d_tpu.ops", types.ModuleType("x"))
    assert run.blocked_modules() == ["jaxlib", "sgv3d_tpu"]
