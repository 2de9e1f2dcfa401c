"""Finding the benchmark's parts by name: a cell's file under `workloads/`,
the configuration under `configs/` and the traffic mix under `mixes/` that
it names, the metrics `BENCHMARK.json` gives the cell, and each metric's
reader under `metrics/<name>.py`. Adding a cell, a configuration, a mix
or a metric is adding files and entries; no file here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
H100_BF16_FLOPS = 989e12      # NVIDIA H100 SXM, dense bf16 (data sheet)
H100_HBM_BYTES = 3.35e12      # NVIDIA H100 SXM, HBM3 bytes/s (data sheet)


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def cell(name: str, base: Path = HERE) -> dict:
    """The cell's workload file, with its configuration and its mix (the
    cell's `params` over the mix's own) resolved; `base` holds the three
    folders (tests give their own)."""
    w = load_json("workloads", name, base)
    mix = load_json("mixes", w["traffic"], base)
    return {**w, "cfg": load_json("configs", w["config"], base),
            "mix": {**mix, **w.get("params", {})}}


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_names(workload: str, trace: bool, bench: dict | None = None) -> list[str]:
    """The metrics this cell reports: with `trace`, its per-layer metrics,
    else its end-to-end ones."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return [m["name"] for m in e2e]
    mine = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in mine else [])]


def reader(name: str):
    """The `read(run)` of metric `name`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
