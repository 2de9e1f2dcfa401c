"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for (none: exit 2, no result). Set-up (imports, the seeded weights drawn
on the card, the predictor, the inputs, the warm-up of the cell's own
shapes) is timed as `setup_s`; the mix's loop then runs for `--seconds`
(with `--trace 1`, for the mix's `trace_seconds` under `torch.profiler`,
with a range around each call and layer); after it the peak memory is
read, the program is freed and the plain reference judges a seeded
sample of the frames served (`check`, `compare`). Earlier lines carry
the card, the set-up's parts, the kernels' launches and the sample;
the numbers compared, each beside its limit, are the last lines on
standard error and the last key of the result, which is the last line on
standard output.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench.spec import ROOT  # noqa: E402

BLOCKED = ("jax", "jaxlib", "flax", "sgv3d_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own nvcc build is `build/kernels/` there already)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def blocked_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BLOCKED))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def warm_up(pred, pool, mats, batches: int) -> None:
    """The window's own calls on its own shapes, one batch kept in flight."""
    handles = []
    for i in range(batches):
        handles.append(pred.submit(pool[i % pool.shape[0]].numpy(), mats))
        if len(handles) == 2:
            pred.fetch(handles.pop(0))
    for h in handles:
        pred.fetch(h)


def sample(win, seed: int, count: int) -> list[tuple[int, int]]:
    """A seeded sample of the served frames as (batch index, camera)."""
    import numpy as np

    frames = [(b, c) for b in sorted(win.served) for c in range(win.batch)]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 2])
    pick = rng.choice(len(frames), size=min(count, len(frames)), replace=False)
    return [frames[i] for i in sorted(pick)]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             metrics: list[str] | None = None, base=None, wrap=None) -> dict:
    """One run of cell `name`; returns the result line's object. `wrap`
    (tests) takes the predictor and returns what the window calls."""
    import torch
    from torch.autograd.profiler import record_function

    from portbench import check, compare, flops, inputs, program, spec, weights
    from portbench import trace as tracing
    from portbench.reference.model import Detector
    from portbench.traffic import LOOPS

    t_import = time.perf_counter()
    cell = spec.cell(name, base or spec.HERE)
    cfg, mix = cell["cfg"], cell["mix"]
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    b = mix["batch"]
    with torch.device("meta"):
        shapes = weights.names_shapes(Detector(cfg["exp"]))
    drawn = weights.draw(shapes, seed, dev)
    sync()
    t_weights = time.perf_counter()
    pred = program.predictor(cfg, drawn, dev)
    del drawn
    sync()
    t_model = time.perf_counter()
    rigs = inputs.rigs(seed, b, cfg["exp"]["backbone"]["final_dim"])
    mats = inputs.batch_mats(rigs)
    pool = inputs.frame_pool(seed, mix["pool_batches"], b,
                             cfg["exp"]["backbone"]["final_dim"], dev)
    t_inputs = time.perf_counter()
    warm_up(pred, pool, mats, mix["warmup_batches"])
    sync()
    t_warm = time.perf_counter()
    setup = {"imports_s": t_import - PROCESS_START, "weights_s": t_weights - t_import,
             "model_s": t_model - t_weights, "inputs_s": t_inputs - t_model,
             "warmup_s": t_warm - t_inputs}
    print("# setup " + json.dumps(setup), flush=True)

    served = wrap(pred) if wrap else pred
    counters = program.kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    loop = LOOPS[mix["loop"]]
    summary = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with program.layer_ranges(pred.model), torch.profiler.profile(activities=acts) as prof:
            with record_function("pb.window"):
                win = loop(served, pool, mats, min(seconds, mix["trace_seconds"]), **mix)
            sync()
        t = time.perf_counter()
        summary = tracing.summary(tracing.from_profiler(prof))
        breakdown = summary.pop("breakdown")
        print(f"# trace reduced in {time.perf_counter() - t:.3f} s", flush=True)
    else:
        win = loop(served, pool, mats, seconds, **mix)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    print("# kernel launches over the window: "
          + json.dumps({k: fn.launches for k, fn in counters.items()}), flush=True)
    del pred, served
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    picks = sample(win, seed, mix["check_frames"])
    model = check.reference_model(cfg["exp"], seed, dev)
    numbers = check.judge_sample(
        cfg["exp"], model, [pool[i % pool.shape[0], c, 0, 0] for i, c in picks],
        [rigs[c] for _, c in picks], [win.served[i][c] for i, c in picks], dev)
    lift = None
    if trace:
        lift = flops.lift_bytes(cfg["exp"], b, check.kept_pixels(cfg["exp"], rigs, dev))
    print(f"# reference over {len(picks)} frames in {time.perf_counter() - t:.3f} s",
          flush=True)
    limits = cell["limits"]
    correct = (win.failed == 0 and win.completed > 0 and len(picks) > 0
               and compare.judge(numbers, limits))

    run = SimpleNamespace(window=win, setup_s=t_warm - PROCESS_START, setup=setup,
                          trace=summary, cfg=cfg, mix=mix, lift_bytes=lift)
    names = metrics if metrics is not None else spec.metric_names(name, trace)
    units = {m["name"]: m["unit"] for m in _bench_metrics()} if metrics is None else {}
    values = {}
    for m in names:
        v = spec.reader(m)(run)
        if v is not None:
            values[m] = {"value": float(v), "unit": units.get(m, "")}
    result = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
              "metrics": values,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def _bench_metrics() -> list[dict]:
    from portbench.spec import benchmark

    bench = benchmark()
    return bench["end_to_end"] + bench["per_layer"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_dirs()
    from portbench import spec

    cell = spec.cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    print(f"# card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    found = blocked_modules()
    if found:
        print(f"portbench: modules loaded that the port may not use: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
