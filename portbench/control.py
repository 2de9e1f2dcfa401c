"""The control of `correct`: the plain reference at one precision step below
the configuration (`reference.precision`) put in the program's place, its
outputs decoded by the published rule (`reference.decode`) and judged
against the float32 reference by `compare`, exactly as a run judges the
program. It has to come out not correct on the cell's limits.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...] [--program S]

prints one JSON line a seed (the control's numbers and whether the cell's
limits pass them). It needs no window: each seed's sample is drawn from
the frames its run would serve first. With `--program S` it prints, for
each seed, the program's numbers from a run of S seconds at the cell's
own load instead: the readings the limits are set from, many seeds in one
process; with `--fault F` as well, those of the program with fault F of
`faults` planted under its `fetch`. The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import check, compare, inputs, spec
from portbench.faults import FAULTS, Broken
from portbench.reference.decode import decode_frame
from portbench.reference.precision import lowered
from portbench.traffic import Window


def control_numbers(cell: dict, seed: int, device: torch.device) -> dict:
    cfg, mix = cell["cfg"]["exp"], cell["mix"]
    b = mix["batch"]
    rigs = inputs.rigs(seed, b, cfg["backbone"]["final_dim"])
    pool = inputs.frame_pool(seed, mix["pool_batches"], b, cfg["backbone"]["final_dim"], device)
    from portbench.run import sample

    win = Window(batch=b, served={i: None for i in range(pool.shape[0])})
    picks = sample(win, seed, mix["check_frames"])
    frames = [pool[i, c, 0, 0] for i, c in picks]
    cams = [rigs[c] for _, c in picks]
    model = check.reference_model(cfg, seed, device)
    with lowered(model), torch.inference_mode():
        low = check.reference_outputs(model, frames, cams, device)
    served = [decode_frame(cfg["head"], p) for p in low]
    numbers = check.judge_sample(cfg, model, frames, cams, served, device)
    return {**numbers, "passes_limits": compare.judge(numbers, cell["limits"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", type=float, default=None, metavar="SECONDS")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload)
    for seed in a.seeds:
        if a.program is None:
            out = control_numbers(cell, seed, torch.device("cuda"))
        else:
            from portbench.run import run_cell

            wrap = None if a.fault is None else (lambda p: Broken(p, FAULTS[a.fault]))
            r = run_cell(a.workload, seed, a.program, False, "cuda", metrics=[], wrap=wrap)
            out = {k: c["value"] for k, c in r["checks"].items()}
            out["passes_limits"] = r["correct"]
        kind = "control" if a.program is None else a.fault or "program"
        print(json.dumps({"workload": a.workload, "seed": seed, "side": kind, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
