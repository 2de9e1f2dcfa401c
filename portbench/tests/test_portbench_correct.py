"""`correct` on the CPU at a tiny size: a sound run passes; the rest of a run
with the timed path broken underneath (half of each batch left out, an
answer altered where it is produced, two frames' answers swapped) fails;
the control (the reference one precision step down, in the program's
place) fails the tiny cells' limits, which were set between the two
readings here as the full cells' are on the card. A full cell runs on the
card alone (marked `cuda`)."""
from __future__ import annotations

import pytest
import torch

from portbench import control, run, spec
from portbench.faults import FAULTS, Broken

DATA = spec.HERE / "tests" / "data"
SEEDS = (3, 2**31 + 7, 424242)


def _run(workload, seed, fault=None):
    wrap = None if fault is None else (lambda p: Broken(p, FAULTS[fault]))
    return run.run_cell(workload, seed, 0.5, False, "cpu", metrics=[], base=DATA, wrap=wrap)


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny_bsm.serve", "tiny.ticks"])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct(workload, seed):
    r = _run(workload, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["tiny.serve", "tiny_bsm.serve"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    assert not _run(workload, SEEDS[0], fault)["correct"]


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny_bsm.serve"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(workload, seed):
    out = control.control_numbers(spec.cell(workload, DATA), seed, torch.device("cpu"))
    assert not out["passes_limits"], out


@pytest.mark.cuda
def test_a_full_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the full cells run on the card")
    r = run.run_cell("bevheight_r101.serve_b16", 11, 2.0, False, "cuda")
    assert r["correct"], r["checks"]
