"""The configuration `sgv3d_r101_256` (SGV3D's r101 at 180 height bins on a
256x256 BEV grid) and its cell on the CPU: the file is the program's exp,
the reference's weights are the program's, its FLOPs and the lift's bytes
follow from its shapes; and `correct` at a tiny size with the same wide
lift (`tiny_bsm_wide`: 180 bins, top-16, voxels halved): a sound run
passes, each planted fault and the control fail, on limits set between
the readings as the tiny cells' were. The full cell runs on the card alone
(marked `cuda`)."""
from __future__ import annotations

import pytest
import torch

from portbench import control, flops, program, run, spec
from portbench.faults import FAULTS
from portbench.reference.model import Detector
from portbench.tests.test_portbench_correct import DATA, SEEDS, _run

CONFIG = "sgv3d_r101_256"
CELL = "sgv3d_r101_256.serve_b16"
WIDE = "tiny_bsm_wide.serve"


def test_the_file_is_the_programs_exp():
    from sgv3d_tpu_torch.configs import get_exp

    cfg = spec.load_json("configs", CONFIG)
    assert program.exp_config(cfg["exp"]) == get_exp(CONFIG)
    bc = cfg["exp"]["backbone"]
    assert (bc["resnet_depth"], bc["d_bound"][2], bc["lift_top_k"], bc["is_bsm"]) == (
        101, 180, 16, True)
    assert cfg["reduced"] == [] and cfg["serving"] == spec.load_json(
        "configs", "sgv3d_r50_128")["serving"]


def test_state_dict_is_the_programs():
    from sgv3d_tpu_torch.models.bev_height import BEVHeight

    cfg = spec.load_json("configs", CONFIG)
    with torch.device("meta"):
        ours = Detector(cfg["exp"]).state_dict()
        theirs = BEVHeight(program.exp_config(cfg["exp"])).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}


def test_flops_recomputed_from_shapes():
    cfg = spec.load_json("configs", CONFIG)
    assert flops.model_flops(cfg["exp"]) == cfg["flops_per_image"]


def test_lift_bytes_by_hand():
    cfg = spec.load_json("configs", CONFIG)["exp"]
    bc = cfg["backbone"]
    h, w, d, k, c, cells = 108, 192, 180, 16, 87, 256 * 256
    assert flops.feat_hw(bc) == (h, w) and flops.num_cells(bc) == cells
    assert flops.lifted_channels(bc) == c
    kept = 15000
    want = 16 * (4 * (h * w * (d + c) + kept * (d + 2 * k)) + 4 * cells * c)
    assert flops.lift_bytes(cfg, 16, kept) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_wide_run_is_correct(seed):
    r = _run(WIDE, seed)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_wide_run_is_not_correct(fault):
    assert not _run(WIDE, SEEDS[0], fault)["correct"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_wide_control_is_not_correct(seed):
    out = control.control_numbers(spec.cell(WIDE, DATA), seed, torch.device("cpu"))
    assert not out["passes_limits"], out


@pytest.mark.cuda
def test_the_full_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the full cells run on the card")
    r = run.run_cell(CELL, 2**31 + 24, 2.0, False, "cuda")
    assert r["correct"], r["checks"]
