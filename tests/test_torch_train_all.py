"""Training and evaluating every exp at its own batch, on the CPU at tiny
sizes (the card runs it at full width: `chip_smoke.phase_train_wide` and
`chip_smoke.py --train-all`):

- the fake root in the DAIR-V2X-I and Rope3D layouts
  (`write_fake_kitti_root(layout=...)`): the JAX package's readers find
  the same info files, GT directory and calibrations in it as the port's,
  and its train set gives the same items bitwise; the calibration the
  evaluator reads back is the camera the infos carry;
- `chip_smoke.train_lift_cells`: the cells of `runner.train`'s first
  batch, as the first training call of K2 receives them;
- `chip_smoke.lift_stepped` / `hold_lift_step`, the float32 step with the
  lift's kernels against the same step with K2b's plain version (and the
  metrics against the step with both plain versions): it passes where
  the steps are the same function and requires that its gates fail a
  lift backward whose height gradient is 2% off (`faulty_backward`);
- `chip_smoke.train_all_runs` through `checked_runs`, one exp of each
  layout trained and evaluated by the CLI in one process, the kept boxes
  through the KITTI writer (`kitti_probe`), and `train_eval_row`'s gates;
  `runner_stats` only around the runs flagged for it.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from sgv3d_tpu import runner as jax_runner
from sgv3d_tpu.data import dataset as jax_dataset
from sgv3d_tpu.evalkit.evaluator import RoadSideEvaluator as JaxEvaluator
from sgv3d_tpu_torch import runner
from sgv3d_tpu_torch.data import dataset as port_dataset
from sgv3d_tpu_torch.data.synthetic import write_fake_kitti_root
from sgv3d_tpu_torch.evalkit.evaluator import RoadSideEvaluator
from sgv3d_tpu_torch.weights import seeded_state_dict
from tests.test_torch_data import _assert_same
from tests.tiny_configs import tiny_exp
from tests.torch_port_util import shared_jax_compiles  # noqa: F401 (autouse)

SRC_HW = (216, 384)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("layout", ["dair-v2x-i", "rope3d"])
def test_fake_root_layouts_read_alike_by_jax_and_port(tmp_path, layout):
    root = write_fake_kitti_root(tmp_path / layout, 3, src_hw=SRC_HW, seed=2,
                                 layout=layout)
    cfg = tiny_exp()
    assert runner.default_info_paths(cfg, root) == jax_runner.default_info_paths(cfg, root)
    train_info, _ = runner.default_info_paths(cfg, root)
    assert train_info.endswith(("dair_12hz_infos_train.pkl", "rope3d_12hz_infos_train.pkl"))
    gt = runner.default_gt_label_path(root)
    assert gt == jax_runner.default_gt_label_path(root)
    kw = dict(classes=cfg.classes, data_root=root, info_path=train_info, is_train=True,
              max_objs=cfg.head.max_objs, seed=4, device_normalize=True)
    conf = cfg.ida_aug_conf | {"H": SRC_HW[0], "W": SRC_HW[1]}
    port = port_dataset.RoadSideDataset(conf, **kw)
    ref = jax_dataset.RoadSideDataset(conf, **kw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        _assert_same(port[i], ref[i], f"item {i}")
    read = RoadSideEvaluator(cfg.classes, ["Car"], root, gt)._calib_provider()
    read_jax = JaxEvaluator(cfg.classes, ["Car"], root, gt)._calib_provider()
    for i, info in enumerate(port.infos):
        sid, velo2cam, k34 = read(info["sample_token"])
        sid_j, velo2cam_j, k34_j = read_jax(info["sample_token"])
        assert sid == sid_j == i
        np.testing.assert_array_equal(velo2cam, velo2cam_j)
        np.testing.assert_array_equal(k34, k34_j)
        # the GT lines and the predictions go through the camera the infos carry
        sensor = info["cam_infos"]["CAM_FRONT"]["calibrated_sensor"]
        s2e = np.eye(4)
        s2e[:3, :3] = sensor["rotation_matrix"]
        s2e[:3, 3] = sensor["translation"]
        np.testing.assert_allclose(velo2cam @ s2e, np.eye(4), atol=1e-6)
        np.testing.assert_allclose(k34[:, :3], sensor["camera_intrinsic"], rtol=1e-6)
        assert (tmp_path / gt / f"{i:06d}.txt").exists()


def test_a_layout_root_must_carry_its_name(tmp_path):
    with pytest.raises(ValueError, match="ends in 'rope3d'"):
        write_fake_kitti_root(tmp_path / "somewhere", 1, src_hw=SRC_HW, layout="rope3d")
    with pytest.raises(ValueError, match="layout"):
        write_fake_kitti_root(tmp_path / "x", 1, src_hw=SRC_HW, layout="nuscenes")


def _tiny(name: str, layout: str, batch: int = 2):
    is_bsm = name.startswith("sgv3d")
    return dataclasses.replace(chip_smoke.tiny_exp(is_bsm), name=name,
                               data_root=f"data/{layout}", batch_size_per_device=batch,
                               src_hw=SRC_HW)


@pytest.fixture
def small_roots(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TRAIN_ROOTS", tmp_path / "roots")
    monkeypatch.setattr(chip_smoke, "TRAIN_ROOT_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_ROOT_HW", SRC_HW)
    return tmp_path / "roots"


def test_train_lift_cells_are_the_first_training_batch(small_roots, tmp_path):
    from sgv3d_tpu_torch.ops import lift_splat

    cfg = _tiny("bevheight_rope3d_r101_256", "rope3d")
    cells = chip_smoke.train_lift_cells(cfg, 2)
    inputs = {}
    with chip_smoke.first_call_inputs(lift_splat, "lift_splat_forward", inputs):
        runner.train(cfg, data_root=chip_smoke.train_root("rope3d"),
                     output_dir=str(tmp_path / "out"), max_steps=1, device="cpu",
                     backup=False)
    height, _, got, batch, num_cells = inputs["lift_splat_forward"]
    assert batch == 2 and cells.shape == got.shape == height.shape
    assert torch.equal(cells, got)
    assert 0 < int((cells < num_cells).sum()) < cells.numel()


@pytest.fixture(scope="module")
def planted_step():
    cfg = chip_smoke.tiny_exp(False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return chip_smoke.lift_stepped(cfg, seeded_state_dict(cfg, seed=5),
                                       chip_smoke._train_batch(cfg, 2, seed=3),
                                       torch.device("cpu"), fault=chip_smoke.LIFT_FAULT)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("planted", [True, False], ids=["planted", "none"])
def test_lift_step_gate_sees_a_backward_fault(planted_step, planted):
    """On the CPU the step with the kernels runs their plain versions too,
    so it is the reference's bits and the plain step's (gate excess 0).
    `lift_stepped(fault=)` + `hold_lift_step`, as the card's
    `wide_step_against_plain` runs them: the step with the kernels passes
    and the step with `faulty_backward(LIFT_FAULT)` must fail the same
    gates; with the step with the kernels in the fault's place (no fault)
    the check raises. The held leaves' spread and loose share are
    reported."""
    stepped = planted_step
    assert stepped["launches"] == {"kernels": [0, 0], "reference": [[0, 0]] * 5,
                                   "faulty": [0, 0], "plain": [0, 0]}
    assert stepped["reference_steps"] == 5  # K2b's plain version and four other orders
    assert stepped["faulty"]["jax_grads"] is stepped["jax_grads"]
    if not planted:
        with pytest.raises(AssertionError, match="gates pass a backward"):
            chip_smoke.hold_lift_step({**stepped, "faulty": stepped})
        return
    held = chip_smoke.hold_lift_step(stepped)
    assert held["gate_excess"] == 0.0 and held["fault_excess"] > 1.0
    assert held["fault"] == chip_smoke.LIFT_FAULT
    assert held["plain_metric_excess"] == 0.0 and held["plain_grad_dev"] == 0.0
    assert 0.0 <= held["loose_share"] <= 1.0
    assert 0 < held["checked_leaves"] < len(stepped["grads"])


def test_plain_lift_in_other_orders_is_the_same_lift():
    """`plain_lift(seed)`: the plain forward and backward on inputs whose
    bins, pixels and channels are permuted alike, outputs permuted back,
    agree with `plain_lift()`'s within float32 rounding (trash cells and
    a second batch element included); `plain_lift(seed, forward=False)`
    replaces the backward alone."""
    from sgv3d_tpu_torch.ops import lift_splat

    gen = torch.Generator().manual_seed(0)
    n, j, hw, c, cells_n = 4, 6, 20, 8, 30
    height = torch.rand(n, j, hw, generator=gen)
    ctx = torch.randn(n, hw, c, generator=gen)
    cells = torch.randint(-3, cells_n + 3, (n, j, hw), generator=gen, dtype=torch.int32)
    grad = torch.randn(2, cells_n, c, generator=gen)
    forward, backward, outs = lift_splat.lift_splat_forward, lift_splat.lift_splat_backward, []
    for seed in (None, 1):
        with chip_smoke.plain_lift(seed):
            outs.append((lift_splat.lift_splat_forward(height, ctx, cells, 2, cells_n),
                         *lift_splat.lift_splat_backward(grad, height, ctx, cells, 2,
                                                         cells_n, hw)))
    with chip_smoke.plain_lift(1, forward=False):
        assert lift_splat.lift_splat_forward is forward
        assert lift_splat.lift_splat_backward is not backward
        backward_only = lift_splat.lift_splat_backward(grad, height, ctx, cells, 2, cells_n, hw)
    assert lift_splat.lift_splat_forward is forward
    assert lift_splat.lift_splat_backward is backward
    for got, ref in zip(outs[1] + backward_only, outs[0] + outs[1][1:]):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_deterministic_algorithms_are_restored():
    """`deterministic_algorithms`: cuDNN's and torch's deterministic
    algorithms on within the block, the process's settings back after it,
    also when the block raises."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.deterministic_algorithms():
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.is_deterministic_algorithms_warn_only_enabled()
            assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
            raise RuntimeError("inside")
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == saved


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_train_all_runs_train_and_evaluate_each_layout(small_roots, monkeypatch, tmp_path,
                                                       capsys):
    """One exp of each layout through `train_all_runs` (the CLI trains, then
    evaluates the step's checkpoint) in one `checked_runs` process, each
    run's first kernel calls held and, flagged, its loop's timing and the
    evaluation's kept boxes through the KITTI writer (`kitti_probe`) kept
    by `runner_stats`; `train_eval_row` passes them and fails a run whose
    step's checkpoint is missing or whose kept boxes wrote no line. The
    CPU launches nothing, so the training lift's two wrappers count their
    calls here as the card's count their launches."""
    import sgv3d_tpu_torch.configs as configs
    from sgv3d_tpu_torch.ops import lift_splat

    def counting(fn):
        def call(*args, **kw):
            call.launches += 1
            return fn(*args, **kw)
        call.launches = 0
        return call

    for name in ("lift_splat_forward", "lift_splat_backward"):
        monkeypatch.setattr(lift_splat, name, counting(getattr(lift_splat, name)))

    exps = {"bevheight_dair_r18_128": "dair-v2x-i", "bevheight_rope3d_r50_128": "rope3d",
            "sgv3d_r101_256": "rope3d-kitti"}
    monkeypatch.setattr(configs, "get_exp", lambda name: _tiny(name, exps[name]))
    monkeypatch.setattr(chip_smoke, "TRAIN_ALL_STEPS", 2)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    runs = chip_smoke.train_all_runs(tuple(exps))
    assert [(exp, argv[1] if len(argv) > 1 else None) for exp, _, argv in runs][::2] == [
        (exp, "--data_root") for exp in exps]
    out = tmp_path / "runs.json"
    chip_smoke.checked_runs(str(out), [(m, argv + ["--device", "cpu"], {}, True)
                                       for _, m, argv in runs])
    records = json.loads(out.read_text())

    def row(i, exp, train, ev):
        return chip_smoke.train_eval_row(exp, small_roots / "all" / exp, 2, train, ev,
                                         "cpu", "[train-all]")

    rows = {exp: row(i, exp, records[2 * i], records[2 * i + 1])
            for i, exp in enumerate(exps)}
    printed = capsys.readouterr().out
    assert printed.count("[train-all]") == 3 and "not measured (no card)" in printed
    for exp, got in rows.items():
        assert got["batch"] == 2 and len(got["losses"]) == 2
        assert np.isfinite(got["losses"]).all() and got["ms_per_step"] > 0
        assert got["launches_per_step"] == {"lift_splat": 1, "lift_splat_bwd": 1}
        assert got["eval_batches"] == 2 and got["peak_mem_gib"] is None
        probe = got["kitti_probe"]
        assert 0 < probe["lines"] == probe["expected"] <= probe["boxes"]
        assert 0.0 < probe["max_score"] < 1.0 and probe["round_trip"] <= 1e-3
        assert got["checked"]["lift_splat_bwd_max_abs_err"] == 0.0
    assert [r["launches"]["lift_splat"] for r in records] == [2, 0] * 3
    assert "kitti_probe" not in records[0] and "kitti_probe" in records[1]
    silent = dict(records[1], kitti_probe=dict(records[1]["kitti_probe"], lines=0,
                                                expected=0))
    with pytest.raises(AssertionError, match="through the KITTI writer"):
        row(0, "bevheight_dair_r18_128", records[0], silent)
    ckpts = small_roots / "all" / "bevheight_dair_r18_128" / "checkpoints"
    (ckpts / "2").rename(ckpts / "moved")
    with pytest.raises(AssertionError, match="checkpoints"):
        row(0, "bevheight_dair_r18_128", records[0], records[1])


@pytest.mark.parametrize("counted", [False, True], ids=["plain", "flagged"])
def test_checked_runs_count_only_flagged_runs(counted, monkeypatch, tmp_path):
    """A run without the flag goes through `checked_runs` as before: the
    runner and the evaluator it sees are the package's own and its record
    has no `runner_stats` keys; a flagged run sees them wrapped and has
    them. Either way they are the package's own after the run."""
    from sgv3d_tpu_torch.evalkit.evaluator import RoadSideEvaluator

    (tmp_path / "seen_by_run.py").write_text(
        "from sgv3d_tpu_torch import runner\n"
        "from sgv3d_tpu_torch.evalkit.evaluator import RoadSideEvaluator\n"
        "print(runner.train.__qualname__, RoadSideEvaluator.evaluate.__qualname__)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    evaluate, train = RoadSideEvaluator.evaluate, runner.train
    out = tmp_path / "runs.json"
    chip_smoke.checked_runs(str(out), [("seen_by_run", [], {}, counted)])
    (record,) = json.loads(out.read_text())
    seen = record["stdout"].split()
    if counted:
        assert seen == ["runner_stats.<locals>.timed.<locals>.call",
                        "runner_stats.<locals>.probed"]
        assert {"launches", "launches_per_step"} <= set(record)
    else:
        assert seen == ["train", "RoadSideEvaluator.evaluate"]
        assert set(record) == {"module", "stdout", "checked", "seconds"}
    assert RoadSideEvaluator.evaluate is evaluate and runner.train is train
