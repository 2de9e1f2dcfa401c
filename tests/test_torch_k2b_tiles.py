"""K2b's 2-D tiling on the CPU: the feature map's width reaches the
backward from the training lift (all-bin and top-k, neither culled), the
wrapper refuses a width that does not divide HW, and chip_smoke's count of
distinct cells a tile (the card run's check on the kernel's staged share)
equals numpy's. The gradients with a width are those of `jax.vjp`
(`test_torch_train_modules.py::test_backward_plain_matches_jax_vjp`); the
kernel itself runs on the card (`test_torch_cuda.py`)."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from sgv3d_tpu_torch.data.synthetic import make_batch
from sgv3d_tpu_torch.nn import lss_fpn
from sgv3d_tpu_torch.ops.lift_splat import LiftSplat, lift_splat_backward


@pytest.mark.parametrize("top_k", [None, 4], ids=["all_bin", "top_k"])
def test_training_lift_passes_the_feature_width(monkeypatch, top_k):
    cfg = chip_smoke.tiny_exp()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, train_lift_top_k=top_k))
    bb = cfg.backbone
    _, mats, *_ = make_batch(cfg, 2, seed=0)
    m = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in mats.items()}
    f_h, f_w = bb.feat_hw
    g = torch.Generator().manual_seed(0)
    height = torch.softmax(torch.randn(2, f_h, f_w, bb.num_height_bins, generator=g), -1)
    feat = torch.randn(2, f_h, f_w, bb.output_channels, generator=g)
    seen = []
    apply = LiftSplat.apply
    monkeypatch.setattr(lss_fpn.LiftSplat, "apply",
                        lambda *a: seen.append(a[5:]) or apply(*a))
    bev = lss_fpn._lift_and_splat(bb, height.requires_grad_(), feat, m, 0, train=True)
    bev.sum().backward()
    assert seen == [(f_w,)]
    assert height.grad is not None and bool(height.grad.abs().sum() > 0)
    lss_fpn._lift_and_splat(bb, height.detach(), feat, m, 0, train=False)
    assert len(seen) == 1          # serving pools without the autograd function


def test_backward_refuses_a_width_that_does_not_divide_hw():
    n, j, hw, c, cells = 2, 3, 35, 4, 10
    args = (torch.zeros(1, cells, c), torch.zeros(n, j, hw), torch.zeros(n, hw, c),
            torch.zeros(n, j, hw, dtype=torch.int32), 1, cells)
    for feat_w in (6, 0, -7):
        with pytest.raises(ValueError, match="width"):
            lift_splat_backward(*args, feat_w=feat_w)
    for feat_w in (None, 7, 5, 35):
        d_h, d_c = lift_splat_backward(*args, feat_w=feat_w)
        assert d_h.shape == (n, j, hw) and d_c.shape == (n, hw, c)
    with pytest.raises(ValueError, match="served"):
        lift_splat_backward(*args, served=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("feat_w,tile", [(77, (8, 8)), (13, (4, 8)), (1001, (1, 64))])
def test_tile_distinct_cells_matches_numpy(feat_w, tile):
    rng = np.random.default_rng(feat_w)
    n, j, hw, num_cells = 3, 7, 1001, 50
    cells = rng.integers(-3, num_cells + 4, size=(n, j, hw)).astype(np.int32)
    distinct, points = chip_smoke.tile_distinct_cells(torch.from_numpy(cells),
                                                      num_cells, feat_w, tile)
    f_h = hw // feat_w
    t_y, t_x = -(-f_h // tile[0]), -(-feat_w // tile[1])
    ref_d, ref_p = [], []
    for cam in range(n):
        grid = cells[cam].reshape(j, f_h, feat_w)
        for ty in range(t_y):
            for tx in range(t_x):
                blk = grid[:, ty * tile[0]:(ty + 1) * tile[0],
                           tx * tile[1]:(tx + 1) * tile[1]]
                live = blk[(blk >= 0) & (blk < num_cells)]
                ref_d.append(len(np.unique(live)))
                ref_p.append(live.size)
    np.testing.assert_array_equal(distinct.numpy(), ref_d)
    np.testing.assert_array_equal(points.numpy(), ref_p)
