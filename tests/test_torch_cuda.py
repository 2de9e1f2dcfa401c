"""The port's CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on a machine with a card and no jax:
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
Here, without a card, every test skips (the `cuda_device` fixture decides
at run time). K1 must be exact; K2 within 1e-5 * max|ref| + 1e-6 (the sums
run in another order than `index_add_`) and bitwise equal across runs, its
prep's order exactly that of `torch.sort(stable=True)`, its launches those
of its radix passes; K3
within 2e-2 * max|plain| (y1 and y2 rounded to bf16 after sums in another
order) and bitwise equal across runs, its padding exact; K4 bitwise equal
to its plain version (zero rows for indices outside [0, HW); the one-hot's
-0.0 as +0.0 and NaN from 0 x inf) and across runs; K2b (the lift's
backward) within 1e-5 * max|ref| + 1e-6 of `lift_splat_backward_plain` and
bitwise equal across runs, one launch a call, on uniform, one-cell, rig and
ragged cells; K2 and K2b bitwise the same for a frame alone and inside a
batch. K1's bins (the top-k
training lift) exact, ties to the lowest bin; the top-k training lift's
gradients (K1 with bins, K2, K2b) card vs CPU within 1e-5 of scale, the
same bins picked; the tiny SAM encoder card vs CPU within 1e-4 of scale;
two gloo ranks sharing the card take the tiny train steps of one process
on the concatenated batch, under the train step's gates; `voxel_pooling`
(K2 and K2b at J = 1) within 1e-5 of scale of its plain version, its
gradient exactly the plain one's, bitwise equal across calls. The
serving path's spans on the card: the copy and its wait, no device event
of their own, three kernels a step of decode's NMS loop.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sgv3d_tpu_torch.ops.fused_bottleneck import (
    FoldedBottleneck, fused_bottleneck, fused_bottleneck_plain)
from sgv3d_tpu_torch.ops.lift_splat import (
    LiftSplat, TopkCells, lift_splat_backward, lift_splat_backward_plain,
    lift_splat_forward, lift_splat_plain, lift_splat_prep)
from sgv3d_tpu_torch.ops.topk_cells import LANES, topk_cells_plain, topk_with_cells
from sgv3d_tpu_torch.tools import lift_probe, spike_gather

pytestmark = pytest.mark.cuda


def k2_launches(batch: int, num_cells: int, pool: bool = True) -> int:
    """Launches of one K2 call on the card: the prep's memset, then a
    count, a scan and a placement for each 8-bit radix pass over the
    largest key's bits (the first count and scan also make the offsets);
    then the pool and its finish."""
    passes = -(-max(1, (batch * num_cells - 1).bit_length()) // 8)
    return 3 * passes + 1 + (2 if pool else 0)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never while the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("d,k,hw", [(90, 16, 700), (8, 4, 24), (180, 32, 33)])
def test_topk_kernel_matches_plain(cuda_device, d, k, hw):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    h = torch.randn(3, hw, d, generator=g, device=cuda_device)
    h[:, ::3] = torch.randint(0, 3, (3, len(range(0, hw, 3)), d), generator=g,
                              device=cuda_device).float()
    h[:, 1::5, d // 3:] = float("-inf")
    cells = torch.randint(0, 16385, (3, hw, d), generator=g, device=cuda_device,
                          dtype=torch.int32)
    before = topk_with_cells.launches
    got = topk_with_cells(h, cells, k)
    ref = topk_cells_plain(h, cells, k)
    assert topk_with_cells.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError):
        topk_with_cells(h, cells, 33)
    with pytest.raises(TypeError):
        topk_with_cells(h.double(), cells, k)


@pytest.mark.parametrize("rows", [2 * 20736, 3 * 301], ids=["2_lanes", "4_lanes"])
def test_topk_kernel_bins_match_plain(cuda_device, rows):
    """Values, cells and bins exactly the stable sort's, with exact ties,
    whole rows equal and rows of fewer than k finite bins; the serving call
    (no bins) gives the same values and cells."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    n = 2 if rows % 2 == 0 else 3
    h, cells = chip_smoke.k1_inputs(g, n, rows // n, 90, 16384, cuda_device)
    before = topk_with_cells.launches
    got = topk_with_cells(h, cells, 16, return_bins=True)
    ref = topk_cells_plain(h, cells, 16, return_bins=True)
    assert topk_with_cells.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    serving = topk_with_cells(h, cells, 16)
    assert len(serving) == 2
    assert torch.equal(serving[0], got[0]) and torch.equal(serving[1], got[1])


def test_topk_train_lift_grads_card_match_cpu(cuda_device):
    """`TopkCells` + `LiftSplat` on the card (K1 with bins, K2, K2b) against
    the CPU's plain versions: the same output and gradients within 1e-5 of
    scale, exact zeros at the same (unpicked) bins."""
    g = torch.Generator().manual_seed(0)
    batch, n, hw, d, c, num_cells, k = 2, 4, 2000, 90, 33, 4096, 16
    logits = torch.randn(n, hw, d, generator=g) * 3
    logits[:, ::5] = torch.randint(0, 3, (n, len(range(0, hw, 5)), d),
                                   generator=g).float()
    h = torch.softmax(logits, -1)
    ctx = torch.randn(n, hw, c, generator=g)
    cells = torch.randint(0, num_cells + 1, (n, hw, d), generator=g,
                          dtype=torch.int32)
    grad = torch.randn(batch, num_cells, c, generator=g)
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        th = h.to(dev, copy=True).requires_grad_()
        tctx = ctx.to(dev, copy=True).requires_grad_()
        hp, cl = TopkCells.apply(th, cells.to(dev), k)
        out = LiftSplat.apply(hp, tctx, cl, batch, num_cells)
        out.backward(grad.to(dev))
        outs.append([t.detach().cpu() for t in (out, th.grad, tctx.grad)])
    for ref, got in zip(*outs):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(outs[0][1] == 0, outs[1][1] == 0)


def test_sam_tiny_encoder_card_matches_cpu(cuda_device):
    assert chip_smoke.sam_tiny_card_vs_cpu(cuda_device) <= 1e-4


@pytest.mark.parametrize("j,hw,c,batch,n", [(16, 4608, 80, 4, 4),
                                            (16, 18432, 87, 4, 4),
                                            (90, 300, 87, 2, 4),
                                            (3, 64, 16, 1, 1)])
def test_lift_splat_kernel_matches_plain(cuda_device, j, hw, c, batch, n):
    num_cells = 1024
    g = torch.Generator(device=cuda_device).manual_seed(j)
    height = torch.rand(n, j, hw, generator=g, device=cuda_device)
    ctx = torch.randn(n, hw, c, generator=g, device=cuda_device)
    cells = torch.randint(0, num_cells + 1, (n, j, hw), generator=g,
                          device=cuda_device, dtype=torch.int32)
    args = (height, ctx, cells, batch, num_cells)
    before = lift_splat_forward.launches
    a, b = lift_splat_forward(*args), lift_splat_forward(*args)
    ref = lift_splat_plain(*args)
    assert lift_splat_forward.launches == before + 2 * k2_launches(batch,
                                                                   num_cells)
    assert torch.equal(a, b)
    assert float((a - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6
    trash = torch.full_like(cells, num_cells)
    assert not lift_splat_forward(height, ctx, trash, batch, num_cells).any()


@pytest.mark.parametrize("kind,d,k", [("ascending", 90, 16), ("normal", 90, 1),
                                      ("normal", 33, 32), ("ties", 90, 16)])
def test_topk_kernel_exact_at_every_lane_count(cuda_device, kind, d, k):
    """Heights ascending along D (every bin inserts), k = 1, k = 32 of 33
    bins, and exact ties with -inf rows, at both lane counts."""
    g = torch.Generator(device=cuda_device).manual_seed(d + k)
    h = torch.randn(2, 301, d, generator=g, device=cuda_device)
    if kind == "ascending":
        h = h.sort(dim=-1).values
    elif kind == "ties":
        h = torch.randint(0, 3, h.shape, generator=g, device=cuda_device).float()
        h[:, 1::5, d // 3:] = float("-inf")
    cells = torch.randint(0, 16385, h.shape, generator=g, device=cuda_device,
                          dtype=torch.int32)
    ref = topk_cells_plain(h, cells, k)
    got = topk_with_cells(h, cells, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for lanes in LANES:
        launch, got = lift_probe.topk_launcher(h, cells, k, lanes)
        launch()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), lanes


@pytest.mark.parametrize("batch,num_cells,n,j,hw", [
    (4, 16384, 4, 16, 18432),       # the SGV3D top-k shape: 16-bit keys
    (4, 16384, 4, 90, 5184),        # r101 all-bin
    (16, 65536, 16, 2, 4096),       # 20-bit keys: three passes
    (32, 65536, 32, 2, 1024),       # 21-bit keys
    (2, 48, 4, 3, 256)])            # one pass
def test_lift_prep_order_matches_stable_sort(cuda_device, batch, num_cells, n,
                                             j, hw):
    g = torch.Generator(device=cuda_device).manual_seed(n * j)
    height = torch.rand(n, j, hw, generator=g, device=cuda_device)
    cells = torch.randint(0, num_cells, (n, j, hw), generator=g,
                          device=cuda_device, dtype=torch.int32)
    trash = torch.rand(n, j, hw, generator=g, device=cuda_device) < 0.25
    cells = torch.where(trash, num_cells, cells).to(torch.int32)
    cells[-(n // batch):] = num_cells               # an empty batch element
    before = lift_splat_prep.launches
    chip_smoke.check_prep(height, cells, batch, num_cells, "test")
    assert lift_splat_prep.launches == before + k2_launches(batch, num_cells,
                                                            pool=False)


@pytest.mark.parametrize("batch,num_cells,n,j,hw", [
    (1, 16384, 1, 1, 100_000),      # one hot cell of 100k points
    (32, 65536, 32, 2, 1024)])      # 21-bit keys
def test_lift_splat_bitwise_deterministic(cuda_device, batch, num_cells, n, j,
                                          hw):
    g = torch.Generator(device=cuda_device).manual_seed(hw)
    height = torch.rand(n, j, hw, generator=g, device=cuda_device)
    ctx = torch.randn(n, hw, 80, generator=g, device=cuda_device)
    if n == 1:
        cells = torch.full((n, j, hw), 77, dtype=torch.int32, device=cuda_device)
    else:
        cells = torch.randint(0, num_cells + 1, (n, j, hw), generator=g,
                              device=cuda_device, dtype=torch.int32)
    args = (height, ctx, cells, batch, num_cells)
    a, b = lift_splat_forward(*args), lift_splat_forward(*args)
    assert torch.equal(a, b)
    if n > 1:
        ref = lift_splat_plain(*args)
        assert float((a - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6
        return
    # one float32 sum of 1e5 terms: within n * 2^-24 * sum|term| of the
    # float64 sum (the worst case of any summation order)
    terms = height.reshape(-1, 1).double() * ctx[0].double()
    err = (a[0, 77].double() - terms.sum(0)).abs()
    assert bool((err <= hw * 2.0 ** -24 * terms.abs().sum(0)).all())
    assert not a[0, :77].any() and not a[0, 78:].any()


def _k2b_cells(kind, g, n, j, hw, num_cells, device):
    """Cells for K2b's card cases: "uniform" over [-2, num_cells + 3) (the
    trash both below and past the end; tiles share next to no rows, so the
    kernel's overflow path runs), "one" (every point in cell 77), "rig"
    (the all-bin training cells of the tiny config's backbone at a 25 x 41
    stride-8 map and 90 bins, `rig_backbone`)."""
    if kind == "one":
        return torch.full((n, j, hw), 77, dtype=torch.int32, device=device)
    if kind == "rig":
        import dataclasses
        from sgv3d_tpu_torch.data.synthetic import make_batch
        from sgv3d_tpu_torch.nn.lss_fpn import compute_lift_cells

        cfg = chip_smoke.tiny_exp()
        bb = dataclasses.replace(cfg.backbone, final_dim=(200, 328),
                                 downsample_factor=8, d_bound=(-2.0, 3.5, 90))
        _, mats, *_ = make_batch(dataclasses.replace(cfg, backbone=bb), n, seed=0)
        m = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in mats.items()}
        return compute_lift_cells(bb, m, train=True).reshape(n, j, hw).to(device)
    return torch.randint(-2, num_cells + 3, (n, j, hw), generator=g, device=device,
                         dtype=torch.int32)


@pytest.mark.parametrize("batch,n,j,hw,c,num_cells,feat_w,kind", [
    (2, 2, 90, 2000, 87, 16384, None, "uniform"),
    (3, 6, 13, 1001, 37, 777, None, "uniform"),
    (1, 1, 256, 33, 128, 5, None, "uniform"),
    (2, 4, 16, 31, 1, 64, None, "uniform"),
    (2, 2, 90, 2000, 87, 16384, 50, "uniform"),     # 40 x 50 pixels
    (3, 6, 13, 1001, 37, 777, 77, "uniform"),       # 13 x 77: ragged both ways
    (1, 2, 256, 600, 1, 300, 30, "uniform"),        # J = 256, C = 1
    (2, 2, 256, 221, 128, 4000, 17, "uniform"),     # J = 256, C = 128, 13 x 17
    (2, 2, 90, 2000, 87, 16384, 50, "one"),
    (2, 2, 90, 1025, 16, 256, 41, "rig"),           # 25 x 41
])
def test_lift_splat_backward_kernel_matches_plain(cuda_device, batch, n, j, hw,
                                                  c, num_cells, feat_w, kind):
    """K2b within 1e-5 * max|ref| + 1e-6 of its plain version, bitwise the
    same across two runs, one launch a call, trash points' d_height exactly
    0, with the feature map's width (2-D tiles) and without (one row); its
    d_ctx-only form (`height_grad=False`) bitwise the full form's d_ctx."""
    g = torch.Generator(device=cuda_device).manual_seed(j)
    height = torch.rand(n, j, hw, generator=g, device=cuda_device)
    ctx = torch.randn(n, hw, c, generator=g, device=cuda_device)
    cells = _k2b_cells(kind, g, n, j, hw, num_cells, cuda_device)
    grad = torch.randn(batch, num_cells, c, generator=g, device=cuda_device)
    args = (grad, height, ctx, cells, batch, num_cells, feat_w)
    before = lift_splat_backward.launches
    got, again = lift_splat_backward(*args), lift_splat_backward(*args)
    ref = lift_splat_backward_plain(*args)
    torch.cuda.synchronize()
    assert lift_splat_backward.launches == before + 2
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        err = float((a - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()) + 1e-6
    outside = (cells < 0) | (cells >= num_cells)
    assert torch.all(got[0][outside] == 0)
    none, d_ctx = lift_splat_backward(*args, height_grad=False)
    assert lift_splat_backward.launches == before + 3
    assert none is None and torch.equal(d_ctx, got[1])


def test_lift_kernels_are_batch_invariant(cuda_device):
    """K2 and K2b on four frames of the r50 rig in one batch give each
    frame's outputs bitwise as the frame alone does (ROADMAP C4)."""
    out = chip_smoke.lift_batch_invariance(cuda_device)
    assert all(v == 0 for layout in out.values() for v in layout.values()), out


def test_tiny_train_step_card_matches_cpu(cuda_device):
    """chip_smoke's tiny train phase: one float32 train step of the tiny
    BEVHeight and SGV3D on the card (K2, K2b; with `train_lift_top_k=4`
    also K1 with its bins) and on the CPU agree."""
    chip_smoke.phase_train_tiny(cuda_device)     # raises on any disagreement


def test_two_rank_gloo_step_on_the_card_matches_one_process(cuda_device, tmp_path):
    """Two gloo ranks sharing the card (spawned), the tiny BEVHeight and
    SGV3D steps with dropout on, against this process's card step on the
    concatenated batch: the step gates with the BatchNorm-order spread,
    within DIST_CARD_GROUPING_TOL of one process summing in the ranks'
    grouping, the ranks' states the same bits (`chip_smoke.check_dist_tiny`)."""
    from sgv3d_tpu_torch.weights import seeded_state_dict

    cases = [c for c in chip_smoke.DIST_CASES if c[3] is None]
    chip_smoke.spawn_ranks(chip_smoke.dist_tiny_worker,
                           (f"file://{tmp_path}/rendezvous", "cuda", str(tmp_path), cases),
                           timeout=300)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        refs = {}
        for config, bsm in (("bevheight", False), ("sgv3d", True)):
            cfg = chip_smoke.dist_tiny_cfg(bsm)
            sd = seeded_state_dict(cfg, seed=5)
            refs[config] = (cfg, sd, chip_smoke.dist_references(cfg, sd, cuda_device))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    chip_smoke.check_dist_tiny(refs, tmp_path, "card test", faults=False,
                               grouping_tol=chip_smoke.DIST_CARD_GROUPING_TOL)


def test_tiny_predictor_card_matches_cpu(cuda_device):
    """chip_smoke's tiny phase: the served slice on the card (float32) and
    on the CPU agree."""
    chip_smoke.phase_tiny(cuda_device)     # raises on any disagreement


def test_predictor_spans_on_the_card(cuda_device):
    """On the card `sgv3d.submit` also holds `sgv3d.copy` and `sgv3d.fetch`
    `sgv3d.fetch.wait`; the spans add no event to the device's track; and
    `sgv3d.decode.nms` launches three kernels a step of circle_nms's loop
    (k = min(max_per_task, H * W) steps) and a few before it."""
    from torch.autograd import DeviceType

    from sgv3d_tpu_torch.api import BEVHeightPredictor
    from sgv3d_tpu_torch.data.synthetic import make_batch
    from sgv3d_tpu_torch.weights import seeded_state_dict

    cfg = chip_smoke.tiny_serving_exp(4, False)
    imgs, mats, *_ = make_batch(cfg, batch=2, seed=1, num_objs=2)
    pred = BEVHeightPredictor(cfg, seeded_state_dict(cfg, seed=1), device=cuda_device,
                              use_bf16=False)
    _, h, w, _ = pred.predict_heads(imgs, mats)[0]["heatmap"].shape
    pred.fetch(pred.submit(imgs, mats))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pred.fetch(pred.submit(imgs, mats))
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]

    def spans(name):
        return [(e.start_ns(), e.end_ns()) for e in host if e.name() == name]

    def within(inner, outer):
        return all(any(a <= s and t <= b for a, b in spans(outer)) for s, t in spans(inner))

    for name, parent in (("sgv3d.copy", "sgv3d.submit"),
                         ("sgv3d.fetch.wait", "sgv3d.fetch")):
        assert len(spans(name)) == 1 and within(name, parent), name
    assert not [e.name() for e in events
                if e.device_type() == DeviceType.CUDA and e.name().startswith("sgv3d.")]
    (nms,) = spans("sgv3d.decode.nms")
    launches = [e for e in host if "LaunchKernel" in e.name()
                and nms[0] <= e.start_ns() <= nms[1]]
    k = min(cfg.head.max_per_task, h * w)
    assert 3 * k <= len(launches) <= 3 * k + 16, (len(launches), k)


def test_tiny_evaluate_card_matches_cpu(cuda_device):
    """chip_smoke's tiny eval phase: `runner.evaluate` of the tiny BEVHeight
    and SGV3D, parity-grade and fast_lift, from a flax-msgpack file, on the
    card and on the CPU: detections equal as tie-aware sets, KITTI lines
    within 1e-3, AP dicts equal."""
    chip_smoke.phase_eval_tiny(cuda_device)     # raises on any disagreement


@pytest.mark.parametrize("p,h,w", [(64, 16, 32), (64, 13, 21), (512, 11, 7),
                                   (128, 9, 10)])
def test_fused_bottleneck_kernel_matches_plain(cuda_device, p, h, w):
    """Small shapes and odd ones (H, W not multiples of the 8x8 / 8x16
    tile), with large positive BN biases."""
    block, fb = chip_smoke.seeded_bottleneck(4 * p, p, seed=p + h,
                                             device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(h)
    x = torch.randn(2, h, w, 4 * p, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    before = fused_bottleneck.launches
    a, b = fused_bottleneck(x, fb), fused_bottleneck(x, fb)
    ref = fused_bottleneck_plain(x, fb).float()
    assert fused_bottleneck.launches == before + 2
    assert torch.equal(a, b)
    assert float((a.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
    with pytest.raises(ValueError):
        fused_bottleneck(x[:, :, :, :-32].contiguous(), fb)
    with pytest.raises(TypeError):
        fused_bottleneck(x.float(), fb)


@pytest.mark.parametrize("h,w", [(6, 8), (13, 20)])
def test_fused_bottleneck_padding_is_zero_in_y1_space(cuda_device, h, w):
    """w1 = 0, b1 = 1, w2 = w3 = 1: each output counts conv2's taps inside
    the image times P * P, exactly (a leaked relu(b1) would add taps)."""
    p = 64
    c = 4 * p
    dev = cuda_device
    fb = FoldedBottleneck(
        w1=torch.zeros(p, c, dtype=torch.bfloat16, device=dev),
        b1=torch.ones(p, device=dev),
        w2=torch.ones(p, 9 * p, dtype=torch.bfloat16, device=dev),
        b2=torch.zeros(p, device=dev),
        w3=torch.full((c, p), 1 / 64, dtype=torch.bfloat16, device=dev),
        b3=torch.zeros(c, device=dev))
    out = fused_bottleneck(torch.zeros(1, h, w, c, dtype=torch.bfloat16,
                                       device=dev), fb)
    taps = np.full((h, w), 9.0)
    taps[[0, -1], :] = 6.0
    taps[:, [0, -1]] = 6.0
    taps[np.ix_([0, -1], [0, -1])] = 4.0
    want = torch.from_numpy(taps * p).float()[..., None].expand(h, w, c)
    assert torch.equal(out[0].float().cpu(), want)


def test_spike_gather_kernels_are_exact(cuda_device):
    """Each formulation bitwise its plain version (the take and the
    take-along `gather_plain`, the one-hot `onehot_plain`) and bitwise the
    same on two calls at every card case: the probe's shape, ragged HW and
    M, out-of-range indices (zero rows; a whole block and an m64 tile of
    them), all indices in one k16 slab, uniform indices, special values
    (-0.0, subnormals, inf, NaN); the take and the take-along also at
    C = 40, which the one-hot product refuses."""
    for case, ctx, idx in spike_gather.card_cases(cuda_device):
        for name, fn in spike_gather.FORMULATIONS:
            ref = fn.plain(ctx, idx)
            before = fn.launches
            got, again = fn(ctx, idx), fn(ctx, idx)
            assert fn.launches == before + 2, name
            assert spike_gather.bitwise_equal(got, ref), (case, name)
            assert spike_gather.bitwise_equal(got, again), (case, name)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    ctx = torch.randn(300, 40, generator=g, device=cuda_device).to(torch.bfloat16)
    idx = torch.randint(-5, 305, (2, 333), generator=g, dtype=torch.int32,
                        device=cuda_device)
    ref = spike_gather.gather_plain(ctx, idx)
    for name, fn in spike_gather.FORMULATIONS[:2]:
        assert spike_gather.bitwise_equal(fn(ctx, idx), ref), name
    with pytest.raises(ValueError):
        spike_gather.gather_onehot(ctx, idx)


@pytest.mark.parametrize("c", [37, 200])
def test_voxel_pooling_kernels_match_plain(cuda_device, c):
    """`voxel_pooling` on the card (K2 forward, K2b backward at J = 1; C =
    200 in two slices) within 1e-5 * max|ref| + 1e-6 of
    `voxel_pooling_plain`, its features' gradient exactly the plain one's
    (g at each point's cell, 0 off the grid), both bitwise equal across
    calls."""
    from sgv3d_tpu_torch.ops.voxel_pooling import voxel_pooling, voxel_pooling_plain

    g = torch.Generator(device=cuda_device).manual_seed(c)
    voxel_num = (40, 24, 2)
    xyz = torch.stack([torch.randint(-3, n + 3, (3, 5000), generator=g,
                                     device=cuda_device) for n in voxel_num],
                      dim=-1).to(torch.int32)
    feats = torch.randn(3, 5000, c, generator=g, device=cuda_device)
    w = torch.randn(3, voxel_num[1], voxel_num[0], c, generator=g, device=cuda_device)

    def run(fn):
        f = feats.clone().requires_grad_()
        out = fn(xyz, f, voxel_num)
        (d,) = torch.autograd.grad((out * w).sum(), f)
        return out.detach(), d

    before = (lift_splat_forward.launches, lift_splat_backward.launches)
    out, d = run(voxel_pooling)
    assert lift_splat_forward.launches > before[0]
    assert lift_splat_backward.launches == before[1] + -(-c // 128)
    out2, d2 = run(voxel_pooling)
    ref, d_ref = run(voxel_pooling_plain)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6
    assert torch.equal(d, d_ref)
    assert torch.equal(out, out2) and torch.equal(d, d2)
