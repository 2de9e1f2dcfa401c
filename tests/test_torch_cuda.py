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
-0.0 as +0.0 and NaN from 0 x inf) and across runs.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sgv3d_tpu_torch.ops.fused_bottleneck import (
    FoldedBottleneck, fused_bottleneck, fused_bottleneck_plain)
from sgv3d_tpu_torch.ops.lift_splat import (
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


def test_tiny_predictor_card_matches_cpu(cuda_device):
    """chip_smoke's tiny phase: the served slice on the card (float32) and
    on the CPU agree."""
    chip_smoke.phase_tiny(cuda_device)     # raises on any disagreement


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
