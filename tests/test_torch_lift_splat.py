"""Kernel K2 (lift-splat forward): the port's plain version against the JAX
`lift_splat_pool` (float32; 1e-5 of the output's scale, since the sums run
in another order) and against the TPU kernel `pallas_lift_splat_forward`
in interpret mode (bf16 tolerance: that kernel rounds its products to bf16
for the TPU's matrix unit). The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py."""
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgv3d_tpu.ops.pallas_lift_splat as pls
from sgv3d_tpu.ops.voxel_pooling import lift_splat_pool
from sgv3d_tpu_torch.ops.lift_splat import (
    lift_prep_plain, lift_splat_forward, lift_splat_plain)
from tests.torch_port_util import shared_jax_compiles  # noqa: F401 (autouse)


@pytest.fixture
def _interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pls.pl, "pallas_call", patched)


def _case(rng, n, j, hw, c, cells, gen):
    height = rng.random((n, j, hw)).astype(np.float32)
    ctx = rng.normal(size=(n, hw, c)).astype(np.float32)
    cell = np.asarray(gen((n, j, hw)), np.int32)
    return height, ctx, cell


def _port(height, ctx, cell, batch, cells):
    return lift_splat_plain(torch.from_numpy(height), torch.from_numpy(ctx),
                            torch.from_numpy(cell), batch, cells).numpy()


@pytest.mark.parametrize("layout,j,hw,cells", [("top-k", 16, 96, 256), ("all-bin", 90, 96, 256),
                                               ("all-bin", 180, 12, 123904)],
                         ids=["top-k-16", "all-bin-90", "all-bin-180-cells-123904"])
def test_plain_matches_lift_splat_pool(rng, layout, j, hw, cells):
    """Both layouts are (N, J, HW); 2 batch elements x 2 cameras. The last
    case is past both limits the training exps reach, J = 180 and more
    than 65,536 cells (`bevheight_rope3d_r101_140m`'s 123,904), sparsely
    occupied (8640 points), a third of the points in the trash cell."""
    n, c = 4, 80
    gen = (lambda s: rng.integers(0, cells + 1, size=s)) if cells <= 65536 else (
        lambda s: np.where(rng.random(s) < 1 / 3, cells, rng.integers(0, cells, size=s)))
    height, ctx, cell = _case(rng, n, j, hw, c, cells, gen)
    got = _port(height, ctx, cell, 2, cells)
    ref = np.asarray(lift_splat_pool(jnp.asarray(height), jnp.asarray(ctx),
                                     jnp.asarray(cell), 2, cells))
    assert got.shape == ref.shape == (2, cells, c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


CASES = {
    # (n, j, hw, c, cells, batch, key generator)
    "dense_keys": (2, 5, 512, 16, 64, 2, lambda r, s: r.integers(0, 65, size=s)),
    "sparse_multi_window": (1, 4, 512, 16, 4096, 1,
                            lambda r, s: np.sort(r.choice(4096, size=s))),
    "all_trash": (1, 2, 512, 8, 32, 1, lambda r, s: np.full(s, 32)),
    "one_hot_cell": (1, 3, 512, 8, 64, 1, lambda r, s: np.zeros(s, np.int64)),
    "multi_camera": (4, 3, 256, 8, 48, 2, lambda r, s: r.integers(0, 49, size=s)),
    # batch element 1's two cameras all in the trash cell
    "empty_batch_element": (4, 3, 256, 8, 48, 2, lambda r, s: np.where(
        np.arange(s[0])[:, None, None] >= 2, 48, r.integers(0, 49, size=s))),
}
# prep-only cases: 20-bit keys (three of the kernel's radix passes) and a
# hot cell among uniform ones, beside the skewed CASES
PREP_CASES = {
    "wide_keys": (16, 2, 256, 65536, 16,
                  lambda r, s: r.integers(0, 65537, size=s)),
    "hot_cell": (2, 16, 512, 1024, 2, lambda r, s: np.where(
        r.random(s) < 0.5, 7, r.integers(0, 1025, size=s))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel(rng, _interpret, name):
    n, j, hw, c, cells, batch, gen = CASES[name]
    height, ctx, cell = _case(rng, n, j, hw, c, cells, lambda s: gen(rng, s))
    got = _port(height, ctx, cell, batch, cells)
    ref = np.asarray(pls.pallas_lift_splat_forward(
        jnp.asarray(height), jnp.asarray(ctx), jnp.asarray(cell), batch, cells))
    np.testing.assert_allclose(got, ref, atol=6e-3 * max(1.0, np.abs(ref).max()))
    if name == "all_trash":
        assert not got.any()


def sort_searchsorted_reference(cells: torch.Tensor, batch: int,
                                num_cells: int):
    """K2's prep by `torch.sort(stable=True)` and `searchsorted`: the offsets of the live segments b * num_cells +
    cell and the order of the live points, from a stable sort of the global
    keys b * (num_cells + 1) + cell (cells in [0, num_cells]) with the trash
    points dropped afterwards."""
    n = cells.shape[0]
    cams = torch.arange(n) // (n // batch)
    keys = (cells.long() + (cams * (num_cells + 1))[:, None, None]).reshape(-1)
    skeys, order = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(skeys, torch.arange(batch * (num_cells + 1) + 1))
    lens = bounds.diff().reshape(batch, num_cells + 1)[:, :num_cells].reshape(-1)
    offsets = torch.cat([lens.new_zeros(1), lens.cumsum(0)])
    return offsets, order[skeys % (num_cells + 1) != num_cells]


@pytest.mark.parametrize("name", sorted(CASES) + sorted(PREP_CASES))
def test_prep_plain_matches_stable_sort(rng, name):
    """The plain prep's offsets (per-key counts, scanned) and order equal
    those of a stable sort of the global keys and `searchsorted` exactly."""
    if name in CASES:
        n, j, hw, _, cells, batch, gen = CASES[name]
    else:
        n, j, hw, cells, batch, gen = PREP_CASES[name]
    cell = torch.from_numpy(np.asarray(gen(rng, (n, j, hw)), np.int32))
    offsets, order = lift_prep_plain(cell, batch, cells)
    ref_offsets, ref_order = sort_searchsorted_reference(cell, batch, cells)
    assert torch.equal(offsets, ref_offsets)
    assert torch.equal(order, ref_order)
    if name == "wide_keys":     # three of the kernel's 8-bit radix passes
        assert (batch * cells - 1).bit_length() == 20


def test_plain_is_deterministic_and_the_cpu_wrapper(rng):
    height, ctx, cell = _case(rng, 2, 16, 300, 80, 128,
                              lambda s: rng.integers(0, 129, size=s))
    args = (torch.from_numpy(height), torch.from_numpy(ctx),
            torch.from_numpy(cell), 1, 128)
    a, b = lift_splat_plain(*args), lift_splat_plain(*args)
    assert torch.equal(a, b)
    assert torch.equal(lift_splat_forward(*args), a)
    with pytest.raises(ValueError):      # neither the CPU nor a card
        lift_splat_forward(*(t.to("meta") if torch.is_tensor(t) else t
                             for t in args))
