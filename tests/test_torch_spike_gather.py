"""The gather probe (K4) of the port on the CPU: each formulation's plain
version is exactly numpy's `ctx[idx]`, the JAX probe's own oracle, and
exactly the JAX probe's Pallas kernels (tools/spike_pallas_gather.py) run
by `pl.pallas_call(..., interpret=True)` at a small shape (HW 96, C 128,
M 32, 3 chunks); on indices outside [0, HW) it gives the JAX one-hot
kernel's zero rows. The one-hot's own plain version, `onehot_plain`, is
also held to the product it issues (one_hot(idx) @ ctx over the k16 slabs
that each m64 tile indexes) on special values: -0.0, subnormals, inf and
NaN. Comparisons are bitwise (bf16 bit patterns; any NaN matches any
NaN)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.spike_pallas_gather as jax_probe
from sgv3d_tpu_torch.tools import spike_gather

SMALL = {"HW": 96, "C": 128, "M": 32, "N_CHUNKS": 3}
JAX_KERNELS = {"take": jax_probe._kernel_take,
               "take_along": jax_probe._kernel_taa,
               "onehot-mma": jax_probe._kernel_onehot}


@pytest.mark.parametrize("name,fn", spike_gather.FORMULATIONS)
def test_gather_plain_is_numpy_take(name, fn):
    ctx, idx = spike_gather.probe_inputs("cpu", seed=3)
    assert ctx.shape == (spike_gather.HW, spike_gather.C)
    assert idx.shape == (spike_gather.N_CHUNKS, spike_gather.M)
    before = fn.launches
    got = fn(ctx, idx)
    assert fn.launches == before          # the CPU runs no kernel
    ref = ctx.float().numpy()[idx.numpy()]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_probe_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert spike_gather.main() == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


@pytest.fixture
def small_probe(monkeypatch):
    """The JAX probe's module constants at the small shape, and a runner of
    one of its kernel bodies through `pl.pallas_call` in interpret mode
    (BlockSpecs without the TPU's VMEM memory space); returns bf16 bits."""
    for key, value in SMALL.items():
        monkeypatch.setattr(jax_probe, key, value)

    def run(kernel, ctx: np.ndarray, idx: np.ndarray) -> np.ndarray:
        hw, c, m, chunks = (SMALL[k] for k in ("HW", "C", "M", "N_CHUNKS"))
        fn = pl.pallas_call(
            kernel, grid=(chunks,),
            in_specs=[pl.BlockSpec((hw, c), lambda ch: (0, 0)),
                      pl.BlockSpec((chunks, m), lambda ch: (0, 0))],
            out_specs=pl.BlockSpec((1, m, c), lambda ch: (ch, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((chunks, m, c), jnp.bfloat16),
            interpret=True)
        out = fn(jnp.asarray(ctx, jnp.bfloat16), jnp.asarray(idx))
        return np.asarray(out).view(np.uint16)

    return run


def _small_inputs(seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ctx = rng.normal(size=(SMALL["HW"], SMALL["C"])).astype(np.float32)
    ctx = np.array(jnp.asarray(ctx, jnp.bfloat16).astype(jnp.float32))
    idx = rng.integers(0, SMALL["HW"], size=(SMALL["N_CHUNKS"], SMALL["M"]),
                       dtype=np.int32)
    return ctx, idx


def _port_bits(fn, ctx: np.ndarray, idx: np.ndarray) -> np.ndarray:
    got = fn(torch.from_numpy(ctx).to(torch.bfloat16), torch.from_numpy(idx))
    return got.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("name,fn", spike_gather.FORMULATIONS)
def test_plain_equals_jax_probe_kernel(small_probe, name, fn):
    """In range, each formulation's plain version is bitwise the JAX probe's
    kernel of the same formulation."""
    ctx, idx = _small_inputs(5)
    want = small_probe(JAX_KERNELS[name], ctx, idx)
    np.testing.assert_array_equal(_port_bits(fn, ctx, idx), want)


@pytest.mark.parametrize("name,fn", spike_gather.FORMULATIONS)
def test_plain_out_of_range_equals_jax_onehot(small_probe, name, fn):
    """Indices -1, HW and 2^31 - 1 give the JAX one-hot kernel's zero rows,
    the function every formulation of the port computes. The JAX take and
    take-along kernels are no reference here: interpreted, `jnp.take` wraps
    -1 to the last row and fills NaN beyond HW, and what they give on a TPU
    is not defined."""
    ctx, idx = _small_inputs(6)
    idx[0, :3] = (-1, SMALL["HW"], 2 ** 31 - 1)
    idx[2, -3:] = (2 ** 31 - 1, -1, SMALL["HW"])
    want = small_probe(jax_probe._kernel_onehot, ctx, idx)
    assert not want[0, :3].any() and not want[2, -3:].any()
    np.testing.assert_array_equal(_port_bits(fn, ctx, idx), want)


def test_slab_share_counts_issued_slabs():
    """The one-hot kernel's issued share: (m64 tile, k16 slab) pairs that a
    row of the tile indexes, out-of-range rows setting none."""
    hw = 64                                   # 4 slabs
    idx = torch.full((128,), -1, dtype=torch.int32)
    idx[:64] = torch.tensor([0, 1, 15, 16] * 16, dtype=torch.int32)  # slabs 0, 1
    idx[64] = 63                              # tile 1: slab 3
    idx[65] = hw                              # outside: no slab
    assert spike_gather.slab_share(idx, hw) == 3 / 8
    assert spike_gather.slab_share(idx.reshape(2, 64), hw) == 3 / 8


def test_card_cases_cover_the_traps():
    """The card's cases: the probe's shape, ragged HW and M, a whole block
    and a whole m64 tile of out-of-range indices (zero rows), one slab."""
    cases = {name: (ctx, idx) for name, ctx, idx in spike_gather.card_cases("cpu")}
    assert set(cases) == {"probe", "ragged", "probe[:3, :77]", "out-of-range",
                          "one slab", "uniform", "special values"}
    ctx, idx = cases["ragged"]
    assert ctx.shape[0] % 64 and idx.numel() % 256
    ctx, idx = cases["out-of-range"]
    out = spike_gather.gather_plain(ctx, idx)
    assert not out[0, 256:512].any() and not out[1, 64:128].any()
    outside = (idx < 0) | (idx >= ctx.shape[0])
    assert {-1, ctx.shape[0], 2 ** 31 - 1, -2 ** 31} <= set(idx[outside].tolist())
    assert not out[outside].any()
    assert torch.equal(out[~outside], ctx[idx[~outside].long()])
    ctx, idx = cases["one slab"]
    assert (idx // 16).unique().numel() == 1
    ctx, idx = cases["special values"]
    got = spike_gather.gather_plain(ctx, idx)
    bits = got.view(torch.int16)
    assert (bits == -0x8000).any() and (bits == 0x0001).any()   # -0.0, subnormal
    assert got.isinf().any() and got.isnan().any()
    assert int((idx[3, 128:192] >= 0).sum()) == 1   # one row of the tile in range


def _issued_product(ctx: torch.Tensor, idx: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """one_hot(idx) @ ctx as the one-hot kernel issues it: for each m64 tile
    of the flattened rows, the products over the k16 slabs that one of its
    rows indexes, summed in float64 from +0.0, rounded to bf16."""
    hw, c = ctx.shape
    flat = idx.reshape(-1).long()
    x = ctx.double()
    out = torch.empty(flat.numel(), c, dtype=torch.float64)
    for t0 in range(0, flat.numel(), rows):
        ids = flat[t0:t0 + rows]
        slabs = ids[(ids >= 0) & (ids < hw)].div(16, rounding_mode="floor").unique()
        ks = (slabs[:, None] * 16 + torch.arange(16)).reshape(-1)
        ks = ks[ks < hw]
        onehot = (ids[:, None] == ks[None, :]).double()
        out[t0:t0 + rows] = 0.0 + (onehot[:, :, None] * x[ks][None]).sum(1)
    return out.to(torch.bfloat16).reshape(*idx.shape, c)


@pytest.mark.parametrize("hw,shape,outside", [
    (96, (3, 100), False),      # ragged M
    (90, (2, 64), False),       # ragged HW: the last slab is short
    (96, (3, 128), True),       # out-of-range rows, a whole tile of them
])
def test_onehot_plain_is_the_issued_product(hw, shape, outside):
    """`onehot_plain` on special values is the one-hot product the kernel
    issues: -0.0 comes out as +0.0, subnormals pass, and a non-finite ctx
    value makes NaN in the other rows of the tiles that issue its slab."""
    g = torch.Generator().manual_seed(hw + shape[1])
    idx = torch.randint(0, hw, shape, generator=g, dtype=torch.int32)
    if outside:
        idx[1, :64] = -1
        idx[1, 10] = idx[0, 3]                # the tile issues +inf's slab
        idx[2, :5] = torch.tensor([hw, 2 ** 31 - 1, -2 ** 31, -1, hw + 7])
    ctx = spike_gather.special_values(
        torch.randn(hw, spike_gather.C, generator=g).to(torch.bfloat16), idx)
    got = spike_gather.onehot_plain(ctx, idx)
    want = _issued_product(ctx, idx)
    assert got.isnan().any() and not (got.view(torch.int16) == -0x8000).any()
    assert spike_gather.bitwise_equal(got, want)
    if outside:
        assert got[1, :64, 5].isnan().sum() == 63   # 0 x inf, all but the row of +inf


@pytest.mark.parametrize("name,fn", spike_gather.FORMULATIONS)
def test_cpu_wrapper_is_its_plain_version(name, fn):
    """On the CPU each wrapper returns its `plain`: the take and the
    take-along `gather_plain` (bits copied, -0.0 kept), the one-hot
    `onehot_plain` (-0.0 as +0.0)."""
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(-2, 98, (2, 96), generator=g, dtype=torch.int32)
    idx[0, :8] = torch.randint(0, 96, (8,), generator=g, dtype=torch.int32)
    ctx = spike_gather.special_values(
        torch.randn(96, spike_gather.C, generator=g).to(torch.bfloat16), idx)
    got = fn(ctx, idx)
    assert spike_gather.bitwise_equal(got, fn.plain(ctx, idx))
    negative_zero = (got.view(torch.int16) == -0x8000).any()
    assert negative_zero == (fn.plain is spike_gather.gather_plain), name
