"""Probe: three ways to gather context rows by pixel id in a kernel (K4).

Port of the TPU probe `tools/spike_pallas_gather.py`: gather rows of a
context `ctx (HW, C)` bf16 by `idx (N_CHUNKS, M)` int32 into
`(N_CHUNKS, M, C)` bf16, as a row take, as a take-along with one index load
per thread, and as a one-hot product on the tensor cores (the TPU's
matrix-unit formulation), each a hand-written kernel in
`csrc/spike_gather.cu`. The take and the take-along compute `gather_plain`:
`ctx[idx]`, with a zero row for an index outside [0, HW) (the one-hot
product's answer). The one-hot product computes `onehot_plain`, which is
`gather_plain` for finite ctx except that a -0.0 comes out as +0.0; a
non-finite ctx value also turns other rows' outputs into NaN, as in any
one-hot product. Each wrapper's `plain` is its function.

    python -m sgv3d_tpu_torch.tools.spike_gather

checks each formulation bitwise against its `plain` on `card_cases`
and prints its time (CUDA-event mean of back-to-back calls) beside the
plain version's; it raises on a mismatch. It needs an NVIDIA GPU.
"""
from __future__ import annotations

import sys

import torch

from sgv3d_tpu_torch.ops import cuda_lib

HW, C, M = 5184, 128, 2048   # ctx rows, channels, points per chunk
N_CHUNKS = 40
ONEHOT_MAX_HW = 65536        # the one-hot kernel's slab masks cover this many rows


def gather_plain(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ctx[idx]: (HW, C) rows by (..., M) indices -> (..., M, C), a zero row
    where an index lies outside [0, HW)."""
    idx = idx.long()
    inside = (idx >= 0) & (idx < ctx.shape[0])
    rows = ctx[torch.where(inside, idx, 0)] if ctx.shape[0] else \
        ctx.new_zeros(*idx.shape, ctx.shape[1])
    return torch.where(inside[..., None], rows, rows.new_zeros(()))


def onehot_plain(ctx: torch.Tensor, idx: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """The one-hot kernel's function over every bf16 ctx. Output (m, n) is
    an fp32 sum from +0.0 of 1.0 x ctx[idx[m], n] and of 0 x ctx[k, n] for
    every other row k of each k16 slab that a row of m's m64 tile (`rows`
    rows of the flattened `idx`) indexes: the slabs whose products the
    kernel issues. So it is `gather_plain` with a -0.0 turned into +0.0,
    and a non-finite ctx[k, n] puts NaN (0 x inf, 0 x NaN) at column n of
    every row m != k of the tiles that issue k's slab, out-of-range rows
    included."""
    out = gather_plain(ctx, idx)
    out = torch.where(out == 0, out.new_zeros(()), out)   # -0.0 -> +0.0
    flat = idx.reshape(-1).long()
    bad = (~torch.isfinite(ctx)).nonzero().tolist()
    if not bad or flat.numel() == 0:
        return out
    hw = ctx.shape[0]
    tile = torch.arange(flat.numel(), device=flat.device) // rows
    slab = torch.where((flat >= 0) & (flat < hw), flat // 16, -1)
    view = out.view(-1, ctx.shape[1])
    for k, n in bad:
        issued = torch.zeros(int(tile[-1]) + 1, dtype=torch.bool, device=flat.device)
        issued[tile[slab == k // 16]] = True
        view[issued[tile] & (flat != k), n] = float("nan")
    return out


def _launch(name: str, ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    dev = ctx.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"{name}: unsupported devices {dev}, {idx.device}")
    if ctx.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: need bf16 ctx and int32 idx; got "
                        f"{ctx.dtype}, {idx.dtype}")
    hw, c = ctx.shape if ctx.dim() == 2 else (0, 0)
    onehot = name == "spike_onehot"
    if hw == 0 or c % 8 or (onehot and (c != 128 or hw > ONEHOT_MAX_HW)):
        raise ValueError(f"{name}: ctx {tuple(ctx.shape)}; need (HW, C) with "
                         f"C % 8 == 0 (C == 128 and HW <= {ONEHOT_MAX_HW} for "
                         f"the one-hot product)")
    if not ctx.is_contiguous() or ctx.data_ptr() % 16:
        raise ValueError(f"{name}: ctx must be contiguous and 16-byte aligned")
    ids = idx.contiguous()
    out = torch.empty(*idx.shape, c, dtype=torch.bfloat16, device=dev)
    err = getattr(cuda_lib.library(), f"{name}_launch")(
        ctx.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), hw, c,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, f"{name}_launch")
    return out


def gather_take(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A half-warp per row, 16-byte vectors, several rows in flight."""
    if ctx.device.type == "cpu":
        return gather_take.plain(ctx, idx)
    out = _launch("spike_take", ctx, idx)
    gather_take.launches += 1
    return out


def gather_take_along(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A thread per 16-byte output vector, each with its own index load."""
    if ctx.device.type == "cpu":
        return gather_take_along.plain(ctx, idx)
    out = _launch("spike_take_along", ctx, idx)
    gather_take_along.launches += 1
    return out


def gather_onehot(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """one_hot(idx) (never stored) @ ctx on the tensor cores (wgmma), fp32
    sums, all-zero k16 slabs of the one-hot matrix skipped."""
    if ctx.device.type == "cpu":
        return gather_onehot.plain(ctx, idx)
    out = _launch("spike_onehot", ctx, idx)
    gather_onehot.launches += 1
    return out


gather_take.launches = 0
gather_take_along.launches = 0
gather_onehot.launches = 0
gather_take.plain = gather_plain
gather_take_along.plain = gather_plain
gather_onehot.plain = onehot_plain

FORMULATIONS = (("take", gather_take), ("take_along", gather_take_along),
                ("onehot-mma", gather_onehot))


def probe_inputs(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's ctx (HW, C) bf16 and idx (N_CHUNKS, M) int32."""
    g = torch.Generator().manual_seed(seed)
    ctx = torch.randn(HW, C, generator=g).to(torch.bfloat16)
    idx = torch.randint(0, HW, (N_CHUNKS, M), generator=g, dtype=torch.int32)
    return ctx.to(device), idx.to(device)


def slab_share(idx: torch.Tensor, hw: int, rows: int = 64) -> float:
    """The share of (m64 tile, k16 slab) pairs whose slab one of the tile's
    rows indexes: the one-hot kernel's issued products over the dense
    product's, for `idx` flattened into tiles of `rows` rows."""
    flat = idx.reshape(-1).long()
    tiles = -(-flat.numel() // rows)
    slabs = -(-hw // 16)
    inside = (flat >= 0) & (flat < hw)
    tile = torch.arange(flat.numel(), device=flat.device) // rows
    key = (tile * slabs + flat.clamp(0, hw - 1) // 16)[inside]
    return torch.unique(key).numel() / (tiles * slabs)


def special_values(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A copy of `ctx` with special values in rows that `idx` indexes: a
    whole row and every other element of a second of -0.0; subnormals of
    both signs; +inf, -inf and NaN; and +inf in a row next to an indexed
    one (the same k16 slab, whether indexed or not)."""
    out = ctx.clone()
    bits = out.view(torch.int16)
    rows = idx.reshape(-1)[:8].long().tolist()
    out[rows[0]] = -0.0
    out[rows[1], ::2] = -0.0
    bits[rows[2], 0:4] = 0x0001                 # the least subnormal
    bits[rows[2], 4:8] = 0x007F                 # the largest
    bits[rows[2], 8:12] = -0x7FFF               # 0x8001, the least negative
    out[rows[3], 5] = float("inf")
    out[rows[4], 6] = float("-inf")
    out[rows[5], 7] = float("nan")
    out[rows[6] ^ 1, 9] = float("inf")
    return out


def card_cases(device, seed: int = 0) -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """(name, ctx, idx) at which each kernel must equal its `plain`
    bitwise: the probe's shape; ragged HW and M; out-of-range indices
    (-1, HW, 2^31 - 1, -2^31), a whole 256-row block and a whole m64 tile
    of them; all indices in one k16 slab; uniform indices; special values
    in ctx (`special_values`)."""
    g = torch.Generator().manual_seed(seed)
    ctx, idx = probe_inputs("cpu", seed)
    ragged_ctx = torch.randn(5000, C, generator=g).to(torch.bfloat16)
    ragged_idx = torch.randint(0, 5000, (3, 1000), generator=g, dtype=torch.int32)
    bad = torch.randint(0, HW, (4, M), generator=g, dtype=torch.int32)
    bad[0, 256:512] = -1                    # every row of a block
    bad[1, 64:128] = HW                     # every row of an m64 tile
    spots = torch.randint(0, bad.numel(), (200,), generator=g)
    values = torch.tensor([-1, HW, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32)
    bad.view(-1)[spots] = values[torch.arange(200) % 4]
    one_slab = torch.randint(16 * 100, 16 * 101, (8, M), generator=g,
                             dtype=torch.int32)
    uniform = torch.randint(0, HW, (N_CHUNKS, M), generator=g, dtype=torch.int32)
    special = torch.randint(0, HW, (4, M), generator=g, dtype=torch.int32)
    special[3, 128:192] = -1                  # an m64 tile of out-of-range rows
    special[3, 150] = special[0, 3]           # ... save one, indexing +inf
    cases = [("probe", ctx, idx), ("ragged", ragged_ctx, ragged_idx),
             ("probe[:3, :77]", ctx, idx[:3, :77].contiguous()),
             ("out-of-range", ctx, bad), ("one slab", ctx, one_slab),
             ("uniform", ctx, uniform),
             ("special values", special_values(ctx, special), special)]
    return [(name, a.to(device), b.to(device)) for name, a, b in cases]


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bf16 bit patterns, except that any NaN matches any NaN."""
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    keep = ~a.isnan()
    return torch.equal(a.view(torch.int16)[keep], b.view(torch.int16)[keep])


def check(device) -> None:
    """Each formulation bitwise equal to its `plain` on every card case,
    and two calls bitwise equal; raises on a mismatch."""
    for case, ctx, idx in card_cases(device):
        for name, fn in FORMULATIONS:
            ref = fn.plain(ctx, idx)
            got, again = fn(ctx, idx), fn(ctx, idx)
            torch.cuda.synchronize()
            if not bitwise_equal(got, ref):
                bad = (int((got.view(torch.int16) != ref.view(torch.int16)).sum())
                       if got.shape == ref.shape else -1)
                raise AssertionError(f"spike_gather {name} ({case}): {bad} "
                                     f"elements differ from its plain version")
            if not bitwise_equal(got, again):
                raise AssertionError(f"spike_gather {name} ({case}): two calls "
                                     f"differ")


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(device) -> list[dict]:
    """`check`, then each formulation timed at the probe's shape beside
    its plain version (event means of back-to-back calls)."""
    check(device)
    ctx, idx = probe_inputs(device)
    return [{"name": name, "ms": cuda_ms(lambda: fn(ctx, idx)),
             "plain_ms": cuda_ms(lambda: fn.plain(ctx, idx))}
            for name, fn in FORMULATIONS]


def main() -> int:
    if not torch.cuda.is_available():
        print("spike_gather: needs an NVIDIA GPU (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"ctx ({HW}, {C}) bf16, idx ({N_CHUNKS}, {M}) int32 on "
          f"{torch.cuda.get_device_name(0)}")
    for row in run(dev):
        print(f"{row['name']:14s} {row['ms']:8.4f} ms  exact  (plain "
              f"{row['plain_ms']:.4f} ms; event means)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
