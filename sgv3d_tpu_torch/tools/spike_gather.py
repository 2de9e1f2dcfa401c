"""Probe: three ways to gather context rows by pixel id in a kernel (K4).

Port of the TPU probe `tools/spike_pallas_gather.py`: gather rows of a
context `ctx (HW, C)` bf16 by `idx (N_CHUNKS, M)` int32 into
`(N_CHUNKS, M, C)` bf16, as a row take, as a take-along with one index load
per element, and as a one-hot product (the TPU's matrix-unit formulation),
each a hand-written kernel in `csrc/spike_gather.cu`. All three are exact
against `ctx[idx]`, the plain version and the probe's oracle. An index
outside [0, HW) gives a zero row from each kernel (the one-hot product's
answer); `ctx[idx]` raises on it.

    python -m sgv3d_tpu_torch.tools.spike_gather

prints one line per formulation with its time and the plain version's on
the card, and raises on a mismatch. It needs an NVIDIA GPU.
"""
from __future__ import annotations

import sys

import torch

from sgv3d_tpu_torch.ops import cuda_lib

HW, C, M = 5184, 128, 2048   # ctx rows, channels, points per chunk
N_CHUNKS = 40


def gather_plain(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ctx[idx]: (HW, C) rows by (..., M) indices -> (..., M, C)."""
    return ctx[idx.long()]


def _launch(name: str, ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    dev = ctx.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"{name}: unsupported devices {dev}, {idx.device}")
    if ctx.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: need bf16 ctx and int32 idx; got "
                        f"{ctx.dtype}, {idx.dtype}")
    hw, c = ctx.shape if ctx.dim() == 2 else (0, 0)
    if hw == 0 or c % 8 or (name == "spike_onehot" and c != 128):
        raise ValueError(f"{name}: ctx {tuple(ctx.shape)}; need (HW, C) with "
                         f"C % 8 == 0 (C == 128 for the one-hot product)")
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
    """A warp per output row, 16-byte loads of the row."""
    if ctx.device.type == "cpu":
        return gather_plain(ctx, idx)
    out = _launch("spike_take", ctx, idx)
    gather_take.launches += 1
    return out


def gather_take_along(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A thread per output element, each with its own index load."""
    if ctx.device.type == "cpu":
        return gather_plain(ctx, idx)
    out = _launch("spike_take_along", ctx, idx)
    gather_take_along.launches += 1
    return out


def gather_onehot(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """one_hot(idx) (never stored) @ ctx on the tensor cores, fp32 sums."""
    if ctx.device.type == "cpu":
        return gather_plain(ctx, idx)
    out = _launch("spike_onehot", ctx, idx)
    gather_onehot.launches += 1
    return out


gather_take.launches = 0
gather_take_along.launches = 0
gather_onehot.launches = 0

FORMULATIONS = (("take", gather_take), ("take_along", gather_take_along),
                ("onehot-mma", gather_onehot))


def probe_inputs(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's ctx (HW, C) bf16 and idx (N_CHUNKS, M) int32."""
    g = torch.Generator().manual_seed(seed)
    ctx = torch.randn(HW, C, generator=g).to(torch.bfloat16)
    idx = torch.randint(0, HW, (N_CHUNKS, M), generator=g, dtype=torch.int32)
    return ctx.to(device), idx.to(device)


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
    """Each formulation against `ctx[idx]` (exact) and timed beside it;
    raises on a mismatch."""
    ctx, idx = probe_inputs(device)
    ref = gather_plain(ctx, idx)
    plain_ms = cuda_ms(lambda: gather_plain(ctx, idx))
    rows = []
    for name, fn in FORMULATIONS:
        got = fn(ctx, idx)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            bad = int((got != ref).sum()) if got.shape == ref.shape else -1
            raise AssertionError(f"spike_gather {name}: {bad} elements differ "
                                 f"from ctx[idx]")
        rows.append({"name": name, "ms": cuda_ms(lambda: fn(ctx, idx)),
                     "plain_ms": plain_ms})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("spike_gather: needs an NVIDIA GPU (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"ctx ({HW}, {C}) bf16, idx ({N_CHUNKS}, {M}) int32 on "
          f"{torch.cuda.get_device_name(0)}")
    for row in run(dev):
        print(f"{row['name']:14s} {row['ms']:8.4f} ms  exact  (plain ctx[idx] "
              f"{row['plain_ms']:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
