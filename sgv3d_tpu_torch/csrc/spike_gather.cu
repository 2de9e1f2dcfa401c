// In-kernel row gather probe: three ways to gather context rows by pixel id.
//
// Replaces the TPU probe tools/spike_pallas_gather.py (`run` over
// `_kernel_take`, `_kernel_taa`, `_kernel_onehot`), which asked whether a
// Pallas kernel can gather rows of a VMEM-resident context by index:
//   out[m, :] = ctx[idx[m], :]       ctx (HW, C) bf16, idx (M,) int32
// at the probe's shape ctx (5184, 128), idx (40, 2048) -> (40, 2048, 128).
//
// What bounds it on an H100: `take` and `take_along` are memory-bound: each
// output row is a 256-byte copy of a context row that stays in L2 (the
// whole context is 1.3 MB), so the 21 MB of output writes set the time.
// `onehot` is the TPU's matrix-unit formulation: the (M, HW) one-hot
// matrix times ctx, 81920 x 5184 x 128 multiply-adds (54 G), compute-bound
// on the tensor cores, with nothing gained from the zeros.
//
// Design:
//   take        one warp per output row; its lanes copy the row as 16-byte
//               vectors (16 lanes at C = 128), coalesced on both sides;
//   take_along  one thread per output element, each with its own index
//               load (the broadcast take-along-axis of the probe);
//   onehot      a block of 8 warps owns 128 output rows (16 a warp, all C
//               columns); ctx is staged into shared memory 64 rows at a
//               time; each warp builds its rows' one-hot A fragments in
//               registers (1.0 where idx == k, never stored) and multiplies
//               them with mma.sync m16n8k16 against ctx, fp32 accumulators,
//               bf16 out. Exact: each sum has a single nonzero term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// An index outside [0, hw) gives a zero row in all three formulations (the
// one-hot product's answer), so no kernel reads outside ctx.
__global__ void take_kernel(const bf16* __restrict__ ctx,
                            const int* __restrict__ idx, bf16* __restrict__ out,
                            int m, int hw, int c) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                      (threadIdx.x >> 5);
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  const int vecs = c / 8;  // 16-byte vectors of 8 bf16
  const int id = idx[row];
  const bool inside = id >= 0 && id < hw;
  const uint4* src = reinterpret_cast<const uint4*>(ctx + static_cast<int64_t>(id) * c);
  uint4* dst = reinterpret_cast<uint4*>(out + row * c);
  for (int v = lane; v < vecs; v += 32)
    dst[v] = inside ? __ldg(src + v) : make_uint4(0u, 0u, 0u, 0u);
}

__global__ void take_along_kernel(const bf16* __restrict__ ctx,
                                  const int* __restrict__ idx,
                                  bf16* __restrict__ out, int m, int hw, int c) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(m) * c) return;
  const int64_t row = e / c;
  const int ch = static_cast<int>(e - row * c);
  const int id = __ldg(idx + row);
  out[e] = id >= 0 && id < hw ? ctx[static_cast<int64_t>(id) * c + ch]
                              : __float2bfloat16(0.f);
}

constexpr int kOneHotWarps = 8;
constexpr int kOneHotRows = 16 * kOneHotWarps;  // output rows a block
constexpr int kOneHotC = 128;                   // columns, all in registers
constexpr int kKChunk = 64;                     // ctx rows staged at a time
constexpr int kCtxStride = kOneHotC + 8;        // padded shared row

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two one-hot entries (k, k + 1) of a row whose index is `id`, packed bf16.
__device__ __forceinline__ uint32_t onehot_pair(int id, int k) {
  constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0
  return (id == k ? kOne : 0u) | (id == k + 1 ? kOne << 16 : 0u);
}

// B fragment of m16n8k16 from a row-major (k, n) shared tile: the pair
// (k, n), (k + 1, n) packed low / high.
__device__ __forceinline__ uint32_t b_pair(const bf16* s, int k, int n) {
  const uint16_t lo = reinterpret_cast<const uint16_t*>(s)[k * kCtxStride + n];
  const uint16_t hi = reinterpret_cast<const uint16_t*>(s)[(k + 1) * kCtxStride + n];
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__global__ void __launch_bounds__(kOneHotWarps * 32)
onehot_kernel(const bf16* __restrict__ ctx, const int* __restrict__ idx,
              bf16* __restrict__ out, int m, int hw) {
  __shared__ __align__(16) bf16 tile[kKChunk * kCtxStride];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kOneHotRows + 16 * warp;
  // this lane's two rows (g, g + 8); rows past m get an index never matched
  const int id0 = r0 + g < m ? idx[r0 + g] : -2;
  const int id1 = r0 + g + 8 < m ? idx[r0 + g + 8] : -2;

  float acc[kOneHotC / 8][4];
#pragma unroll
  for (int j = 0; j < kOneHotC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < hw; k0 += kKChunk) {
    __syncthreads();
    constexpr int kVecs = kOneHotC / 8;
    for (int v = threadIdx.x; v < kKChunk * kVecs; v += blockDim.x) {
      const int row = v / kVecs;
      const int part = v - row * kVecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < hw)
        val = __ldg(reinterpret_cast<const uint4*>(
                        ctx + static_cast<int64_t>(k0 + row) * kOneHotC) + part);
      reinterpret_cast<uint4*>(tile + row * kCtxStride)[part] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKChunk; kk += 16) {
      const int k = k0 + kk + 2 * t;
      const uint32_t a[4] = {onehot_pair(id0, k), onehot_pair(id1, k),
                             onehot_pair(id0, k + 8), onehot_pair(id1, k + 8)};
#pragma unroll
      for (int j = 0; j < kOneHotC / 8; ++j) {
        const int n = 8 * j + g;
        mma_bf16(acc[j], a, b_pair(tile, kk + 2 * t, n),
                 b_pair(tile, kk + 2 * t + 8, n));
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = r0 + g + 8 * half;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kOneHotC / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[j][2 * half],
                                                     acc[j][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + row * kOneHotC + 8 * j + 2 * t) = v;
    }
  }
}

}  // namespace

// ctx (hw, c) bf16, 16-byte aligned; idx (m,) int32; out (m, c) bf16.
// take needs c % 8 == 0; onehot needs c == 128.
extern "C" int spike_take_launch(const bf16* ctx, const int* idx, bf16* out,
                                 int m, int hw, int c, cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (c % 8 != 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWarps = 8;
  const unsigned blocks = static_cast<unsigned>((m + kWarps - 1) / kWarps);
  take_kernel<<<blocks, kWarps * 32, 0, stream>>>(ctx, idx, out, m, hw, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spike_take_along_launch(const bf16* ctx, const int* idx,
                                       bf16* out, int m, int hw, int c,
                                       cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const int64_t n = static_cast<int64_t>(m) * c;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  take_along_kernel<<<blocks, kThreads, 0, stream>>>(ctx, idx, out, m, hw, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spike_onehot_launch(const bf16* ctx, const int* idx, bf16* out,
                                   int m, int hw, int c, cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (c != kOneHotC || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((m + kOneHotRows - 1) / kOneHotRows);
  onehot_kernel<<<blocks, kOneHotWarps * 32, 0, stream>>>(ctx, idx, out, m, hw);
  return static_cast<int>(cudaGetLastError());
}
