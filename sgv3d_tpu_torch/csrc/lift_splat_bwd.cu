// Lift-splat BEV pooling backward (K2b): the gradients of
//   BEV[b, cell, :] = sum over points q = (n, j, p) of the cameras of b with
//                     cells[q] == cell of height[q] * context[n, p, :]
// with respect to height and context, given g = dL/dBEV (B, num_cells, C):
//   d_height[n, j, p] = <g[b, cells[n, j, p], :], context[n, p, :]>
//   d_ctx[n, p, :]    = sum over j of height[n, j, p] * g[b, cells[n, j, p], :]
// with b = n / (N / B); a point whose cell lies outside [0, num_cells) (the
// trash cell) gets d_height 0 and adds nothing to d_ctx; cells get no
// gradient.
//
// Replaces the backward of sgv3d_tpu/ops/voxel_pooling.py:142
// (`_lift_splat_bwd`, the custom VJP of `lift_splat_pool`): on the TPU XLA
// gathers and einsums, there was no Pallas kernel for it.
//
// What bounds it on an H100. The bytes the function must move (heights,
// cells, d_height, context, d_ctx and g, each once) are about 85 MB at the
// training shape (2 cameras, 90 bins, 108x192 pixels, C = 87, 128x128
// cells): 0.025 ms at 3.35 TB/s. But every live point needs a whole
// C-float row of g (348 bytes at C = 87), 2.85 M rows a call on the rig's
// cells: 992 MB. Gathered from L2 one point at a time (the first design,
// 0.35 ms) that was the time; read from shared memory at ~30 TB/s over
// 132 SMs it is about 0.033 ms. Measured (`chip_smoke.py --time-k2b`),
// what bounds this design is the instructions a point costs in step 4
// (about 20: a broadcast, three row loads, six fmas, a share of a
// shuffle and two selects) and the block's fixed steps 1-3 and 5, which
// run one after another with one wide block an SM.
//
// What the tiles do about the gathers. Neighbouring pixels look along
// neighbouring rays, so their points land in the same few BEV cells: an
// 8x8 patch of the rig's feature map holds 5760 points (90 bins) on 53
// distinct cells at the median, 358 at most, about 44 points a distinct
// cell. A block takes one TH x TW patch of one camera (TW consecutive
// pixels a patch row, one 32-byte sector at TW = 8), so its rows of g are
// read from L2 once a block, not once a point (about 22.5 MB a call on the
// rig):
//   1. the patch's (J, TH*TW) cells and heights go to shared memory by
//      4-byte cp.async, one (code, height) pair a point, J padded to
//      whole groups of step 4 with trash;
//   2. each live point's cell goes into an open-addressing table of
//      kSlots entries in shared memory; lanes of a warp holding the same
//      cell (`__match_any_sync`) insert it once. A new cell takes the next
//      of at most `rows` staging rows, or none once they are taken (at
//      most rows + threads keys ever enter the table, so it never fills);
//      which cell gets which row depends on the race between inserts, the
//      results do not: every point reads the same numbers wherever its row
//      sits;
//   3. each point's code becomes the byte offset of its staging row (the
//      trash: an all-zero row, with height 0), or its cell (negated) when
//      it got none, and every staged row of g is copied in once by 4-byte
//      cp.async, a warp a row (a 348-byte row is neither a multiple of
//      TMA's 16 bytes nor 16-byte aligned);
//   4. a warp a pixel, its context row in registers (the next pixel's
//      loaded ahead), lanes owning channels c = lane + 32 s: each point's
//      row read from shared memory (or, for a point whose cell got no row,
//      from global memory, as the first design did; only blocks with such
//      points take that branch), a lane's partial dot product, and the
//      fp32 accumulation of height * g_row into the d_ctx row point by
//      point in j order. The dot products of a group of 16 or 32 points
//      are summed over the lanes together (`pixels`): the same tree as a
//      xor butterfly a point, G - 1 shuffles for G points, at most five
//      values pending. A warp reads 32 consecutive floats of one row, so
//      the rows need no padding against bank conflicts. d_height goes over
//      the point's height in shared memory, then out coalesced (step 5).
// The arithmetic of each point is the first design's, in the same order,
// so the outputs are its bits; there are no float atomics, so they are
// the same on every run, whatever the batch around a camera. Wide blocks
// (the all-bin layout) take 32 warps and up to 384 rows, one an SM;
// narrow ones (J <= 32, the top-k layout) 16 warps and two an SM, so that
// one block's fixed steps overlap the other's step 4. Uniform cells (~1.2
// points a distinct cell in a patch) stay near the first design's time.
// Both lift layouts are (N, J, HW): J = D for the all-bin lift, k for the
// top-k one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;                  // pixels: a TH x TW patch
constexpr int kTileW = 8;
constexpr int kPix = kTileH * kTileW;
constexpr int kPitch = kPix + 1;           // (code, height) pairs a bin row
constexpr int kUnroll = 4;                 // rows a warp has in flight
constexpr int kLogSlots = 11;
constexpr int kSlots = 1 << kLogSlots;     // cell table entries
constexpr int kMaxChannelSlots = 4;        // C <= 128
constexpr int kMaxJ = 256;
constexpr int kNarrowJ = 32;               // J <= this: two blocks an SM
constexpr int kEmpty = -1;                 // a free table entry
constexpr int kTrash = kSlots;             // a trash point's code in steps 2-3
constexpr unsigned short kNoRow = 0xffff;  // a cell that got no staging row

// Two shapes of block. Wide (J > kNarrowJ): 32 warps, one block an SM and
// up to 384 rows. Narrow (the top-k layout): 16 warps and two blocks an SM,
// whose table, staging and write phases then overlap each other's
// compute. Both keep to 64 registers a thread.
template <bool kNarrow>
struct Shape {
  static constexpr int kWarps = kNarrow ? 16 : 32;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBlocksPerSm = kNarrow ? 2 : 1;
  static constexpr int kPixPerWarp = kPix / kWarps;
  static constexpr int kMaxRows = 384;
  // dynamic shared memory a block may use: an SM has 228 KB, a block 227
  static constexpr int kSmemBudget = kNarrow ? 233472 / 2 - 1024 : 232448;
  static_assert(kMaxRows + kThreads < kSlots, "the cell table must never fill");
  static_assert(kPix % kWarps == 0 && kPix % 32 == 0, "whole warps of points a bin");
};

// The bins a pixel's points are taken in, J rounded up to whole groups
// of points (step 4: 16 in a narrow block of J <= 16, else 32; the rest
// trash).
__host__ __device__ constexpr int padded_j(int j) {
  return j <= 16 && j <= kNarrowJ ? 16 : (j + 31) & ~31;
}

// shared memory: (code, height) pairs [padded J][kPitch], the table's keys
// [kSlots] and rows [kSlots], the row count and the overflow flag, then
// the staged rows [rows + 1][C] (the last all zeros, the trash's)
__host__ __device__ constexpr int rows_offset(int j) {
  return (padded_j(j) * kPitch * 8 + kSlots * 4 + kSlots * 2 + 16 + 15) & ~15;
}

static_assert(rows_offset(kMaxJ) + 2 * 4 * 32 * kMaxChannelSlots <= 232448,
              "a row of g and the zero row fit beside the largest J");
static_assert(rows_offset(kNarrowJ) + 2 * 4 * 32 * kMaxChannelSlots <= 233472 / 2 - 1024,
              "and beside a narrow block's J");

template <bool kNarrow>
int plan_rows(int j, int c) {
  const int room = (Shape<kNarrow>::kSmemBudget - rows_offset(j)) / (c * 4) - 1;
  return room < Shape<kNarrow>::kMaxRows ? room : Shape<kNarrow>::kMaxRows;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned slot_of(int cell) {
  return (static_cast<unsigned>(cell) * 2654435761u) >> (32 - kLogSlots);
}

// The table entry of `cell`, inserting it if there is still a row for it;
// -1 if it is not in the table and no row is left.
__device__ int insert_cell(int cell, int* keys, unsigned short* row_of,
                           int* count, int rows) {
  unsigned h = slot_of(cell);
  while (true) {
    int k = *reinterpret_cast<volatile int*>(keys + h);
    if (k == cell) return static_cast<int>(h);
    if (k == kEmpty) {
      if (*reinterpret_cast<volatile int*>(count) >= rows) return -1;
      k = atomicCAS(keys + h, kEmpty, cell);
      if (k == kEmpty) {
        const int r = atomicAdd(count, 1);
        row_of[h] = r < rows ? static_cast<unsigned short>(r) : kNoRow;
        return static_cast<int>(h);
      }
      if (k == cell) return static_cast<int>(h);
    }
    h = (h + 1) & (kSlots - 1);
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <bool kNarrow, int CS>
__global__ void __launch_bounds__(Shape<kNarrow>::kThreads, Shape<kNarrow>::kBlocksPerSm)
lift_splat_bwd_kernel(const float* __restrict__ grad,
                      const float* __restrict__ height,
                      const float* __restrict__ context,
                      const int* __restrict__ cells,
                      float* __restrict__ d_height, float* __restrict__ d_ctx,
                      int* __restrict__ served, int cams_per_b, int num_cells,
                      int j_count, int hw, int feat_w, int tile_h, int tile_w,
                      int c_count, int rows) {
  using S = Shape<kNarrow>;
  constexpr int kWarps = S::kWarps, kThreads = S::kThreads;
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int j_pad = padded_j(j_count);
  int2* s_pt = reinterpret_cast<int2*>(s_raw);
  int* s_key = reinterpret_cast<int*>(s_pt + j_pad * kPitch);
  unsigned short* s_row_of = reinterpret_cast<unsigned short*>(s_key + kSlots);
  int* s_count = reinterpret_cast<int*>(s_row_of + kSlots);
  int* s_overflow = s_count + 1;     // some live point's cell got no row
  float* s_rows = reinterpret_cast<float*>(s_raw + rows_offset(j_count));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int tiles_x = (feat_w + tile_w - 1) / tile_w;
  const int y0 = static_cast<int>(blockIdx.x) / tiles_x * tile_h;
  const int x0 = static_cast<int>(blockIdx.x) % tiles_x * tile_w;
  const int feat_h = hw / feat_w;
  const int points = j_pad * kPix;
  const size_t cam = static_cast<size_t>(n) * j_count * hw;
  const float* g_b =
      grad + static_cast<size_t>(n / cams_per_b) * num_cells * c_count;
  const int row_bytes = c_count * 4;
  // the flat pixel of the patch's pixel pp, or -1 past the feature map
  auto pixel = [&](int pp) {
    const int y = y0 + pp / tile_w, x = x0 + pp % tile_w;
    return y < feat_h && x < feat_w ? y * feat_w + x : -1;
  };
  auto load_ctx = [&](int pp, float (&v)[CS]) {
    const int p = pixel(pp);
    const float* row = context + (static_cast<size_t>(n) * hw + max(p, 0)) * c_count;
#pragma unroll
    for (int s = 0; s < CS; ++s) {
      const int c = lane + 32 * s;
      v[s] = p >= 0 && c < c_count ? __ldg(row + c) : 0.f;
    }
  };

  // 0. this warp's first pixel's context row, in flight while the tables fill
  float ctx[CS];
  load_ctx(warp, ctx);

  // 1. the patch's cells and heights
  for (int i = threadIdx.x; i < kSlots; i += kThreads) s_key[i] = kEmpty;
  if (threadIdx.x == 0) *s_count = *s_overflow = 0;
  for (int i = threadIdx.x; i < points; i += kThreads) {
    const int j = i / kPix, pp = i % kPix, p = pixel(pp);
    int2* e = s_pt + j * kPitch + pp;
    if (p >= 0 && j < j_count) {
      const size_t q = cam + static_cast<size_t>(j) * hw + p;
      cp_async4(&e->x, cells + q);
      cp_async4(&e->y, height + q);
    } else {
      *e = make_int2(-1, 0);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the live points' cells into the table: a table entry (< kSlots), or
  // -(cell + 1) when it got none, or kTrash
  for (int i0 = warp * 32; i0 < points; i0 += kThreads) {  // warp-uniform
    const int i = i0 + lane;
    int2* e = s_pt + i / kPix * kPitch + i % kPix;
    const int cell = e->x;
    const bool live = cell >= 0 && cell < num_cells;
    const unsigned peers = __match_any_sync(0xffffffffu, live ? cell : -1);
    const int leader = __ffs(peers) - 1;
    int slot = -1;
    if (live && lane == leader)
      slot = insert_cell(cell, s_key, s_row_of, s_count, rows);
    slot = __shfl_sync(0xffffffffu, slot, leader);
    e->x = !live ? kTrash : slot >= 0 ? slot : -(cell + 1);
    if (live && slot < 0) *s_overflow = 1;
  }
  __syncthreads();

  // 3. codes to the byte offsets of staged rows (the trash: the zero row,
  // with height 0), or -(cell + 1); the staged rows of g copied in, a warp
  // a row
  int mine = 0;
  for (int i = threadIdx.x; i < points; i += kThreads) {
    int2* e = s_pt + i / kPix * kPitch + i % kPix;
    const int code = e->x;
    if (code == kTrash) {
      *e = make_int2(rows * row_bytes, 0);
    } else if (code >= 0) {
      const unsigned short r = s_row_of[code];
      mine += r != kNoRow;
      e->x = r != kNoRow ? r * row_bytes : -(s_key[code] + 1);
      if (r == kNoRow) *s_overflow = 1;
    }
  }
  if (served != nullptr) {
    mine = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0 && mine) atomicAdd(served, mine);
  }
  for (int c = threadIdx.x; c < c_count; c += kThreads) s_rows[rows * c_count + c] = 0.f;
  for (int base = warp * 32; base < kSlots; base += kThreads) {
    const int key = s_key[base + lane];
    const int r = key != kEmpty ? s_row_of[base + lane] : kNoRow;
    unsigned want = __ballot_sync(0xffffffffu, r != kNoRow);
    while (want) {
      const int b = __ffs(want) - 1;
      want &= want - 1;
      const int kb = __shfl_sync(0xffffffffu, key, b);
      const int rb = __shfl_sync(0xffffffffu, r, b);
      const float* src = g_b + static_cast<size_t>(kb) * c_count;
      float* dst = s_rows + rb * c_count;
#pragma unroll
      for (int s = 0; s < CS; ++s) {
        const int c = lane + 32 * s;
        if (c < c_count) cp_async4(dst + c, src + c);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 4. a warp a pixel, in groups of G = 2^M points. Each point's dot
  // product is a lane's partial over its channels, then a sum over the
  // lanes in the order of the xor butterfly over offsets 16, 8, 4, 2, 1
  // (which gives every lane the same bits); here the group's sums are
  // taken together: at offset 16 >> s, points paired by bit s of their
  // index, a lane keeps the one whose bit matches its own lane bit 16 >> s
  // and adds its partner's, as soon as both are done. G - 1 shuffles for G
  // sums, at most M values pending, and lane l ends with the point whose
  // bit s is its lane bit 16 >> s. A block whose points all got rows
  // (every block of the rig's cells) runs without a branch a point.
  const char* rows_lane = reinterpret_cast<const char*>(s_rows + lane);
  auto pixels = [&](auto mixed_flag, auto wide_flag) {
    constexpr bool kMixed = decltype(mixed_flag)::value;
    constexpr int M = decltype(wide_flag)::value ? 5 : 4;
    constexpr int G = 1 << M;
#pragma unroll
    for (int k = 0; k < S::kPixPerWarp; ++k) {
      const int pp = warp + k * kWarps;
      const int p = pixel(pp);
      float next[CS];
      if (k + 1 < S::kPixPerWarp) load_ctx(pp + kWarps, next);
      if (p >= 0) {                                          // warp-uniform
        float acc[CS];
#pragma unroll
        for (int s = 0; s < CS; ++s) acc[s] = 0.f;
        for (int j0 = 0; j0 < j_count; j0 += G) {
          float pend[M], v = 0.f;
#pragma unroll
          for (int u0 = 0; u0 < G; u0 += kUnroll) {
            int code[kUnroll];
            float h[kUnroll], gr[kUnroll][CS];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int2 e = s_pt[(j0 + u0 + u) * kPitch + pp];
              code[u] = e.x;
              h[u] = __int_as_float(e.y);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (kMixed && code[u] < 0) {       // warp-uniform: its cell got no row
                const float* src = g_b + static_cast<size_t>(-code[u] - 1) * c_count;
#pragma unroll
                for (int s = 0; s < CS; ++s) {
                  const int c = lane + 32 * s;
                  gr[u][s] = c < c_count ? __ldg(src + c) : 0.f;
                }
              } else {
                const float* src = reinterpret_cast<const float*>(rows_lane + code[u]);
#pragma unroll
                for (int s = 0; s < CS; ++s)
                  gr[u][s] = lane + 32 * s < c_count ? src[32 * s] : 0.f;
              }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              float d = 0.f;
#pragma unroll
              for (int s = 0; s < CS; ++s) d = fmaf(gr[u][s], ctx[s], d);
#pragma unroll
              for (int s = 0; s < CS; ++s) acc[s] = fmaf(h[u], gr[u][s], acc[s]);
              // fold point u0 + u into the pending sums
              const int idx = u0 + u;
              v = d;
              bool carry = true;
#pragma unroll
              for (int b = 0; b < M; ++b) {
                if (carry) {
                  if ((idx >> b) & 1) {
                    const bool upper = lane & (16 >> b);
                    const float keep = upper ? v : pend[b];
                    const float send = upper ? pend[b] : v;
                    v = keep + __shfl_xor_sync(0xffffffffu, send, 16 >> b);
                  } else {
                    pend[b] = v;
                    carry = false;
                  }
                }
              }
            }
          }
#pragma unroll
          for (int o = 16 >> M; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          int u = 0;                       // the point this lane holds
#pragma unroll
          for (int b = 0; b < M; ++b) u |= ((lane >> (4 - b)) & 1) << b;
          if (j0 + u < j_count && (lane & ((16 >> (M - 1)) - 1)) == 0)
            s_pt[(j0 + u) * kPitch + pp].y = __float_as_int(v);
        }
        float* out = d_ctx + (static_cast<size_t>(n) * hw + p) * c_count;
#pragma unroll
        for (int s = 0; s < CS; ++s) {
          const int c = lane + 32 * s;
          if (c < c_count) out[c] = acc[s];
        }
      }
      if (k + 1 < S::kPixPerWarp) {
#pragma unroll
        for (int s = 0; s < CS; ++s) ctx[s] = next[s];
      }
    }
  };
  // groups of 16 only in narrow blocks of J <= 16 (the top-k layout)
  auto run = [&](auto wide_flag) {
    if (*s_overflow) pixels(Flag<true>{}, wide_flag);
    else pixels(Flag<false>{}, wide_flag);
  };
  if constexpr (kNarrow) {
    if (j_count <= 16) run(Flag<false>{});
    else run(Flag<true>{});
  } else {
    run(Flag<true>{});
  }
  __syncthreads();

  // 5. d_height out, a patch row of TW pixels a run
  for (int i = threadIdx.x; i < j_count * kPix; i += kThreads) {
    const int j = i / kPix, pp = i % kPix, p = pixel(pp);
    if (p >= 0)
      d_height[cam + static_cast<size_t>(j) * hw + p] =
          __int_as_float(s_pt[j * kPitch + pp].y);
  }
}

template <bool kNarrow, int CS>
int launch(const float* grad, const float* height, const float* context,
           const int* cells, float* d_height, float* d_ctx, int* served,
           int batch, int num_cells, int n, int j, int hw, int feat_w,
           int tile_h, int tile_w, int c, cudaStream_t stream) {
  const int rows = plan_rows<kNarrow>(j, c);
  const int smem = rows_offset(j) + (rows + 1) * c * 4;
  cudaError_t err = cudaFuncSetAttribute(
      lift_splat_bwd_kernel<kNarrow, CS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int feat_h = hw / feat_w;
  const dim3 grid(((feat_h + tile_h - 1) / tile_h) * ((feat_w + tile_w - 1) / tile_w),
                  n);
  lift_splat_bwd_kernel<kNarrow, CS><<<grid, Shape<kNarrow>::kThreads, smem, stream>>>(
      grad, height, context, cells, d_height, d_ctx, served, n / batch,
      num_cells, j, hw, feat_w, tile_h, tile_w, c, rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNarrow>
int launch_c(const float* grad, const float* height, const float* context,
             const int* cells, float* d_height, float* d_ctx, int* served,
             int batch, int num_cells, int n, int j, int hw, int feat_w,
             int tile_h, int tile_w, int c, cudaStream_t stream) {
  switch ((c + 31) / 32) {
    case 1: return launch<kNarrow, 1>(grad, height, context, cells, d_height, d_ctx,
                                      served, batch, num_cells, n, j, hw, feat_w,
                                      tile_h, tile_w, c, stream);
    case 2: return launch<kNarrow, 2>(grad, height, context, cells, d_height, d_ctx,
                                      served, batch, num_cells, n, j, hw, feat_w,
                                      tile_h, tile_w, c, stream);
    case 3: return launch<kNarrow, 3>(grad, height, context, cells, d_height, d_ctx,
                                      served, batch, num_cells, n, j, hw, feat_w,
                                      tile_h, tile_w, c, stream);
    default: return launch<kNarrow, 4>(grad, height, context, cells, d_height, d_ctx,
                                       served, batch, num_cells, n, j, hw, feat_w,
                                       tile_h, tile_w, c, stream);
  }
}

}  // namespace

// The tile a call with J bins and C channels takes: out = (tile height,
// tile width, staging rows, dynamic shared memory bytes, blocks an SM). A
// call without the feature map's width takes 1 x (TH * TW) pixels instead.
extern "C" int lift_splat_bwd_plan(int j, int c, int* out) {
  if (j <= 0 || j > kMaxJ || c <= 0 || c > 32 * kMaxChannelSlots) return -1;
  const bool narrow = j <= kNarrowJ;
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = narrow ? plan_rows<true>(j, c) : plan_rows<false>(j, c);
  out[3] = rows_offset(j) + (out[2] + 1) * c * 4;
  out[4] = narrow ? Shape<true>::kBlocksPerSm : Shape<false>::kBlocksPerSm;
  return 0;
}

// grad: (batch, num_cells, C) fp32; height: (N, J, HW) fp32; context:
// (N, HW, C) fp32; cells: (N, J, HW) int32; d_height: (N, J, HW) fp32;
// d_ctx: (N, HW, C) fp32; served: null, or one int to which the kernel
// adds the live points it read from staged rows. feat_w: the feature map's
// width (HW = fH * fW), or 0 for none (HW taken as one row). C <= 128,
// J <= 256, N a multiple of batch.
extern "C" int lift_splat_bwd_launch(const float* grad, const float* height,
                                     const float* context, const int* cells,
                                     float* d_height, float* d_ctx, int* served,
                                     int batch, int num_cells, int n, int j,
                                     int hw, int feat_w, int c, int* launched,
                                     cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || n % batch || num_cells <= 0 || j <= 0 ||
      j > kMaxJ || hw <= 0 || c <= 0 || c > 32 * kMaxChannelSlots ||
      feat_w < 0 || (feat_w > 0 && hw % feat_w))
    return -1;
  int tile_h = kTileH, tile_w = kTileW;
  if (feat_w == 0) {
    feat_w = hw;
    tile_h = 1;
    tile_w = kPix;
  }
  const int err = j <= kNarrowJ
      ? launch_c<true>(grad, height, context, cells, d_height, d_ctx, served, batch,
                       num_cells, n, j, hw, feat_w, tile_h, tile_w, c, stream)
      : launch_c<false>(grad, height, context, cells, d_height, d_ctx, served, batch,
                        num_cells, n, j, hw, feat_w, tile_h, tile_w, c, stream);
  if (err != 0) return err;
  *launched += 1;
  return 0;
}
