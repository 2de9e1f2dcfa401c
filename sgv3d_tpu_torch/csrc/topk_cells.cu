// Exact top-k along the height-bin axis with the paired BEV cell id.
//
// Replaces the TPU kernel sgv3d_tpu/ops/pallas_topk.py
// (`pallas_topk_with_cells`, body `_kernel`): for every (camera, pixel) row
// of an (N, HW, D) float32 height tensor, pick the k largest bins in
// descending order, ties to the lowest bin index (the order of `lax.top_k`
// and of a stable descending sort), and take the cell id of each picked bin
// from the (N, HW, D) int32 cell tensor. Both outputs are written in the
// (N, k, HW) layout that the lift-splat pooling reads.
//
// What bounds it on an H100: memory. A row reads D * 8 bytes and writes
// k * 8 bytes (90 bins and k = 16 at the main path: 848 bytes a row).
//
// Design: a block takes kThreads / L contiguous rows, L = 2 or 4 lanes a
// row.
//   - The block's heights, contiguous in (N, HW, D), come into shared
//     memory as one `cp.async.bulk` completing on an mbarrier (its last
//     bytes, when the size is no multiple of 16, by plain loads).
//   - Lane l of a row scans bins l, l + L, ... in ascending order and keeps
//     a register-resident list of its best KMAX (value, bin), sorted by
//     value descending then bin ascending, inserting with predicated
//     shifts. Values are compared as order-preserving ints, one compare a
//     slot; the list starts as sentinels below every float, -inf included,
//     so rows with fewer than k finite bins still yield k distinct bins in
//     ascending bin order, as a stable sort does.
//   - k rounds of a shuffle argmax over the L list heads merge the lists;
//     the lane that owns the winner pops it.
//   - The k winners of each row go to shared memory, in place of the
//     heights (so that enough blocks fit an SM to take both served shapes
//     in one wave); then every thread gathers the cell id of each of its
//     winners, all in flight together, and writes (N, k, HW) coalesced
//     across rows.
// NaN is not handled (softmax gives none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Heights as order-preserving ints: a > b as floats iff ord(a) > ord(b);
// -0.0 counts as +0.0, as the float compare has them equal. Every real
// height, -inf included, is above kSentinel.
__device__ __forceinline__ int ord(float v) {
  const int b = __float_as_int(v == 0.f ? 0.f : v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unord(int o) {
  return __int_as_float(o ^ ((o >> 31) & 0x7fffffff));
}

constexpr int kSentinel = INT32_MIN;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Insert (v, b) into the lane's list (lv, lb) of KMAX entries, sorted by
// value descending, dropping the last; a no-op unless v beats the last
// entry. The lane's bins come in ascending order, so an equal value never
// moves ahead of an entry already there.
template <int KMAX>
__device__ __forceinline__ void insert(int (&lv)[KMAX], int (&lb)[KMAX], int v,
                                       int b) {
  bool beats[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) beats[i] = v > lv[i];
#pragma unroll
  for (int i = KMAX - 1; i > 0; --i) {
    lv[i] = beats[i - 1] ? lv[i - 1] : (beats[i] ? v : lv[i]);
    lb[i] = beats[i - 1] ? lb[i - 1] : (beats[i] ? b : lb[i]);
  }
  if (beats[0]) {
    lv[0] = v;
    lb[0] = b;
  }
}

template <int KMAX, int L>
__global__ void __launch_bounds__(kThreads)
topk_cells_kernel(const float* __restrict__ h, const int* __restrict__ cells,
                  float* __restrict__ out_vals, int* __restrict__ out_cells,
                  int rows, int d, int k, int hw) {
  constexpr int kPix = kThreads / L;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  // the rows' heights, then (once every list is built) the winners
  float* s_h = reinterpret_cast<float*>(smem);                   // kPix * d
  float* s_v = s_h;                                              // k * kPix
  int* s_b = reinterpret_cast<int*>(s_v + KMAX * kPix);          // k * kPix

  const int row0 = blockIdx.x * kPix;
  const int npix = min(kPix, rows - row0);
  const int n_floats = npix * d;
  const int bulk = (n_floats * 4) & ~15;  // bytes the bulk copy moves
  const float* src = h + static_cast<int64_t>(row0) * d;
  const int* src_c = cells + static_cast<int64_t>(row0) * d;
  const uint32_t b_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b_addr));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bulk > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              b_addr),
          "r"(bulk)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s_h)),
          "l"(src), "r"(bulk), "r"(b_addr)
          : "memory");

    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b_addr)
                   : "memory");
    }
  }
  for (int i = bulk / 4 + threadIdx.x; i < n_floats; i += kThreads) s_h[i] = src[i];
  mbar_wait(b_addr, 0);
  __syncthreads();

  const int pix = threadIdx.x / L;
  const int sub = threadIdx.x % L;
  int lv[KMAX];
  int lb[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    lv[i] = kSentinel;
    lb[i] = INT32_MAX;
  }
  if (pix < npix) {
    const float* hr = s_h + pix * d;
    for (int bin = sub; bin < d; bin += L) {
      const int v = ord(hr[bin]);
      if (v > lv[KMAX - 1]) insert(lv, lb, v, bin);
    }
  }
  __syncthreads();  // the heights are dead; s_v and s_b take their place

  for (int r = 0; r < k; ++r) {
    int bv = lv[0];
    int bb = lb[0];
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      const int ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int ob = __shfl_xor_sync(0xffffffffu, bb, o);
      if (ov > bv || (ov == bv && ob < bb)) {
        bv = ov;
        bb = ob;
      }
    }
    if (lb[0] == bb) {  // this lane owned the winner: pop it
#pragma unroll
      for (int i = 0; i < KMAX - 1; ++i) {
        lv[i] = lv[i + 1];
        lb[i] = lb[i + 1];
      }
      lv[KMAX - 1] = kSentinel;
      lb[KMAX - 1] = INT32_MAX;
    }
    if (sub == r % L) {
      s_v[r * kPix + pix] = unord(bv);
      s_b[r * kPix + pix] = bb;
    }
  }
  __syncthreads();

  // every cell gather of the thread is issued before the first store
  constexpr int kOut = (KMAX * kPix + kThreads - 1) / kThreads;
  int cv[kOut] = {};
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int px = idx % kPix;
    if (idx < k * kPix && px < npix) {
      cv[i] = __ldg(src_c + static_cast<int64_t>(px) * d + s_b[idx]);
    }
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPix;
    const int px = idx - r * kPix;
    if (idx >= k * kPix || px >= npix) continue;
    const int row = row0 + px;
    const int n = row / hw;
    const int64_t o = (static_cast<int64_t>(n) * k + r) * hw + (row - n * hw);
    out_vals[o] = s_v[idx];
    out_cells[o] = cv[i];
  }
}

template <int KMAX, int L>
int launch(const float* h, const int* cells, float* out_vals, int* out_cells,
           int rows, int d, int k, int hw, cudaStream_t stream) {
  constexpr int kPix = kThreads / L;
  const size_t smem = sizeof(float) * kPix * (d > 2 * KMAX ? d : 2 * KMAX);
  auto kernel = topk_cells_kernel<KMAX, L>;
  if (smem > 232448) return -1;  // above an SM's shared memory for a block
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((rows + kPix - 1) / kPix);
  kernel<<<grid, kThreads, smem, stream>>>(h, cells, out_vals, out_cells, rows,
                                           d, k, hw);
  return static_cast<int>(cudaGetLastError());
}

template <int KMAX>
int launch_lanes(int lanes, const float* h, const int* cells, float* out_vals,
                 int* out_cells, int rows, int d, int k, int hw,
                 cudaStream_t stream) {
  switch (lanes) {
    case 2: return launch<KMAX, 2>(h, cells, out_vals, out_cells, rows, d, k, hw, stream);
    case 4: return launch<KMAX, 4>(h, cells, out_vals, out_cells, rows, d, k, hw, stream);
    default: return -1;
  }
}

}  // namespace

// h, cells: (N, HW, D) contiguous, h 16-byte aligned; out_vals, out_cells:
// (N, k, HW). rows = N * HW; lanes per row 2 or 4. Requires
// D <= 256 and 0 < k <= min(D, 32). Returns -1 for bad arguments, else the
// launch's CUDA error code.
extern "C" int topk_cells_launch(const float* h, const int* cells,
                                 float* out_vals, int* out_cells, int rows,
                                 int d, int k, int hw, int lanes,
                                 cudaStream_t stream) {
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || d > 256 || k <= 0 || k > d || k > 32 || hw <= 0 ||
      reinterpret_cast<uintptr_t>(h) % 16)
    return -1;
  if (k <= 4)
    return launch_lanes<4>(lanes, h, cells, out_vals, out_cells, rows, d, k, hw, stream);
  if (k <= 16)
    return launch_lanes<16>(lanes, h, cells, out_vals, out_cells, rows, d, k, hw, stream);
  return launch_lanes<32>(lanes, h, cells, out_vals, out_cells, rows, d, k, hw, stream);
}
