// Fused ResNet identity bottleneck, inference, one launch per block.
//
// Replaces the TPU kernel sgv3d_tpu/ops/pallas_bottleneck.py
// (`fused_bottleneck_stack`, body `_kernel`): a stride-1 identity
// bottleneck with BatchNorm folded into the convs,
//   y1  = relu(x . w1 + b1)                      -> bf16   (1x1, C -> P)
//   y2  = relu(conv3x3(y1, w2) + b2)             -> bf16   (3x3, P -> P)
//   out = relu(y2 . w3 + b3 + x)                 -> bf16   (1x1, P -> C)
// with C = 4P, fp32 accumulation, and conv2's zero padding in y1-space: y1
// is exactly zero outside the image (relu(0 . w1 + b1) = relu(b1) is not).
//
// What bounds it on an H100: 17 P^2 multiply-adds an output pixel (46 GFLOP
// a block at every r50 stage at batch 4) against x read once and the output
// written once; at the first two stages the bytes and the FLOPs bound it
// about equally (~0.1 ms), at the last two the FLOPs (~0.05 ms). A block
// needs all of the folded weights (8.7 MB at P = 512) from L2: the design
// below brings each weight byte into the SM once a block per phase, shared
// by all its warps, and overlaps those loads with the products.
//
// Design: a thread block owns a TH x TW output tile of one image and runs
// three phases, each a sequence of products whose K is cut into 64-channel
// chunks. One producer thread walks the same sequence of chunks as the
// eight consumer warps and keeps a ring of 2 to 4 shared-memory stages
// full with asynchronous copies, each completing on the stage's "full"
// mbarrier; the consumers release a stage on its "empty" mbarrier once
// their products from it are complete. A stage holds one NB x 64 tile of
// the folded weights, one cp.async.bulk copy: `fold_bottleneck` stores the
// weights in the order the ring consumes them (output-channel tile, then K
// chunk), each tile already in wgmma's K-major 128-byte-swizzled layout
// (rows of 64 bf16, the 16-byte group g of row n at g ^ (n & 7)), so a
// stage needs no tensor map. Every weight byte crosses from L2 to the SM
// once a block per phase, shared by both warpgroups. In phase 1 a stage
// also holds the 64-channel chunk of x on the (TH+2) x (TW+2) halo tile,
// one TMA load of a 4-D box (tensor map over x as (C, W, H, batch)) with
// the same 128-byte swizzle; TMA fills the halo pixels outside the image
// with 0. Each block starts its walk over the output-channel tiles and K
// chunks at its own offset (its sums keep a fixed order).
//   1. y1 on the halo tile, for each NB-column tile of P: the epilogue
//      writes relu(acc + b1) as bf16, or exactly 0 for a halo pixel outside
//      the image (the padding predicate replaces the TPU kernel's H-padded
//      layout and its edge-row masking);
//   2. y2 as nine shifted products: the A rows of tap (dy, dx) are the halo
//      pixels at the output pixel's offset, so the shift is in the ldmatrix
//      row addresses and the W border needs no zero columns;
//   3. out = relu(y2 . w3 + b3 + x): for each NB-column pass, one consumer
//      thread TMA-loads the residual box of the tile into the (dead) y1
//      region while the products run; the epilogue overwrites it with the
//      bf16 output, and a TMA store writes it out, clipped to the image.
// The eight consumer warps are two warpgroups issuing wgmma m64nNk16 (bf16
// in, fp32 accumulators, N = NB / 2: each warpgroup takes every m64 row
// block of a pass and half its columns), B from the weight stage by
// descriptor; A by descriptor from the x stage in phase 1, and from
// registers filled by ldmatrix in phases 2 and 3 (the shifted halo rows of
// phase 2 are then plain row addresses, and y1 and y2 keep rows padded by
// 8 elements against bank conflicts).
//
// Tile per P (output pixels TH x TW, halo rows padded to M1 for the phase-1
// warpgroup tiling; shared memory from `smem_bytes` in
// ops/fused_bottleneck.py), chosen by timing the r50 stage shapes on an
// H100 against the alternatives in tools/k3_probe.py (see PERF.md):
//   P =  64: 8 x 16, NB  64, 2 stages, 92,000 bytes: two blocks an SM;
//   P = 128: 8 x 8,  NB 128, 2 stages, 91,232 bytes: two blocks an SM
//            (beat 8 x 16 with 3 or 4 stages at one block an SM);
//   P = 256: 8 x 8,  NB 128, 4 stages, 176,256 bytes: 336 blocks, 2.5
//            waves on 132 SMs (8 x 16 gives 168 blocks, 1.3 waves);
//   P = 512: 8 x 8,  NB 128, 3 stages, 220,784 bytes (a 16-wide tile's y1
//            halo alone is 187 KB).
// Activations are NHWC bf16 (a channels_last NCHW tensor already is), so no
// transpose and no padded copy. Every output is written once by one thread,
// with no atomics: the result is bitwise the same on every run.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked
                   // up at run time, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr int kKC = 64;                 // K elements of a ring stage
constexpr int kRow = kKC * 2;           // bytes of a stage row (128)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int P_, int TH_, int TW_, int STAGES_>
struct Cfg {
  static constexpr int P = P_, C = 4 * P_, TH = TH_, TW = TW_;
  static constexpr int STAGES = STAGES_;
  static constexpr int HALO_W = TW + 2;
  static constexpr int HALO = (TH + 2) * HALO_W;
  static constexpr int M1 = (HALO + 63) / 64 * 64;  // phase-1 rows
  static constexpr int M2 = TH * TW;                // phase-2/3 rows
  static constexpr int NB = P < 128 ? P : 128;      // columns of a pass
  static constexpr int YS = P + 8;                  // row stride of y1, y2
  static constexpr int Y1_BYTES = HALO * YS * 2;
  // x stages hold the halo rows, 128-byte swizzled by TMA, each starting
  // on a 1024-byte boundary; the area also covers the phase-1 reads of the
  // last stage's padding rows (M1 - HALO), whose products are dropped
  static constexpr int XSTAGE_BYTES = (HALO * kRow + 1023) / 1024 * 1024;
  static constexpr int AREA_BYTES =
      cmax(STAGES * XSTAGE_BYTES + (M1 - HALO) * kRow, M2 * YS * 2);
  static constexpr int WSTAGE_BYTES = NB * kRow;
  // phase 3's residual / output box of a pass: NB / 64 boxes of M2 rows,
  // in the y1 region (dead by then) from its first 1024-byte boundary
  static constexpr int RBUF_BYTES = NB / kKC * M2 * kRow;
  // + 1024 bytes to align the area's start
  static constexpr int SMEM = 1024 + AREA_BYTES + Y1_BYTES +
                              STAGES * WSTAGE_BYTES + (2 * STAGES + 1) * 8;
  // blocks an SM: two where two fit in its 228 KB (1 KB reserved a block)
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static constexpr int KCH1 = C / kKC;       // K chunks of phase 1
  static constexpr int KCH2 = 9 * P / kKC;   // of phase 2 (tap-major)
  static constexpr int KCH3 = P / kKC;       // of phase 3
  static_assert(P % kKC == 0 && M2 % 64 == 0 && NB % 16 == 0, "tile");
  static_assert(Y1_BYTES % 16 == 0 && AREA_BYTES % 16 == 0, "alignment");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(RBUF_BYTES + 1008 <= Y1_BYTES, "residual buffer");
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA load of the box at (c0, c1, c2, c3) of tensor map `map` into shared
// memory, completing on mbarrier `bar`; elements outside the tensor are 0.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                           int c0, int c1, int c2, int c3,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// TMA store of the box at (c0, c1, c2, c3) of tensor map `map` from shared
// memory, in this thread's bulk async-group; elements outside the tensor
// are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory
// (READ_ONLY) or completed.
template <bool READ_ONLY>
__device__ __forceinline__ void tma_store_wait() {
  if (READ_ONLY)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy accesses to shared memory by this thread, ordered before
// later async-proxy ones (TMA) once the threads pass a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The ring's position, advanced the same way by the producer and consumers.
template <int STAGES>
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
};

template <int MB, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MB][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// ---- wgmma -------------------------------------------------------------------
// A warpgroup (4 warps) multiplies an m64 x k16 A by a k16 x N B into 64 x N
// fp32 accumulators; warp i holds rows 16i..16i+15, in the m16n8 fragment
// layout of mma.sync (d[j] = columns 8j..8j+7). B, and A in phase 1, are
// read from shared memory through descriptors; A in phases 2 and 3 from
// registers filled by ldmatrix, so that phase 2's shifted halo rows are
// plain row addresses.

// Descriptor of a K-major operand stored as 128-byte rows with the 128-byte
// swizzle, 8-row atoms 1024 bytes apart, from shared address `addr` (the
// atom 1024-byte aligned); a k16 step adds 32 bytes, 2 in the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Commit the warpgroup's products and wait for them all.
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching registers that an in-flight wgmma reads
// or writes before this point.
template <int MB, int NJ>
__device__ __forceinline__ void pin(float (&acc)[MB][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][j][e])::"memory");
}

template <int KK, int MB>
__device__ __forceinline__ void pin(uint32_t (&a)[KK][MB][4]) {
#pragma unroll
  for (int k = 0; k < KK; ++k)
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][i][e])::"memory");
}

// m64nNk16, bf16 in, fp32 accumulators (scale-d 1), both operands K-major:
// wgmma_ss with A and B from descriptors, wgmma_rs with A from registers.
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b_desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b_desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// Release a ring stage once this warp's products from it are complete.
template <int STAGES>
__device__ __forceinline__ void release(Ring<STAGES>& ring, uint32_t empty0,
                                        int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty0 + 8 * ring.slot);
  ring.advance();
}

template <class K>
__global__ void __launch_bounds__(kThreads, K::MIN_BLOCKS)
fused_bottleneck_kernel(const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const float* __restrict__ b2,
                        const bf16* __restrict__ w3,
                        const float* __restrict__ b3,
                        const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap rmap,
                        const __grid_constant__ CUtensorMap omap, int h, int w,
                        int tiles_x, int tiles_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  // weight stages, then the area (x stages in phase 1, y2 after), each
  // 1024-byte aligned for the 128-byte swizzle; then y1 and the barriers
  unsigned char* wring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* area = wring + K::STAGES * K::WSTAGE_BYTES;
  bf16* y2s = reinterpret_cast<bf16*>(area);
  bf16* y1s = reinterpret_cast<bf16*>(area + K::AREA_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(area + K::AREA_BYTES + K::Y1_BYTES);
  const uint32_t full0 = smem_u32(bars);              // full[s] = full0 + 8s
  const uint32_t empty0 = smem_u32(bars + K::STAGES);  // empty[s]
  const uint32_t rbar = smem_u32(bars + 2 * K::STAGES);  // phase 3's box

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int oy0 = ty * K::TH;
  const int ox0 = tx * K::TW;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Every block walks its output-channel tiles and K chunks starting at
  // its own offset, so that the blocks in flight read different weight
  // tiles from L2 at a time; each block's order, and so its sums, are fixed.
  const int rot = static_cast<int>(blockIdx.x);
  auto halo_inside = [&](int row) {
    const int iy = oy0 - 1 + row / K::HALO_W;
    const int ix = ox0 - 1 + row % K::HALO_W;
    return row < K::HALO && iy >= 0 && iy < h && ix >= 0 && ix < w;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: the chunks of all three phases, in consumption order --
    if (lane != 0) return;
    Ring<K::STAGES> ring;
    // one phase: `tiles` output-channel tiles of `chunks` K chunks each
    auto walk = [&](const bf16* src, int tiles, int chunks, bool with_x) {
      for (int st = 0; st < tiles * chunks; ++st) {
        const int q = (st % chunks + rot) % chunks;
        const int tile_nk = (st / chunks + rot) % tiles * chunks + q;
        mbar_wait(empty0 + 8 * ring.slot, ring.phase ^ 1);
        const uint32_t full = full0 + 8 * ring.slot;
        mbar_arrive_expect_tx(full, K::WSTAGE_BYTES + (with_x ? K::HALO * kRow : 0));
        bulk_g2s(smem_u32(wring + ring.slot * K::WSTAGE_BYTES),
                 src + static_cast<size_t>(tile_nk) * K::NB * kKC,
                 K::WSTAGE_BYTES, full);
        if (with_x)   // the halo box of chunk q; 0 outside the image
          tma_load_4d(smem_u32(area + ring.slot * K::XSTAGE_BYTES), &xmap,
                      q * kKC, ox0 - 1, oy0 - 1, img, full);
        ring.advance();
      }
    };
    walk(w1, K::P / K::NB, K::KCH1, true);
    walk(w2, K::P / K::NB, K::KCH2, false);
    walk(w3, K::C / K::NB, K::KCH3, false);
    return;
  }

  // ---- consumers: two warpgroups; in each phase a warpgroup takes every
  // m64 row block and its half of the NB columns of a pass ----------------
  constexpr int N = K::NB / 2;
  const int wg = warp >> 2;
  const int m_w = (warp & 3) * 16;     // this warp's rows in an m64 block
  const int g = lane >> 2;
  const int t = lane & 3;
  // this lane's ldmatrix A row within an m16 tile, and its k half (bytes)
  const int a_r = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_k = (lane >> 4) * 16;
  const uint32_t w_wg = smem_u32(wring) + wg * N * kRow;  // + slot's stage
  Ring<K::STAGES> ring;

  // ---- phase 1: y1 on the halo tile ----------------------------------------
  {
    constexpr int MB = K::M1 / 64;
    float acc[MB][N / 8][4];
    for (int nt = 0; nt < K::P / K::NB; ++nt) {
      const int ntr = (nt + rot) % (K::P / K::NB);
      zero(acc);
      for (int kc = 0; kc < K::KCH1; ++kc) {
        const uint32_t xs = smem_u32(area + ring.slot * K::XSTAGE_BYTES);
        const uint64_t b_desc = sw128_desc(w_wg + ring.slot * K::WSTAGE_BYTES);
        mbar_wait(full0 + 8 * ring.slot, ring.phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            wgmma_ss(acc[mb], sw128_desc(xs + mb * 64 * kRow) + 2 * kk,
                     b_desc + 2 * kk);
        wgmma_commit_wait();
        pin(acc);
        release(ring, empty0, lane);
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mb * 64 + m_w + g + 8 * half;
          if (row >= K::HALO) continue;
          const bool inside = halo_inside(row);
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int n = ntr * K::NB + wg * N + 8 * j + 2 * t;
            const float v0 =
                inside ? fmaxf(acc[mb][j][2 * half] + __ldg(b1 + n), 0.f) : 0.f;
            const float v1 =
                inside ? fmaxf(acc[mb][j][2 * half + 1] + __ldg(b1 + n + 1), 0.f)
                       : 0.f;
            *reinterpret_cast<uint32_t*>(y1s + row * K::YS + n) =
                pack_bf16(v0, v1);
          }
        }
    }
  }
  consumer_sync();  // y1 complete; every x stage consumed

  constexpr int MB = K::M2 / 64;
  float acc[MB][N / 8][4];
  uint32_t a[kKC / 16][MB][4];

  // ---- phase 2: y2 = relu(conv3x3(y1) + b2), nine shifted products ---------
  {
    uint32_t base[MB];  // address of this lane's tap-(0, 0) halo row
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int row = mb * 64 + m_w + a_r;
      base[mb] = smem_u32(y1s) +
                 ((row / K::TW) * K::HALO_W + row % K::TW) * K::YS * 2 + a_k;
    }
    for (int nt = 0; nt < K::P / K::NB; ++nt) {
      const int ntr = (nt + rot) % (K::P / K::NB);
      zero(acc);
      for (int q = 0; q < K::KCH2; ++q) {
        const int qr = (q + rot) % K::KCH2;     // tap-major K chunk
        const int tap = qr / (K::P / kKC);
        const int shift = (tap / 3) * K::HALO_W + tap % 3;
        const uint32_t a_off = (shift * K::YS + qr % (K::P / kKC) * kKC) * 2;
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            ldsm_x4(a[kk][mb], base[mb] + a_off + kk * 32);
        const uint64_t b_desc = sw128_desc(w_wg + ring.slot * K::WSTAGE_BYTES);
        mbar_wait(full0 + 8 * ring.slot, ring.phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            wgmma_rs(acc[mb], a[kk][mb], b_desc + 2 * kk);
        wgmma_commit_wait();
        pin(acc);
        pin(a);
        release(ring, empty0, lane);
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mb * 64 + m_w + g + 8 * half;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int n = ntr * K::NB + wg * N + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(y2s + row * K::YS + n) =
                pack_bf16(fmaxf(acc[mb][j][2 * half] + __ldg(b2 + n), 0.f),
                          fmaxf(acc[mb][j][2 * half + 1] + __ldg(b2 + n + 1), 0.f));
          }
        }
    }
  }
  fence_proxy_async();  // phase 2's reads of y1 before TMA reuses it
  consumer_sync();      // y2 complete

  // ---- phase 3: out = relu(y2 . w3 + b3 + x) --------------------------------
  // The pass's residual box comes in by TMA, the epilogue overwrites it
  // with the output in place, and TMA stores it (clipping the image edge):
  // NB / 64 boxes of 64 channels, M2 rows of 128 bytes with the 128-byte
  // swizzle, in the y1 region.
  {
    unsigned char* rbox = reinterpret_cast<unsigned char*>(y1s);
    rbox += (1024 - (smem_u32(rbox) & 1023)) & 1023;
    const uint32_t rbuf = smem_u32(rbox);
    uint32_t a_base[MB];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
      a_base[mb] = smem_u32(y2s) + (mb * 64 + m_w + a_r) * K::YS * 2 + a_k;
    for (int nt = 0; nt < K::C / K::NB; ++nt) {
      const int ntr = (nt + rot) % (K::C / K::NB);
      if (threadIdx.x == 0) {
        tma_store_wait<true>();  // the last pass's store has read the box
        mbar_arrive_expect_tx(rbar, K::RBUF_BYTES);
        for (int b = 0; b < K::NB / kKC; ++b)
          tma_load_4d(rbuf + b * K::M2 * kRow, &rmap, ntr * K::NB + b * kKC,
                      ox0, oy0, img, rbar);
      }
      zero(acc);
      for (int kc = 0; kc < K::KCH3; ++kc) {
        const uint32_t a_off = (kc + rot) % K::KCH3 * kKC * 2;
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            ldsm_x4(a[kk][mb], a_base[mb] + a_off + kk * 32);
        const uint64_t b_desc = sw128_desc(w_wg + ring.slot * K::WSTAGE_BYTES);
        mbar_wait(full0 + 8 * ring.slot, ring.phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            wgmma_rs(acc[mb], a[kk][mb], b_desc + 2 * kk);
        wgmma_commit_wait();
        pin(acc);
        pin(a);
        release(ring, empty0, lane);
      }
      mbar_wait(rbar, nt & 1);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mb * 64 + m_w + g + 8 * half;  // row & 7 == g
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int nl = wg * N + 8 * j;               // the pass's column
            const int n = ntr * K::NB + nl + 2 * t;
            unsigned char* at = rbox + (nl >> 6) * K::M2 * kRow + row * kRow +
                                ((((nl & 63) >> 3) ^ g) << 4) + 4 * t;
            const __nv_bfloat162 res = *reinterpret_cast<__nv_bfloat162*>(at);
            const float v0 = acc[mb][j][2 * half] + __ldg(b3 + n) + __low2float(res);
            const float v1 =
                acc[mb][j][2 * half + 1] + __ldg(b3 + n + 1) + __high2float(res);
            *reinterpret_cast<uint32_t*>(at) =
                pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
      fence_proxy_async();  // the epilogue's reads and writes before TMA's
      consumer_sync();
      if (threadIdx.x == 0)
        for (int b = 0; b < K::NB / kKC; ++b)
          tma_store_4d(&omap, rbuf + b * K::M2 * kRow, ntr * K::NB + b * kKC,
                       ox0, oy0, img);
    }
    if (threadIdx.x == 0) tma_store_wait<false>();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &status);
#endif
    return status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <class K>
int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
           const float* b2, const bf16* w3, const float* b3, bf16* out,
           int batch, int h, int w, int th, int tw, int smem,
           cudaStream_t stream) {
  if (th != K::TH || tw != K::TW || smem != K::SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + tw - 1) / tw;
  const int tiles_y = (h + th - 1) / th;
  const unsigned blocks = static_cast<unsigned>(batch) * tiles_x * tiles_y;
  // x and out as 4-D tensors (C, W, H, batch), innermost first: x's box is
  // one 64-channel chunk of a (TH + 2) x (TW + 2) halo tile, the residual's
  // and the output's one of a TH x TW tile
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto make_map = [&](CUtensorMap* map, const bf16* base, int box_w,
                      int box_h) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(K::C),
                                static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                   dims[0] * dims[1] * dims[2] * 2};
    const cuuint32_t box[4] = {kKC, static_cast<cuuint32_t>(box_w),
                               static_cast<cuuint32_t>(box_h), 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<bf16*>(base), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  CUtensorMap xmap, rmap, omap;
  if (!make_map(&xmap, x, K::TW + 2, K::TH + 2) ||
      !make_map(&rmap, x, K::TW, K::TH) || !make_map(&omap, out, K::TW, K::TH))
    return static_cast<int>(cudaErrorInvalidValue);
  fused_bottleneck_kernel<K><<<blocks, kThreads, smem, stream>>>(
      w1, b1, w2, b2, w3, b3, xmap, rmap, omap, h, w, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (batch, h, w, 4p) bf16 NHWC, 16-byte aligned; w1 (p, 4p), w2
// (p, 9p), w3 (4p, p) bf16 in the ring's order (`pack_weight` in
// ops/fused_bottleneck.py), 16-byte aligned; b1, b2 (p,), b3 (4p,) fp32.
// p in {64, 128, 256, 512}; (th, tw) and `smem` as `tile_shape` and
// `smem_bytes` give them, checked against the kernel's own.
extern "C" int fused_bottleneck_launch(const bf16* x, const bf16* w1,
                                       const float* b1, const bf16* w2,
                                       const float* b2, const bf16* w3,
                                       const float* b3, bf16* out, int batch,
                                       int h, int w, int p, int th, int tw,
                                       int smem, cudaStream_t stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  switch (p) {
    case 64:
      return launch<Cfg<64, 8, 16, 2>>(x, w1, b1, w2, b2, w3, b3, out, batch, h,
                                    w, th, tw, smem, stream);
    case 128:
      return launch<Cfg<128, 8, 8, 2>>(x, w1, b1, w2, b2, w3, b3, out, batch, h,
                                     w, th, tw, smem, stream);
    case 256:
      return launch<Cfg<256, 8, 8, 4>>(x, w1, b1, w2, b2, w3, b3, out, batch, h,
                                     w, th, tw, smem, stream);
    case 512:
      return launch<Cfg<512, 8, 8, 3>>(x, w1, b1, w2, b2, w3, b3, out, batch, h,
                                    w, th, tw, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
