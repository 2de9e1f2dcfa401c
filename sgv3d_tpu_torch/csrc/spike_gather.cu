// In-kernel row gather probe: three ways to gather context rows by pixel id.
//
// Replaces the TPU probe tools/spike_pallas_gather.py (`run` over
// `_kernel_take`, `_kernel_taa`, `_kernel_onehot`), which asked whether a
// Pallas kernel can gather rows of a VMEM-resident context by index:
//   out[m, :] = ctx[idx[m], :]       ctx (HW, C) bf16, idx (M,) int32
// at the probe's shape ctx (5184, 128), idx (40, 2048) -> (40, 2048, 128).
// An index outside [0, HW) gives a zero row in all three formulations (the
// one-hot product's answer), and no kernel reads outside ctx. The take and
// the take-along copy ctx's bits; the one-hot product's function differs in
// signed zeros and non-finite values (see its note and `onehot_plain` in
// tools/spike_gather.py).
//
// What bounds it on an H100: the function moves 21 MB of output and reads
// a 1.3 MB context that stays in L2, so its bound is the output's bytes
// (6.8 us at 3.35 TB/s). What holds each kernel back, and its design
// (times: chip_smoke.py and PERF.md, graph-timed on an H100 at 700 W; the
// choices below from graph-timed variants of this file on the same card):
//
//   take        a row is 256 bytes behind the dependent load of its index.
//               A warp loads its 32 indices in one coalesced load and hands
//               them out by shuffle; each half-warp copies one row as 16 x
//               16-byte vectors (all 32 lanes busy at C = 128), with
//               kTakeRows rows' loads in flight before their stores, which
//               stream (st.global.cs) past L1. A grid-stride grid of at most
//               kTakeBlocksPerSm blocks an SM. (Staging a block's rows by
//               cp.async and writing them by one cp.async.bulk store timed
//               the same; the streaming stores are simpler.)
//   take_along  the probe's broadcast take-along-axis: every thread loads
//               its own index, with no shuffle. A thread owns one 16-byte
//               vector of 8 elements (the 16 threads of a row read the same
//               index address in one transaction) and keeps kTaaVecs
//               vectors in flight, grid-stride.
//   onehot      the TPU's matrix-unit formulation, one_hot(idx) @ ctx, still
//               a product on the tensor cores. Dense, it is 81920 x 5184 x
//               128 multiply-adds (0.11 ms at the bf16 peak), and a block of
//               256 rows has to receive all of ctx (1.3 MB) from L2: at the
//               probe's shape a block walks 2 or 3 such groups of rows, and
//               receiving alone takes ~0.035 ms. So:
//               - a block owns 256 output rows (kOhWarpgroups consumer
//                 warpgroups of kOhTiles m64 tiles, all 128 columns in fp32
//                 accumulators) and walks row groups persistently, a cluster
//                 of kOhCluster blocks a group, as many clusters as fit;
//               - one producer warp streams ctx in kOhKT-row K tiles through
//                 a kOhStages-stage ring, by TMA in the 128-byte swizzle
//                 (two 64-column boxes a stage), each block of the cluster
//                 loading 1 / kOhCluster of the rows and multicasting them
//                 to every block, so ctx is read from L2 once a cluster; a
//                 stage is full on its mbarrier, and is refilled only when
//                 every consumer warp of the cluster has released it (an
//                 arrival on each block's empty mbarrier);
//               - the consumers issue wgmma m64n128k16 with A from registers
//                 (one-hot fragments made by comparison, never stored, in
//                 mma.m16n8k16's A layout) and B, which is ctx (K = HW,
//                 N = C) and so MN-major, by descriptor with the transpose
//                 immediate; fp32 accumulators zeroed explicitly;
//               - a warpgroup first sets, for each of its m64 tiles, one bit
//                 in shared memory for each k16 slab that one of its rows
//                 indexes, and issues a slab's wgmma only where the bit is
//                 set: a skipped slab's A tile is all zeros, so the product
//                 stays exact (at uniform indices 18% of slabs are issued).
//               What holds it back: a warpgroup waits out each stage's
//               products before it releases the stage (most of its cycles,
//               by clock64 stamps) and each SM receives all of ctx for
//               every 256 rows it owns (the ring alone, with no products,
//               takes most of the kernel's time). Four warpgroups of one
//               tile each (not two of two) overlap four chains of products,
//               256-row K tiles halve the per-stage handoffs of 128-row
//               ones, the releases are CTA-scoped (cluster scope was
//               slower), and the slab bits are read through a shuffle from
//               lane 0 so that ptxas sees the branch around the wgmma as
//               warp-uniform and does not serialize the products (C7520).
//               Each output is an fp32 sum from +0.0 of one product
//               1.0 x ctx[id, n] and of products 0 x ctx[k, n], so for
//               finite ctx the result is ctx's bits whatever the cluster
//               size, ring depth or order, except that a -0.0 comes out as
//               +0.0; a non-finite ctx[k, n] makes NaN (0 x inf) at column
//               n of the other rows of every m64 tile that issues k's slab,
//               out-of-range rows included.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked
                   // up at run time, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---- take --------------------------------------------------------------------

constexpr int kTakeWarps = 8;        // a block
constexpr int kTakeRows = 4;         // rows in flight a half-warp
constexpr int kTakeBlocksPerSm = 4;  // grid-stride grid

__global__ void __launch_bounds__(kTakeWarps * 32)
take_kernel(const bf16* __restrict__ ctx, const int* __restrict__ idx,
            bf16* __restrict__ out, int m, int hw, int c) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int h = lane & 15;
  const int vecs = c / 8;  // 16-byte vectors of 8 bf16 a row
  const uint4* src = reinterpret_cast<const uint4*>(ctx);
  uint4* dst = reinterpret_cast<uint4*>(out);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTakeWarps * 32;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kTakeWarps +
                       (threadIdx.x >> 5)) * 32;
       base < m; base += step) {
    // the warp's 32 rows: one coalesced load of their indices
    int mine = base + lane < m ? __ldg(idx + base + lane) : -1;
    mine = mine >= 0 && mine < hw ? mine : -1;
    // half-warp `half` copies rows base + 16 * half + 0..15
#pragma unroll
    for (int r0 = 0; r0 < 16; r0 += kTakeRows) {
      int id[kTakeRows];
#pragma unroll
      for (int r = 0; r < kTakeRows; ++r)
        id[r] = __shfl_sync(0xffffffffu, mine, 16 * half + r0 + r);
      for (int v = h; v < vecs; v += 16) {  // one pass at C = 128
        uint4 val[kTakeRows];
#pragma unroll
        for (int r = 0; r < kTakeRows; ++r)
          val[r] = id[r] >= 0 ? __ldg(src + static_cast<int64_t>(id[r]) * vecs + v)
                              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < kTakeRows; ++r) {
          const int64_t row = base + 16 * half + r0 + r;
          if (row < m) __stcs(dst + row * vecs + v, val[r]);
        }
      }
    }
  }
}

// ---- take_along ----------------------------------------------------------------

constexpr int kTaaThreads = 256;
constexpr int kTaaVecs = 4;         // vectors in flight a thread
constexpr int kTaaBlocksPerSm = 8;

// n = m * c / 8 < 2^31 (checked by the launcher)
__global__ void __launch_bounds__(kTaaThreads)
take_along_kernel(const bf16* __restrict__ ctx, const int* __restrict__ idx,
                  bf16* __restrict__ out, int n, int hw, int c) {
  const uint32_t vecs = c / 8;
  const uint4* src = reinterpret_cast<const uint4*>(ctx);
  uint4* dst = reinterpret_cast<uint4*>(out);
  const uint32_t step = gridDim.x * kTaaThreads;
  for (uint32_t e0 = blockIdx.x * kTaaThreads + threadIdx.x; e0 < n;
       e0 += step * kTaaVecs) {
    int id[kTaaVecs];
#pragma unroll
    for (int i = 0; i < kTaaVecs; ++i) {
      const uint32_t e = e0 + i * step;
      id[i] = e < n ? __ldg(idx + e / vecs) : -1;  // this thread's own index
    }
    uint4 val[kTaaVecs];
#pragma unroll
    for (int i = 0; i < kTaaVecs; ++i) {
      const uint32_t e = e0 + i * step;
      val[i] = id[i] >= 0 && id[i] < hw
                   ? __ldg(src + static_cast<int64_t>(id[i]) * vecs + e % vecs)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kTaaVecs; ++i) {
      const uint32_t e = e0 + i * step;
      if (e < n) __stcs(dst + e, val[i]);
    }
  }
}

// ---- onehot: PTX wrappers ------------------------------------------------------

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

// Arrive on the mbarrier at this block's shared address `bar` in the
// cluster's block `rank` (this block included), with the default release
// at CTA scope: the stage's readers (wgmma) have completed before it, and
// the refill (TMA) is ordered after the barrier's phase.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster, with release / acquire of shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The 128 threads of consumer warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Commit the warpgroup's products and wait for them all.
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ---- onehot ----------------------------------------------------------------------

constexpr int kOhC = 128;                 // columns: wgmma's N
constexpr int kOhKT = 256;                // ctx rows a ring stage
constexpr int kOhStages = 2;              // ring depth
constexpr int kOhCluster = 2;             // blocks sharing each ctx stage
constexpr int kOhWarpgroups = 4;          // consumer warpgroups a block
constexpr int kOhTiles = 1;               // m64 tiles a warpgroup
constexpr int kOhRows = 64 * kOhTiles * kOhWarpgroups;  // 256 rows a block
constexpr int kOhWarps = 4 * kOhWarpgroups;             // consumer warps
constexpr int kOhThreads = (kOhWarps + 1) * 32;         // + one producer warp
constexpr int kOhSlabs = kOhKT / 16;                    // k16 slabs a stage
constexpr int kOhMaxHw = 65536;
constexpr int kOhMaskWords = kOhMaxHw / 16 / 32;        // slab bits an m64 tile
constexpr int kOhHalfBytes = kOhKT * 128;               // a 64-column box
constexpr int kOhStageBytes = 2 * kOhHalfBytes;
constexpr int kOhSlice = kOhKT / kOhCluster;            // rows a block loads
constexpr int kOhOutStride = kOhC * 2 + 16;             // padded staging row
constexpr int kOhOutBytes = kOhWarps * 16 * kOhOutStride;
constexpr int kOhMaskBytes = kOhWarpgroups * kOhTiles * kOhMaskWords * 4;
// + 1024 bytes to align the ring for the 128-byte swizzle
constexpr int kOhSmem = 1024 + kOhStages * kOhStageBytes + kOhOutBytes +
                        kOhMaskBytes + 2 * kOhStages * 8;
static_assert(kOhSlice % 8 == 0, "a slice starts on a 1024-byte swizzle atom");
static_assert(32 % kOhSlabs == 0, "a stage's slab bits lie in one mask word");
static_assert(kOhSmem <= 232448, "shared memory");

// A lane's share of the one-hot A fragment of a row whose index is `id`
// (-1 outside [0, hw)): in mma.m16n8k16's A layout the lane holds columns
// (2t, 2t + 1) and (2t + 8, 2t + 9) of each k16 slab, so the row's one 1.0
// lies in the lane's low pair (lo) or high pair (hi) of slab id >> 4 or in
// neither; each pair is two bf16, packed low / high.
struct OneHotRow {
  int slab;
  uint32_t lo, hi;
  OneHotRow() = default;
  __device__ __forceinline__ OneHotRow(int id, int t) {
    constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0
    const uint32_t one = id & 1 ? kOne << 16 : kOne;
    const int pair = (id & 15) >> 1;
    slab = id >= 0 ? id >> 4 : -1;  // a negative index is in no slab
    lo = pair == t ? one : 0u;
    hi = pair == t + 4 ? one : 0u;
  }
};

// Descriptor of an MN-major B operand stored as 128-byte rows (64 columns)
// with the 128-byte swizzle: 8-row atoms 1024 bytes apart (SBO), the second
// 64-column box kOhHalfBytes on (LBO); a k16 step adds 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(kOhHalfBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// m64n128k16, bf16 in, fp32 accumulators (scale-d 1), A from registers,
// B MN-major (transpose immediate 1).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b_desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// Keep the compiler from touching accumulators that an in-flight wgmma
// writes before this point.
__device__ __forceinline__ void pin(float (&acc)[kOhTiles][16][4]) {
#pragma unroll
  for (int i = 0; i < kOhTiles; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][j][e])::"memory");
}

// TMA load of the box at (c0, c1) of `map` into this block's shared memory
// at `dst` and, multicast, into every block of the cluster at the same
// offset, completing on each block's mbarrier at `bar`; rows past the
// tensor are 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                           int c0, int c1, uint32_t bar) {
  if constexpr (kOhCluster == 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], "
        "%5;\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
        "h"(static_cast<uint16_t>((1u << kOhCluster) - 1))
        : "memory");
  }
}

// The ring's position, advanced the same way by the producer and consumers.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++slot == kOhStages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Cluster c walks the row groups c, c + clusters, ...; a group is
// kOhCluster * 256 rows, block `rank` of the cluster owning its rank's 256.
// Every cluster walks the K tiles of a group from its own offset `rot`, so
// that the clusters read different ctx tiles from L2 at a time.
__global__ void __launch_bounds__(kOhThreads, 1)
onehot_kernel(const __grid_constant__ CUtensorMap cmap,
              const int* __restrict__ idx, bf16* __restrict__ out, int m,
              int hw, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* staging = ring + kOhStages * kOhStageBytes;
  uint32_t* masks = reinterpret_cast<uint32_t*>(staging + kOhOutBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(masks) + kOhMaskBytes);
  const uint32_t full0 = smem_u32(bars);               // full[s] = full0 + 8s
  const uint32_t empty0 = smem_u32(bars + kOhStages);  // empty[s]

  const uint32_t rank = cluster_rank();
  const int cid = static_cast<int>(cluster_id());
  const int clusters = static_cast<int>(cluster_count());
  const int ktiles = (hw + kOhKT - 1) / kOhKT;
  const int rot = static_cast<int>(static_cast<int64_t>(cid) * ktiles / clusters);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kOhStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kOhWarps * kOhCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every barrier of the cluster is initialised

  if (warp == kOhWarps) {
    // ---- producer: this block's slice of every stage, multicast ----------
    if (lane == 0) {
      Ring r;
      const uint32_t slice = rank * kOhSlice * 128;
      for (int group = cid; group < groups; group += clusters)
        for (int kt = 0; kt < ktiles; ++kt) {
          const int kr = kt + rot < ktiles ? kt + rot : kt + rot - ktiles;
          // every consumer warp of the cluster has released the stage
          mbar_wait(empty0 + 8 * r.slot, r.phase ^ 1);
          const uint32_t full = full0 + 8 * r.slot;
          mbar_arrive_expect_tx(full, kOhStageBytes);
          const uint32_t dst = smem_u32(ring + r.slot * kOhStageBytes) + slice;
          const int row = kr * kOhKT + static_cast<int>(rank) * kOhSlice;
          tma_load_2d(dst, &cmap, 0, row, full);
          tma_load_2d(dst + kOhHalfBytes, &cmap, 64, row, full);
          r.advance();
        }
    }
    __syncwarp();
  } else {
    // ---- consumers: warpgroup wg owns rows wg * 64 * kOhTiles + [0, 64 *
    // kOhTiles) of the block's 256
    const int wg = warp >> 2;
    const int wq = warp & 3;  // warp in its warpgroup: rows 16 wq of a tile
    const int g = lane >> 2;
    const int t = lane & 3;
    const int words = ((hw + 15) / 16 + 31) / 32;
    uint32_t* mask = masks + wg * kOhTiles * kOhMaskWords;  // [tile][word]
    unsigned char* stage_rows = staging + warp * 16 * kOhOutStride;
    float acc[kOhTiles][16][4];
    Ring r;
    for (int group = cid; group < groups; group += clusters) {
      const int64_t row0 = (static_cast<int64_t>(group) * kOhCluster + rank) *
                               kOhRows + wg * 64 * kOhTiles;
      // this lane's rows g and g + 8 of each tile; -1 outside [0, hw)
      int id[kOhTiles][2];
#pragma unroll
      for (int mt = 0; mt < kOhTiles; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int64_t row = row0 + mt * 64 + wq * 16 + g + 8 * hh;
          const int v = row < m ? __ldg(idx + row) : -1;
          id[mt][hh] = v >= 0 && v < hw ? v : -1;
        }
      // the slab bits of this warpgroup's tiles (the last group's reads of
      // them are done once every thread has passed the first barrier)
      warpgroup_sync(wg);
      for (int w = threadIdx.x & 127; w < kOhTiles * words; w += 128)
        mask[w / words * kOhMaskWords + w % words] = 0u;
      warpgroup_sync(wg);
      if (t == 0)
#pragma unroll
        for (int mt = 0; mt < kOhTiles; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (id[mt][hh] >= 0)  // a negative index sets no bit
              atomicOr(mask + mt * kOhMaskWords + (id[mt][hh] >> 9),
                       1u << ((id[mt][hh] >> 4) & 31));
      warpgroup_sync(wg);
      OneHotRow rows[kOhTiles][2];
#pragma unroll
      for (int mt = 0; mt < kOhTiles; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) rows[mt][hh] = OneHotRow(id[mt][hh], t);

#pragma unroll
      for (int mt = 0; mt < kOhTiles; ++mt)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

      for (int kt = 0; kt < ktiles; ++kt) {
        const int kr = kt + rot < ktiles ? kt + rot : kt + rot - ktiles;
        const int slab0 = kr * kOhSlabs;
        // the same in every thread of the warpgroup; taken from lane 0 so
        // that ptxas sees the branch around the wgmma as warp-uniform and
        // does not serialize the products (its advisory C7520)
        uint32_t bits[kOhTiles];
        uint32_t any = 0u;
#pragma unroll
        for (int mt = 0; mt < kOhTiles; ++mt) {
          bits[mt] = __shfl_sync(
              0xffffffffu,
              (mask[mt * kOhMaskWords + (slab0 >> 5)] >> (slab0 & 31)) &
                  ((1u << kOhSlabs) - 1),
              0);
          any |= bits[mt];
        }
        mbar_wait(full0 + 8 * r.slot, r.phase);
        if (any) {
          // the A fragments of the stage, all made before the first wgmma
          uint32_t a[kOhSlabs][kOhTiles][4];
#pragma unroll
          for (int q = 0; q < kOhSlabs; ++q)
#pragma unroll
            for (int mt = 0; mt < kOhTiles; ++mt) {
              const bool r0 = rows[mt][0].slab == slab0 + q;
              const bool r1 = rows[mt][1].slab == slab0 + q;
              a[q][mt][0] = r0 ? rows[mt][0].lo : 0u;
              a[q][mt][1] = r1 ? rows[mt][1].lo : 0u;
              a[q][mt][2] = r0 ? rows[mt][0].hi : 0u;
              a[q][mt][3] = r1 ? rows[mt][1].hi : 0u;
            }
          const uint64_t desc = mn_desc(smem_u32(ring + r.slot * kOhStageBytes));
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < kOhSlabs; ++q)
#pragma unroll
            for (int mt = 0; mt < kOhTiles; ++mt)
              if ((bits[mt] >> q) & 1u)
                wgmma_rs_tb(acc[mt], a[q][mt], desc + q * (16 * 128 >> 4));
          wgmma_commit_wait();
          pin(acc);
        }
        // release the stage in every block of the cluster: lane i arrives
        // on block i's empty barrier
        __syncwarp();
        if (lane < kOhCluster) mbar_arrive_cluster(empty0 + 8 * r.slot, lane);
        r.advance();
      }

      // epilogue: each warp stages its 16 rows of a tile as bf16 in shared
      // memory, then writes them as whole 256-byte rows, 16 bytes a lane
#pragma unroll
      for (int mt = 0; mt < kOhTiles; ++mt) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][j][2 * hh],
                                                           acc[mt][j][2 * hh + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                stage_rows + (g + 8 * hh) * kOhOutStride + (8 * j + 2 * t) * 2) = v;
          }
        __syncwarp();
        const int64_t first = row0 + mt * 64 + wq * 16;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int rl = 2 * i + (lane >> 4);
          const int v = lane & 15;
          if (first + rl < m)
            __stcs(reinterpret_cast<uint4*>(out + (first + rl) * kOhC) + v,
                   *reinterpret_cast<const uint4*>(stage_rows + rl * kOhOutStride +
                                                   16 * v));
        }
        __syncwarp();
      }
    }
  }
  // no block leaves while a peer may still multicast into its shared
  // memory or arrive on its barriers
  cluster_sync();
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

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

// ctx (hw, c) bf16, 16-byte aligned; idx (m,) int32; out (m, c) bf16.
// take and take_along need c % 8 == 0; onehot needs c == 128 and
// hw <= 65536. Arguments a kernel refuses return -1.
extern "C" int spike_take_launch(const bf16* ctx, const int* idx, bf16* out,
                                 int m, int hw, int c, cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (m < 0 || c <= 0 || c % 8 != 0 || hw <= 0) return -1;
  const int64_t need = (static_cast<int64_t>(m) + kTakeWarps * 32 - 1) /
                       (kTakeWarps * 32);
  const int64_t cap = static_cast<int64_t>(sm_count()) * kTakeBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  take_kernel<<<blocks, kTakeWarps * 32, 0, stream>>>(ctx, idx, out, m, hw, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spike_take_along_launch(const bf16* ctx, const int* idx,
                                       bf16* out, int m, int hw, int c,
                                       cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const int64_t n = static_cast<int64_t>(m) * (c / 8);
  if (m < 0 || c <= 0 || c % 8 != 0 || hw <= 0 || n >= (1ll << 31)) return -1;
  const int64_t need = (n + kTaaThreads * kTaaVecs - 1) / (kTaaThreads * kTaaVecs);
  const int64_t cap = static_cast<int64_t>(sm_count()) * kTaaBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  take_along_kernel<<<blocks, kTaaThreads, 0, stream>>>(
      ctx, idx, out, static_cast<int>(n), hw, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spike_onehot_launch(const bf16* ctx, const int* idx, bf16* out,
                                   int m, int hw, int c, cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (m < 0 || c != kOhC || hw <= 0 || hw > kOhMaxHw) return -1;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // ctx as a 2-D tensor (c, hw), innermost first; a box is 64 columns of
  // one block's slice of a stage's rows
  CUtensorMap cmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kOhC),
                              static_cast<cuuint64_t>(hw)};
  const cuuint64_t strides[1] = {kOhC * 2};
  const cuuint32_t box[2] = {64, kOhSlice};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ctx),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOhSmem);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kOhCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kOhThreads);
  cfg.dynamicSmemBytes = kOhSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a persistent grid: as many clusters as can be resident at once
  static int resident = 0;
  if (resident == 0) {
    cfg.gridDim = dim3(kOhCluster);
    if (cudaOccupancyMaxActiveClusters(&resident, onehot_kernel, &cfg) !=
            cudaSuccess ||
        resident <= 0) {
      cudaGetLastError();  // clear the query's error; size by the SMs
      resident = sm_count() / kOhCluster;
    }
  }
  const int groups = static_cast<int>(
      (static_cast<int64_t>(m) + kOhRows * kOhCluster - 1) / (kOhRows * kOhCluster));
  cfg.gridDim = dim3((groups < resident ? groups : resident) * kOhCluster);
  err = cudaLaunchKernelEx(&cfg, onehot_kernel, cmap, idx, out, m, hw, groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
