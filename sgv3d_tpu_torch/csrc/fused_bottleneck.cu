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
// What bounds it on an H100: the three products are ~C*P + 9*P*P + P*C
// multiply-adds a pixel (69.6K at P = 64 up to 4.5M at P = 512), done here
// with mma.sync on bf16 tensor cores; the weights (up to 8.7 MB a block at
// P = 512) stay in L2 and are read by every thread block, so at the deep
// stages the kernel is bound by L2 bandwidth for the weight fragments; at
// the first stage by the activations' traffic. Unfused, each block moves
// the activation through device memory about five times; fused, x is read
// once (its halo rows twice) and the output written once.
//
// Design: a thread block owns a TH x TW output tile of one image (8x16 at
// P <= 64, else 8x8) and runs three phases with shared memory between them:
//   1. y1 on the (TH+2) x (TW+2) halo tile: x is staged into shared memory
//      64 input channels at a time (16-byte loads, zero outside the image),
//      each warp takes 32x32 output jobs, and the epilogue writes
//      relu(acc + b1) as bf16, or exactly 0 for a halo pixel outside the
//      image: the padding predicate replaces the TPU kernel's H-padded
//      layout and its edge-row masking;
//   2. y2 as nine shifted products: the A rows of tap (dy, dx) are the halo
//      pixels at the output pixel's offset, so the shift is pointer
//      arithmetic and the W border needs no zero columns;
//   3. out = relu(y2 . w3 + b3 + x), the residual read from device memory
//      in the epilogue, stored bf16; rows outside the image are not stored.
// Activations are NHWC bf16 (a channels_last NCHW tensor already is), so
// no transpose and no padded copy. Weights are output-channel major with
// the input channels contiguous, so a B fragment of m16n8k16 is two 32-bit
// loads. Every output is written once by one thread, with no atomics: the
// result is bitwise the same on every run. Shared rows are padded by 8
// elements, so the fragment loads of 8 rows hit 32 distinct banks.
// wgmma, TMA and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;            // 16-row tiles of a warp job
constexpr int kNT = 4;            // 8-column tiles of a warp job
constexpr int kJobM = 16 * kMT;   // 32 rows
constexpr int kJobN = 8 * kNT;    // 32 columns
constexpr int kChunk = 64;        // input channels of x staged at a time
constexpr int kPad = 8;           // bf16 elements of padding a shared row
constexpr int kXStride = kChunk + kPad;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_shared32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_global32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// One k16 step of a warp's 32x32 job: A rows from shared memory (rows g and
// g + 8 of each 16-row tile, as pointers), B rows (output channels
// n0 + 8j + g) from device memory. Fragment layout of m16n8k16: lane
// (g = lane / 4, t = lane % 4) holds A[g|g+8][2t, 2t+1 | 2t+8, 2t+9] and
// B[2t, 2t+1 | 2t+8, 2t+9][g].
__device__ __forceinline__ void mma_step(float (&acc)[kMT][kNT][4],
                                         const bf16* const (&arow)[kMT][2],
                                         int ak, const bf16* const (&brow)[kNT],
                                         int bk, int t) {
  uint32_t a[kMT][4];
  uint32_t b[kNT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    a[i][0] = ld_shared32(arow[i][0] + ak + 2 * t);
    a[i][1] = ld_shared32(arow[i][1] + ak + 2 * t);
    a[i][2] = ld_shared32(arow[i][0] + ak + 2 * t + 8);
    a[i][3] = ld_shared32(arow[i][1] + ak + 2 * t + 8);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    b[j][0] = ld_global32(brow[j] + bk + 2 * t);
    b[j][1] = ld_global32(brow[j] + bk + 2 * t + 8);
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
}

__device__ __forceinline__ void zero(float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const float* __restrict__ b2,
                        const bf16* __restrict__ w3,
                        const float* __restrict__ b3, bf16* __restrict__ out,
                        int h, int w, int p, int th, int tw, int tiles_x,
                        int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = 4 * p;
  const int halo_w = tw + 2;
  const int halo = (th + 2) * halo_w;
  const int halo_rows = (halo + kJobM - 1) / kJobM * kJobM;
  const int m2 = th * tw;                 // a multiple of kJobM
  const int ys = p + kPad;                // row stride of y1 and y2
  bf16* y1s = reinterpret_cast<bf16*>(smem);
  bf16* buf = y1s + halo_rows * ys;       // x chunk in phase 1, y2 after

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int oy0 = ty * th;
  const int ox0 = tx * tw;
  const bf16* ximg = x + static_cast<size_t>(img) * h * w * c;
  bf16* oimg = out + static_cast<size_t>(img) * h * w * c;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[kMT][kNT][4];

  // ---- phase 1: y1 on the halo tile -------------------------------------
  {
    const int jobs_n = p / kJobN;
    const int jobs = halo_rows / kJobM * jobs_n;
    const int rounds = (jobs + kWarps - 1) / kWarps;
    for (int r = 0; r < rounds; ++r) {
      const int job = r * kWarps + warp;
      const bool active = job < jobs;
      const int m0 = active ? job / jobs_n * kJobM : 0;
      const int n0 = active ? job % jobs_n * kJobN : 0;
      const bf16* arow[kMT][2];
      const bf16* brow[kNT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        arow[i][0] = buf + (m0 + 16 * i + g) * kXStride;
        arow[i][1] = arow[i][0] + 8 * kXStride;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        brow[j] = w1 + static_cast<size_t>(n0 + 8 * j + g) * c;
      zero(acc);
      for (int k0 = 0; k0 < c; k0 += kChunk) {
        __syncthreads();  // every warp is done with the previous chunk
        constexpr int kVecs = kChunk / 8;  // 16-byte vectors a row
        for (int v = threadIdx.x; v < halo_rows * kVecs; v += kThreads) {
          const int row = v / kVecs;
          const int part = v - row * kVecs;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (row < halo) {
            const int iy = oy0 - 1 + row / halo_w;
            const int ix = ox0 - 1 + row % halo_w;
            if (iy >= 0 && iy < h && ix >= 0 && ix < w)
              val = __ldg(reinterpret_cast<const uint4*>(
                            ximg + (static_cast<size_t>(iy) * w + ix) * c + k0) +
                        part);
          }
          reinterpret_cast<uint4*>(buf + row * kXStride)[part] = val;
        }
        __syncthreads();
        if (active) {
#pragma unroll
          for (int kk = 0; kk < kChunk; kk += 16)
            mma_step(acc, arow, kk, brow, k0 + kk, t);
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + 16 * i + g + 8 * half;
            bool inside = false;
            if (row < halo) {
              const int iy = oy0 - 1 + row / halo_w;
              const int ix = ox0 - 1 + row % halo_w;
              inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
            }
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              const int n = n0 + 8 * j + 2 * t;
              const float v0 = inside ? fmaxf(acc[i][j][2 * half] + b1[n], 0.f) : 0.f;
              const float v1 =
                  inside ? fmaxf(acc[i][j][2 * half + 1] + b1[n + 1], 0.f) : 0.f;
              *reinterpret_cast<uint32_t*>(y1s + row * ys + n) = pack_bf16(v0, v1);
            }
          }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: y2 = relu(conv3x3(y1) + b2), nine shifted products -------
  {
    const int jobs_n = p / kJobN;
    const int jobs = m2 / kJobM * jobs_n;
    for (int job = warp; job < jobs; job += kWarps) {
      const int m0 = job / jobs_n * kJobM;
      const int n0 = job % jobs_n * kJobN;
      int base[kMT][2];  // halo index of the tap (0, 0) of each lane's rows
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + 16 * i + g + 8 * half;
          base[i][half] = row / tw * halo_w + row % tw;
        }
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = tap / 3 * halo_w + tap % 3;
        const bf16* arow[kMT][2];
        const bf16* brow[kNT];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          arow[i][0] = y1s + (base[i][0] + shift) * ys;
          arow[i][1] = y1s + (base[i][1] + shift) * ys;
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          brow[j] = w2 + static_cast<size_t>(n0 + 8 * j + g) * 9 * p + tap * p;
        for (int k0 = 0; k0 < p; k0 += 16) mma_step(acc, arow, k0, brow, k0, t);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + 16 * i + g + 8 * half;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int n = n0 + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(buf + row * ys + n) =
                pack_bf16(fmaxf(acc[i][j][2 * half] + b2[n], 0.f),
                          fmaxf(acc[i][j][2 * half + 1] + b2[n + 1], 0.f));
          }
        }
    }
  }
  __syncthreads();

  // ---- phase 3: out = relu(y2 . w3 + b3 + x) -----------------------------
  {
    const int jobs_n = c / kJobN;
    const int jobs = m2 / kJobM * jobs_n;
    for (int job = warp; job < jobs; job += kWarps) {
      const int m0 = job / jobs_n * kJobM;
      const int n0 = job % jobs_n * kJobN;
      const bf16* arow[kMT][2];
      const bf16* brow[kNT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        arow[i][0] = buf + (m0 + 16 * i + g) * ys;
        arow[i][1] = arow[i][0] + 8 * ys;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        brow[j] = w3 + static_cast<size_t>(n0 + 8 * j + g) * p;
      zero(acc);
      for (int k0 = 0; k0 < p; k0 += 16) mma_step(acc, arow, k0, brow, k0, t);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + 16 * i + g + 8 * half;
          const int oy = oy0 + row / tw;
          const int ox = ox0 + row % tw;
          if (oy >= h || ox >= w) continue;
          const size_t pix = (static_cast<size_t>(oy) * w + ox) * c;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int n = n0 + 8 * j + 2 * t;
            const uint32_t rv = ld_global32(ximg + pix + n);
            const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(&rv);
            const float v0 = acc[i][j][2 * half] + b3[n] + __low2float(res);
            const float v1 = acc[i][j][2 * half + 1] + b3[n + 1] + __high2float(res);
            *reinterpret_cast<uint32_t*>(oimg + pix + n) =
                pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
    }
  }
}

}  // namespace

// x, out: (batch, h, w, 4p) bf16 NHWC, 16-byte aligned; w1 (p, 4p), w2
// (p, 9p) taps (dy, dx) row-major then input channel, w3 (4p, p), bf16;
// b1, b2 (p,), b3 (4p,) fp32. p % 32 == 0, th * tw % 32 == 0, `smem` the
// bytes of shared memory the caller computed for (p, th, tw).
extern "C" int fused_bottleneck_launch(const bf16* x, const bf16* w1,
                                       const float* b1, const bf16* w2,
                                       const float* b2, const bf16* w3,
                                       const float* b3, bf16* out, int batch,
                                       int h, int w, int p, int th, int tw,
                                       int smem, cudaStream_t stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  if (p % kJobN != 0 || (th * tw) % kJobM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + tw - 1) / tw;
  const int tiles_y = (h + th - 1) / th;
  const unsigned blocks = static_cast<unsigned>(batch) * tiles_x * tiles_y;
  fused_bottleneck_kernel<<<blocks, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, w3, b3, out, h, w, p, th, tw, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}
