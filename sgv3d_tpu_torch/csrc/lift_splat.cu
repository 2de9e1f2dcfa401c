// Lift-splat BEV pooling forward: a deterministic key placement (the prep)
// and a segment sum over it (the pool).
//
// Replaces the TPU kernel sgv3d_tpu/ops/pallas_lift_splat.py
// (`pallas_sorted_segment_pool`, body `_kernel`, fed by the sort in
// `pallas_lift_splat_forward`), i.e. the forward of
// sgv3d_tpu/ops/voxel_pooling.py `lift_splat_pool`:
//   BEV[b, cell, :] = sum over points q = (n, j, p) of the cameras of b with
//                     cells[q] == cell of height[q] * context[n, p, :]
// with the trash cell `num_cells` (and any cell outside [0, num_cells))
// dropped.
//
// What bounds it on an H100: memory. Each live point reads its cell, its
// weight and its C-float context row (348 bytes at C = 87; the row is
// shared by every bin of the pixel, so the bound counts it once, but the
// pool gathers it once a point, from L2); each cell writes C floats once.
//
// The prep orders the live points by key b * num_cells + cell, ties by
// the flat point index q: exactly the permutation of a stable sort of the
// keys (`torch.sort(stable=True)`) with the trash points left out. It is an
// LSD radix sort over only the key range's bits (16 at 128x128 cells and
// batch 4: two 8-bit passes), in tiles of kTile points:
//   1. `tile_hist_kernel<true>` reads the cells once: per-key counts by
//      integer atomics (one a distinct key of a warp, so the counts are the
//      same on every run) and the tiles' pass-0 digit counts;
//   2. `scan_kernel`: each digit's counts over the tiles, scanned in
//      (digit, tile) order, one block a digit; more blocks scan the per-key
//      counts into the segment offsets, one a chunk of 4096 keys (more
//      above 2^22 keys), each from its chunk's start: the sum of the
//      chunks' counts that step 1 also took;
//   3. `place_kernel`: each tile ranks its points within the tile, warp by
//      warp in point order (lanes of one digit found by a ballot a digit
//      bit, per-warp digit counts in shared memory, then a scan over the
//      warps), stages the tile in shared memory in digit order and
//      writes each digit's run to digit base + tile base, coalesced.
// A later pass (steps 1-3 on the placed (key, q) pairs, with
// `tile_hist_kernel<false>` counting) reads what the last one wrote; each
// point's height rides along from pass 0's coalesced read. The last pass
// writes each point's (context row, weight) pair and its key into its slot.
// The pool gives each warp kChunk consecutive slots of one batch element,
// whatever the segments (near cells of a real rig hold hundreds of points,
// far ones none); the chunks start afresh at each element's first slot, so
// a frame's sums are the same bits whatever frames precede it in the
// batch: one
// coalesced load of 32 (row, weight) pairs and keys, then kUnroll context
// rows in flight at a time before they are summed in slot order, lanes
// owning channels, in fp32 registers. A segment inside one chunk is summed
// in slot order and written by its warp; one that reaches over chunks is
// the sum, in chunk order, of its chunks' partial rows (`finish_kernel`,
// which also writes the empty cells' zeros). There are no float atomics,
// so the result is bitwise the same on every run; the (N, J, HW, C)
// product is never built; every cell is written exactly once, so the
// output needs no zeroing; trash points are never placed or visited.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kThreads = 256;               // prep blocks; one digit a thread
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // points a lane in a tile
constexpr int kTile = kThreads * kItems;    // 2048 points
constexpr int kWarpRun = 32 * kItems;       // a warp's contiguous run
constexpr int kScanThreads = 1024;
constexpr int kPoolWarps = 8;
constexpr int kUnroll = 2;                  // context rows in flight a warp
constexpr int kChunk = 64;                  // slots a pool warp
constexpr int kMaxChannelSlots = 4;         // C <= 128
constexpr int kMaxChunks = 1024;            // blocks of the offsets scan
static_assert(kThreads == kRadix, "place_kernel gives each thread one digit");

struct Geo {
  int p;          // points N * J * HW
  int per_cam;    // J * HW
  int per_b;      // points of one batch element
  int hw;
  int num_cells;
  int chunk_bits;  // keys a block of the offsets scan: 1 << chunk_bits
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Item i of a pass: point i (pass 0, from the cells) or the i-th placed
// (key, q) pair (later passes, i < m). False for trash and past the end.
template <bool kPoints>
__device__ __forceinline__ bool load_item(const int* __restrict__ cells,
                                          const int2* __restrict__ items,
                                          const Geo& g, int m, int i, int& key,
                                          int& q) {
  if (kPoints) {
    if (i >= g.p) return false;
    const int cell = __ldg(cells + i);
    if (cell < 0 || cell >= g.num_cells) return false;
    key = (i / g.per_b) * g.num_cells + cell;
    q = i;
    return true;
  }
  if (i >= m) return false;
  const int2 it = items[i];
  key = it.x;
  q = it.y;
  return true;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive prefix of v over the block's threads in thread order; *total
// gets the block's sum. Every thread calls it; s_warp holds 32 ints.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < static_cast<int>(blockDim.x >> 5) ? s_warp[lane] : 0;
    s_warp[lane] = warp_inclusive_scan(w);
  }
  __syncthreads();
  const int excl = (warp ? s_warp[warp - 1] : 0) + incl - v;
  *total = s_warp[31];
  __syncthreads();
  return excl;
}

// In-place exclusive scan of data[0, n), starting from `carry`, four
// consecutive ints a thread a round; returns carry + the sum.
__device__ int block_scan_array(int* data, int n, int carry, int* s_warp) {
  for (int base = 0; base < n; base += blockDim.x * 4) {
    const int i0 = base + threadIdx.x * 4;
    int v[4];
    int sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = i0 + e < n ? data[i0 + e] : 0;
      sum += v[e];
    }
    int total;
    int excl = carry + block_exclusive_scan(sum, s_warp, &total);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i0 + e < n) data[i0 + e] = excl;
      excl += v[e];
    }
    carry += total;
  }
  return carry;
}

// The live lanes whose digit equals this lane's, by one ballot a digit bit
// (the calling lane must be live for the result to hold it).
__device__ __forceinline__ unsigned match_digit(int digit, bool live) {
  unsigned same = __ballot_sync(0xffffffffu, live);
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool set = (digit >> b) & 1;
    const unsigned bits = __ballot_sync(0xffffffffu, set);
    same &= set ? bits : ~bits;
  }
  return same;
}

// hist[digit * tiles + tile]: the tile's count of each digit at `shift`;
// with kPoints also counts[key] and chunks[key >> g.chunk_bits] += the
// tile's points of each key.
template <bool kPoints>
__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(const int* __restrict__ cells, const int2* __restrict__ items,
                 const int* __restrict__ m_ptr, Geo g, int shift,
                 int* __restrict__ counts, int* __restrict__ chunks,
                 int* __restrict__ hist, int tiles) {
  __shared__ int s_hist[kRadix];
  __shared__ int s_chunk[kPoints ? kMaxChunks : 1];
  s_hist[threadIdx.x] = 0;
  if (kPoints) {
    for (int c = threadIdx.x; c < kMaxChunks; c += kThreads) s_chunk[c] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int m = kPoints ? 0 : *m_ptr;
  const int base = blockIdx.x * kTile + (threadIdx.x >> 5) * kWarpRun;
#pragma unroll 4
  for (int it = 0; it < kItems; ++it) {
    int key = 0, q;
    const bool live = load_item<kPoints>(cells, items, g, m, base + it * 32 + lane,
                                         key, q);
    if (kPoints) {
      const unsigned same = __match_any_sync(0xffffffffu, live ? key : -1);
      if (live && lane == __ffs(same) - 1) {
        atomicAdd(counts + key, __popc(same));
        atomicAdd(s_chunk + (key >> g.chunk_bits), __popc(same));
      }
    }
    const int digit = (key >> shift) & (kRadix - 1);
    const unsigned same = match_digit(digit, live);
    if (live && lane == __ffs(same) - 1) atomicAdd(s_hist + digit, __popc(same));
  }
  __syncthreads();
  hist[threadIdx.x * tiles + blockIdx.x] = s_hist[threadIdx.x];
  if (kPoints) {
    for (int c = threadIdx.x; c < kMaxChunks; c += kThreads) {
      if (s_chunk[c]) atomicAdd(chunks + c, s_chunk[c]);
    }
  }
}

// Blocks [0, kRadix): scan digit blockIdx.x's counts over the tiles in
// place and write the digit's total. Blocks kRadix + c (launched for pass 0
// only, one a chunk of 1 << chunk_bits keys): scan chunk c's per-key
// counts into offsets in place, from the sum of the chunks before it; the
// last also writes offsets[num_keys], the live points.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ hist, int tiles, int* __restrict__ totals,
            int* __restrict__ offsets, const int* __restrict__ chunks,
            int num_keys, int chunk_bits) {
  __shared__ int s_warp[32];
  if (blockIdx.x < kRadix) {
    const int t = block_scan_array(hist + blockIdx.x * tiles, tiles, 0, s_warp);
    if (threadIdx.x == 0) totals[blockIdx.x] = t;
    return;
  }
  const int c = blockIdx.x - kRadix;
  int before = 0;
  for (int i = threadIdx.x; i < c; i += blockDim.x) before += chunks[i];
  int start;
  block_exclusive_scan(before, s_warp, &start);
  const int lo = c << chunk_bits;
  const int n = min(num_keys - lo, 1 << chunk_bits);
  const int end = block_scan_array(offsets + lo, n, start, s_warp);
  if (lo + n == num_keys && threadIdx.x == 0) offsets[num_keys] = end;
}

// One pass's placement of a tile; weights[i] is item i's weight (pass 0:
// the height of point i). Not the last pass: out[pos] = (key, q) and
// w_out[pos] = its weight. The last: out[pos] = (context row, weight bits),
// keys_out[pos] = key and, if `order` is not null, order[pos] = q. The
// tile's items are staged in shared memory in digit order first, so that
// each digit's run goes out coalesced.
template <bool kPoints, bool kLast>
__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ cells, const int2* __restrict__ items,
             const int* __restrict__ m_ptr, Geo g, int shift,
             const int* __restrict__ hist, const int* __restrict__ totals,
             int tiles, const float* __restrict__ weights,
             int2* __restrict__ out, float* __restrict__ w_out,
             int* __restrict__ keys_out, int* __restrict__ order) {
  __shared__ int s_off[kRadix];          // the digit's first slot, globally
  __shared__ int s_start[kRadix];        // the digit's first slot in the tile
  __shared__ int s_cnt[kWarps][kRadix];  // a warp's digit counts, then starts
  __shared__ int s_warp[32];
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_items = reinterpret_cast<int2*>(smem);           // the tile in digit order
  float* s_w = reinterpret_cast<float*>(s_items + kTile);
  int* s_keys = reinterpret_cast<int*>(s_w + kTile);        // the last pass only
  unsigned char* s_digit = smem + kTile * (kLast ? 16 : 12);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = threadIdx.x;  // this thread's digit in the per-digit steps
  {
    int total;
    const int digit_base = block_exclusive_scan(totals[d], s_warp, &total);
    s_off[d] = digit_base + hist[d * tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_cnt[w][d] = 0;
  }
  __syncthreads();

  const int m = kPoints ? 0 : *m_ptr;
  const int base = blockIdx.x * kTile + warp * kWarpRun;
  // rank within the warp's run << kRadixBits | digit, or -1 for no point;
  // the items are loaded again for staging, to keep registers few
  int ranked[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    int key = 0, q;
    const bool live = load_item<kPoints>(cells, items, g, m, base + it * 32 + lane,
                                         key, q);
    const int digit = (key >> shift) & (kRadix - 1);
    const unsigned same = match_digit(digit, live);
    const int prev = live ? s_cnt[warp][digit] : 0;
    __syncwarp();
    if (live && lane == __ffs(same) - 1) s_cnt[warp][digit] = prev + __popc(same);
    __syncwarp();
    ranked[it] = live ? (prev + __popc(same & lanemask_lt())) << kRadixBits | digit
                      : -1;
  }
  __syncthreads();
  int tile_live;
  {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w][d];
      s_cnt[w][d] = run;
      run += c;
    }
    s_start[d] = block_exclusive_scan(run, s_warp, &tile_live);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (ranked[it] < 0) continue;
    int key, q;
    const int i = base + it * 32 + lane;
    load_item<kPoints>(cells, items, g, m, i, key, q);
    const int digit = ranked[it] & (kRadix - 1);
    const int local = s_start[digit] + s_cnt[warp][digit] + (ranked[it] >> kRadixBits);
    s_digit[local] = static_cast<unsigned char>(digit);
    s_w[local] = weights[i];
    if (kLast) {
      const int n = q / g.per_cam;
      s_items[local] = make_int2(n * g.hw + (q - n * g.per_cam) % g.hw, 0);
      s_keys[local] = key;
      if (order != nullptr) order[s_off[digit] + local - s_start[digit]] = q;
    } else {
      s_items[local] = make_int2(key, q);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < tile_live; l += kThreads) {
    const int digit = s_digit[l];
    const int pos = s_off[digit] + l - s_start[digit];
    if (kLast) {
      out[pos] = make_int2(s_items[l].x, __float_as_int(s_w[l]));
      keys_out[pos] = s_keys[l];
    } else {
      out[pos] = s_items[l];
      w_out[pos] = s_w[l];
    }
  }
}

// The chunks of batch element b start at its first slot. Called by a whole
// warp: the pool's chunk `chunk` is chunk (chunk - *base) of the element
// returned (-1 past the last), whose slots start at *start. Lanes read 32
// elements' offsets at a time and scan their chunk counts.
__device__ int chunk_owner(const int* offsets, int num_cells, int batch,
                           int chunk, int* base, int* start) {
  const int lane = threadIdx.x & 31;
  int first = 0;
  for (int b0 = 0; b0 < batch; b0 += 32) {
    const int b = b0 + lane;
    int lo = 0, k = 0;
    if (b < batch) {
      lo = offsets[b * num_cells];
      k = (offsets[(b + 1) * num_cells] - lo + kChunk - 1) / kChunk;
    }
    int incl = k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, b < batch && chunk < first + incl);
    if (hit) {
      const int owner = __ffs(hit) - 1;
      *base = first + __shfl_sync(0xffffffffu, incl - k, owner);
      *start = __shfl_sync(0xffffffffu, lo, owner);
      return b0 + owner;
    }
    first += __shfl_sync(0xffffffffu, incl, 31);
  }
  return -1;
}

// The pool chunks of the batch elements before b, by a whole warp.
__device__ int chunks_before(const int* offsets, int num_cells, int b) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int e0 = 0; e0 < b; e0 += 32) {
    const int e = e0 + lane;
    int k = e < b ? (offsets[(e + 1) * num_cells] - offsets[e * num_cells] +
                     kChunk - 1) / kChunk
                  : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
    sum += k;
  }
  return sum;
}

// The pool. Warp w sums the points of its chunk, kChunk slots of one batch
// element (of the live ones), in slot order, flushing at every change of key: a
// segment wholly inside the chunk goes to out[key]; the chunk's first and
// last segments, when they reach past it, go to the chunk's two partial
// rows, which `finish_kernel` sums in chunk order. The work is the same
// for every warp, however skewed the segments.
template <int CS>
__global__ void __launch_bounds__(kPoolWarps * 32)
pool_kernel(const float* __restrict__ context, const int2* __restrict__ pairs,
            const int* __restrict__ keys, const int* __restrict__ offsets,
            float* __restrict__ out, float* __restrict__ partials,
            int num_cells, int batch, int c) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kPoolWarps + (threadIdx.x >> 5);
  int base, start;
  const int b = chunk_owner(offsets, num_cells, batch, chunk, &base, &start);
  if (b < 0) return;  // whole warp leaves together
  const int lo = start + (chunk - base) * kChunk;
  const int hi = min(lo + kChunk, offsets[(b + 1) * num_cells]);
  const int first = keys[lo];
  const int last = keys[hi - 1];
  const bool first_out = offsets[first] < lo || offsets[first + 1] > hi;
  const bool last_out = offsets[last + 1] > hi;

  float acc[CS];
#pragma unroll
  for (int s = 0; s < CS; ++s) acc[s] = 0.f;
  int cur = first;
  auto flush = [&]() {
    float* dst = out + static_cast<int64_t>(cur) * c;
    if (cur == first && first_out) {
      dst = partials + static_cast<int64_t>(2 * chunk) * c;
    } else if (cur == last && last_out) {
      dst = partials + static_cast<int64_t>(2 * chunk + 1) * c;
    }
#pragma unroll
    for (int s = 0; s < CS; ++s) {
      const int ch = s * 32 + lane;
      if (ch < c) dst[ch] = acc[s];
      acc[s] = 0.f;
    }
  };

  for (int base = lo; base < hi; base += 32) {
    const bool mine = base + lane < hi;
    const int2 pr = mine ? pairs[base + lane] : make_int2(0, 0);
    const int kk = mine ? keys[base + lane] : -1;
    const int n = min(hi - base, 32);
    for (int t = 0; t < n; t += kUnroll) {
      float v[kUnroll][CS];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = (t + u) & 31;
        const int row = __shfl_sync(0xffffffffu, pr.x, src);
        w[u] = __int_as_float(__shfl_sync(0xffffffffu, pr.y, src));
        const float* ctx = context + static_cast<int64_t>(row) * c;
#pragma unroll
        for (int s = 0; s < CS; ++s) {
          const int ch = s * 32 + lane;
          v[u][s] = (t + u < n && ch < c) ? __ldg(ctx + ch) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = __shfl_sync(0xffffffffu, kk, (t + u) & 31);
        if (t + u < n) {
          if (key != cur) {
            flush();
            cur = key;
          }
#pragma unroll
          for (int s = 0; s < CS; ++s) acc[s] = fmaf(w[u], v[u][s], acc[s]);
        }
      }
    }
  }
  flush();
}

// One warp a cell g: zeros for an empty segment, the sum in chunk order of
// the partial rows of a segment that reaches over several chunks (each
// chunk's first partial if the segment holds the chunk's first slot, else
// its last); nothing for a segment inside one chunk, which the pool wrote.
template <int CS>
__global__ void __launch_bounds__(kPoolWarps * 32)
finish_kernel(const int* __restrict__ offsets,
              const float* __restrict__ partials, float* __restrict__ out,
              int num_cells, int batch, int c) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kPoolWarps + (threadIdx.x >> 5);
  if (g >= num_cells * batch) return;
  const int b = g / num_cells;
  const int start = offsets[b * num_cells];
  const int lo = offsets[g];
  const int hi = offsets[g + 1];
  // chunk indices within element b first: a segment inside one chunk
  // leaves before the element's chunk base is needed
  if (hi > lo && (lo - start) / kChunk == (hi - 1 - start) / kChunk) return;
  const int base = chunks_before(offsets, num_cells, b);
  const int c0 = base + (lo - start) / kChunk;
  const int c1 = hi > lo ? base + (hi - 1 - start) / kChunk : c0 - 1;
  float acc[CS];
#pragma unroll
  for (int s = 0; s < CS; ++s) acc[s] = 0.f;
  for (int k = c0; k <= c1; ++k) {
    const int k_start = start + (k - base) * kChunk;
    const float* p = partials + static_cast<int64_t>(2 * k + (lo <= k_start ? 0 : 1)) * c;
#pragma unroll
    for (int s = 0; s < CS; ++s) {
      const int ch = s * 32 + lane;
      if (ch < c) acc[s] += p[ch];
    }
  }
  float* o = out + static_cast<int64_t>(g) * c;
#pragma unroll
  for (int s = 0; s < CS; ++s) {
    const int ch = s * 32 + lane;
    if (ch < c) o[ch] = acc[s];
  }
}

int64_t align4(int64_t x) { return (x + 3) & ~int64_t{3}; }

int64_t pool_chunks(int64_t p) { return (p + kChunk - 1) / kChunk; }

// The workspace, in ints: offsets [R + 1] and per-chunk key counts
// [kMaxChunks]; the last pass's (row, weight) pairs [2P] (16-byte aligned)
// and keys [P]; digit totals [kRadix]; tile digit counts [kRadix * tiles];
// two ping-pong buffers of (key, q) pairs [2P each] (16-byte aligned) and
// of their weights [P each]; the pool's partial rows [2 C a pool chunk].
struct Workspace {
  int* offsets;
  int* chunks;
  int2* pairs;
  int* keys;
  int* totals;
  int* hist;
  int2* buf[2];
  float* wbuf[2];
  float* partials;
};

// Lays the workspace out in `w`, when `ws` is not null, and returns its
// size in ints.
int64_t carve(int* ws, int64_t num_keys, int64_t p, int tiles, int c,
              int batch, Workspace* w) {
  const int64_t a_pairs = align4(num_keys + 1 + kMaxChunks);
  const int64_t a_keys = a_pairs + 2 * p;
  const int64_t a_totals = a_keys + p;
  const int64_t a_hist = a_totals + kRadix;
  const int64_t a_buf = align4(a_hist + int64_t{kRadix} * tiles);
  const int64_t a_part = a_buf + 6 * p;
  if (ws != nullptr) {
    w->offsets = ws;
    w->chunks = ws + num_keys + 1;
    w->pairs = reinterpret_cast<int2*>(ws + a_pairs);
    w->keys = ws + a_keys;
    w->totals = ws + a_totals;
    w->hist = ws + a_hist;
    w->buf[0] = reinterpret_cast<int2*>(ws + a_buf);
    w->buf[1] = reinterpret_cast<int2*>(ws + a_buf + 2 * p);
    w->wbuf[0] = reinterpret_cast<float*>(ws + a_buf + 4 * p);
    w->wbuf[1] = reinterpret_cast<float*>(ws + a_buf + 5 * p);
    w->partials = reinterpret_cast<float*>(ws + a_part);
  }
  return a_part + 2 * (pool_chunks(p) + batch) * c;
}

template <bool kPoints, bool kLast>
void launch_place_as(int tiles, const int* cells, const int2* in,
                     const float* weights, const int* m_ptr, const Geo& g,
                     int shift, const Workspace& w, int2* out, float* w_out,
                     int* order, cudaStream_t stream) {
  constexpr int kSmem = kTile * (kLast ? 17 : 13);
  static const cudaError_t attr = cudaFuncSetAttribute(
      place_kernel<kPoints, kLast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  (void)attr;  // a refusal shows in the launch's error
  place_kernel<kPoints, kLast><<<tiles, kThreads, kSmem, stream>>>(
      cells, in, m_ptr, g, shift, w.hist, w.totals, tiles, weights, out, w_out,
      w.keys, order);
}

template <bool kPoints>
void launch_place(bool last, int tiles, const int* cells, const int2* in,
                  const float* weights, const int* m_ptr, const Geo& g,
                  int shift, const Workspace& w, int2* out, float* w_out,
                  int* order, cudaStream_t stream) {
  if (last) {
    launch_place_as<kPoints, true>(tiles, cells, in, weights, m_ptr, g, shift, w,
                                   out, nullptr, order, stream);
  } else {
    launch_place_as<kPoints, false>(tiles, cells, in, weights, m_ptr, g, shift,
                                    w, out, w_out, nullptr, stream);
  }
}

// Checks the arguments and lays out the workspace; false if refused.
bool setup(int* ws, int64_t ws_ints, int batch, int num_cells, int n, int j,
           int hw, int c, Geo* g, int* num_keys, int* tiles, Workspace* w) {
  const int64_t p64 = int64_t{n} * j * hw;
  const int64_t keys64 = int64_t{batch} * num_cells;
  if (batch <= 0 || num_cells <= 0 || n % batch || p64 > INT32_MAX - kTile ||
      keys64 >= INT32_MAX)
    return false;
  const int p = static_cast<int>(p64);
  *num_keys = static_cast<int>(keys64);
  *tiles = (p + kTile - 1) / kTile;
  int bits = 1;
  while ((int64_t{1} << bits) < keys64) ++bits;
  const int chunk_bits = bits > 22 ? bits - 10 : 12;  // <= kMaxChunks chunks
  *g = Geo{p, j * hw, static_cast<int>(p64 / batch), hw, num_cells, chunk_bits};
  return carve(ws, *num_keys, p, *tiles, c, batch, w) <= ws_ints;
}

// Radix passes of kRadixBits over the bits of the largest key.
int passes_for(int num_keys) {
  int bits = 1;
  while ((int64_t{1} << bits) < num_keys) ++bits;
  return (bits + kRadixBits - 1) / kRadixBits;
}

// The prep: offsets and the last pass's pairs in the workspace, order[slot]
// = q if `order` is not null; adds to *launched one for each launch it
// makes (kernels and the memset). Returns a CUDA error code, -1 if refused.
int prep(const float* height, const int* cells, int* ws, int64_t ws_ints,
         int* order, int batch, int num_cells, int n, int j, int hw,
         int* launched, cudaStream_t stream) {
  Geo g;
  int num_keys, tiles;
  Workspace w;
  if (!setup(ws, ws_ints, batch, num_cells, n, j, hw, 0, &g, &num_keys, &tiles,
             &w))
    return -1;
  const int passes = passes_for(num_keys);
  const int* m_ptr = w.offsets + num_keys;  // live points, after the scan
  const int chunks = ((num_keys - 1) >> g.chunk_bits) + 1;

  cudaMemsetAsync(w.offsets, 0, sizeof(int) * (num_keys + 1 + kMaxChunks),
                  stream);
  ++*launched;
  if (tiles > 0) {
    tile_hist_kernel<true><<<tiles, kThreads, 0, stream>>>(
        cells, nullptr, nullptr, g, 0, w.offsets, w.chunks, w.hist, tiles);
    ++*launched;
  }
  scan_kernel<<<kRadix + chunks, kScanThreads, 0, stream>>>(
      w.hist, tiles, w.totals, w.offsets, w.chunks, num_keys, g.chunk_bits);
  ++*launched;
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    const int shift = pass * kRadixBits;
    const int2* in = w.buf[(pass + 1) & 1];
    int2* out = last ? w.pairs : w.buf[pass & 1];
    float* w_out = w.wbuf[pass & 1];
    if (pass == 0) {
      launch_place<true>(last, tiles, cells, nullptr, height, m_ptr, g, 0, w,
                         out, w_out, order, stream);
      ++*launched;
      continue;
    }
    tile_hist_kernel<false><<<tiles, kThreads, 0, stream>>>(
        nullptr, in, m_ptr, g, shift, nullptr, nullptr, w.hist, tiles);
    scan_kernel<<<kRadix, kScanThreads, 0, stream>>>(
        w.hist, tiles, w.totals, nullptr, nullptr, num_keys, g.chunk_bits);
    launch_place<false>(last, tiles, nullptr, in, w.wbuf[(pass + 1) & 1], m_ptr,
                        g, shift, w, out, w_out, order, stream);
    *launched += 3;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int CS>
void launch_pool(const float* context, const Workspace& w, float* out, int p,
                 int num_cells, int batch, int c, int* launched,
                 cudaStream_t stream) {
  const int64_t warps = pool_chunks(p) + batch;  // each element's last chunk may be short
  const int num_keys = num_cells * batch;
  if (p > 0) {
    pool_kernel<CS><<<(warps + kPoolWarps - 1) / kPoolWarps, kPoolWarps * 32, 0,
                      stream>>>(context, w.pairs, w.keys, w.offsets, out,
                                w.partials, num_cells, batch, c);
    ++*launched;
  }
  finish_kernel<CS><<<(num_keys + kPoolWarps - 1) / kPoolWarps, kPoolWarps * 32,
                      0, stream>>>(w.offsets, w.partials, out, num_cells, batch, c);
  ++*launched;
}

// The pool over a workspace the prep has filled; counts its launches into
// *launched.
int pool(const float* context, int* ws, int64_t ws_ints, float* out, int batch,
         int num_cells, int n, int j, int hw, int c, int* launched,
         cudaStream_t stream) {
  Geo g;
  int num_keys, tiles;
  Workspace w;
  if (c <= 0 || c > 32 * kMaxChannelSlots ||
      !setup(ws, ws_ints, batch, num_cells, n, j, hw, c, &g, &num_keys, &tiles,
             &w))
    return -1;
  if (c <= 32) {
    launch_pool<1>(context, w, out, g.p, num_cells, batch, c, launched, stream);
  } else if (c <= 64) {
    launch_pool<2>(context, w, out, g.p, num_cells, batch, c, launched, stream);
  } else if (c <= 96) {
    launch_pool<3>(context, w, out, g.p, num_cells, batch, c, launched, stream);
  } else {
    launch_pool<kMaxChannelSlots>(context, w, out, g.p, num_cells, batch, c, launched,
                                  stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry returns -1 for arguments it refuses, else 0 or the CUDA
// error code of its launches. `ws` is an int32 workspace of `ws_ints` ints
// of the size `lift_splat_layout` gives. A launching entry adds to
// *launched the number of launches it made (kernels and the memset: 3 x
// radix passes + 1 for the prep, 2 for the pool).

// out[0]: the workspace's size in ints for these shapes (a pool of C
// channels; c = 0 for the prep alone); out[1]: the int offset in it of the
// prep's (row, weight) pairs, after the offsets at int 0.
extern "C" int lift_splat_layout(int batch, int num_cells, int n, int j,
                                 int hw, int c, long long* out) {
  Geo g;
  int num_keys, tiles;
  Workspace w;
  if (c < 0 || !setup(nullptr, INT64_MAX, batch, num_cells, n, j, hw, c, &g,
                      &num_keys, &tiles, &w))
    return -1;
  out[0] = carve(nullptr, num_keys, g.p, tiles, c, batch, nullptr);
  out[1] = align4(int64_t{num_keys} + 1 + kMaxChunks);
  return 0;
}

// The prep alone; order: (N*J*HW,) int32 or null.
extern "C" int lift_prep_launch(const float* height, const int* cells,
                                int* ws, long long ws_ints, int* order,
                                int batch, int num_cells, int n, int j, int hw,
                                int* launched, cudaStream_t stream) {
  return prep(height, cells, ws, ws_ints, order, batch, num_cells, n, j, hw,
              launched, stream);
}

// The pool alone, over a workspace the prep has filled for the same
// shapes; context: (N, HW, C) fp32; out: (batch, num_cells, C) fp32.
extern "C" int lift_pool_launch(const float* context, int* ws,
                                long long ws_ints, float* out, int batch,
                                int num_cells, int n, int j, int hw, int c,
                                int* launched, cudaStream_t stream) {
  return pool(context, ws, ws_ints, out, batch, num_cells, n, j, hw, c,
              launched, stream);
}

// Prep and pool. height: (N, J, HW) fp32; context: (N, HW, C) fp32;
// cells: (N, J, HW) int32; out: (batch, num_cells, C) fp32. C <= 128.
extern "C" int lift_splat_launch(const float* height, const float* context,
                                 const int* cells, int* ws, long long ws_ints,
                                 float* out, int batch, int num_cells, int n,
                                 int j, int hw, int c, int* launched,
                                 cudaStream_t stream) {
  if (c <= 0 || c > 32 * kMaxChannelSlots) return -1;
  const int err = prep(height, cells, ws, ws_ints, nullptr, batch, num_cells,
                       n, j, hw, launched, stream);
  if (err != 0) return err;
  return pool(context, ws, ws_ints, out, batch, num_cells, n, j, hw, c,
              launched, stream);
}
