// Bilinear splat for Hopper (sm_90a), NHWC: the image cotangent of the
// backward warp.
//
// Replaces both TPU splat kernels of the JAX package: _splat_kernel
// (frame_interpolation_tpu/ops/warp_splat.py, via backward_warp_splat) and
// _splat_resident_kernel (same file, via backward_warp_splat_resident). The
// two differ only in how they keep the accumulator in VMEM; here one kernel
// serves every plane size.
//
//   acc[b, iy + i, ix + j, c] += w_ij * g[b, y, x, c]      for i, j in {0, 1}
//
// with (iy, ix, ay, ax) the warp's clamped corner and alphas for output
// pixel (y, x) (ops/warp.py _query_coords_full: floor clamped to
// [0, size-2], alpha clamped to [0, 1]) and the forward's weights
// w00 = (1-ay)(1-ax), w01 = (1-ay)ax, w10 = ay(1-ax), w11 = ay*ax: the
// transpose of the warp's gather. The accumulator is f32 whatever the
// cotangent's dtype; the caller zeroes it and casts the result.
//
// What bounds it on the H100: the adds. Each output pixel adds 4*C f32
// values into the accumulator. Atomics in device memory resolve in L2,
// which takes them at a limited rate of bytes, so a direct splat pays 16*C
// bytes of atomic traffic a pixel beside the compulsory 4*C (the f32
// accumulator written once) and the cotangent's own bytes. f32 atomics in
// shared memory have no instruction of their own on sm_90 (the compiler
// loops on a compare-and-swap), so privatising the accumulator with them
// trades one slow add for another.
//
// What the design does about it: the TPU kernel keeps a window of the
// accumulator for its tile, since the regions the forward reads for a tile
// are the regions its adjoint writes. Here a block takes a tile of 8x8
// output pixels and a slab of channels (all of C where C <= kMaxSlab,
// else the fewest equal slabs that keep to it) and
//  1. stages the tile's g in shared memory with 16-byte loads (a tile row
//     is contiguous in NHWC when the slab is all of C), started before
//     it needs the flow;
//  2. computes each pixel's corner and weights, and reduces the corners to
//     a bounding box;
//  3. shared route, where the box has at most kMaxCells pixels: puts each
//     (pixel, corner) pair on its box pixel's list (integer atomics in
//     shared memory, which sm_90 has), then computes every element of the
//     box as the sum over its list, the splat done as a gather inside the
//     tile, and adds it into acc with one atomic. For smooth flow the box
//     is the tile and a border, so acc takes little more than a quarter of
//     a direct splat's atomics, a warp's on consecutive floats (a box row
//     is contiguous in NHWC when the slab is all of C);
//  4. global route, where the box is larger (divergent or out-of-bounds
//     flow): every element's four products go straight into acc, a warp's
//     lanes on consecutive channels of one corner.
// The sum order of this route changes from run to run, so checks use
// tolerances. Offsets into g and acc are 64-bit.
//
// Fixed-order route (fi_splat_fixed_*), for reproducible gradients
// (ops/warp.py takes it under torch.use_deterministic_algorithms): each
// accumulator element is the f32 sum of its products in the order of the
// source pixel's flat index, then the corner (00, 01, 10, 11), the same
// bits on every run whatever the tile shape, the launch or the flow. The
// TPU kernel gets a fixed order from its sequential grid; here the splat
// becomes a gather through an index built on the device:
//  1. count: each source pixel adds one to each destination its non-zero
//     corner weights land on (integer atomics: counts do not depend on
//     the order);
//  2. scan: an inclusive prefix of the counts (three kernels: chunk scans,
//     one block over the chunks' totals, the chunks' bases added);
//  3. fill: each (pixel, corner) pair takes a slot of its destination's
//     segment, counting the segment's end down (the slot order varies);
//  4. sort: each segment sorted by (pixel, corner) key, by one thread in
//     place where it holds at most kShortSegment entries (about 4 for
//     smooth flow), else by a block's bitonic sort (out-of-bounds flow
//     piles entries on the frame's edges);
//  5. sum: a thread per accumulator element walks its segment in order,
//     the products with g, and writes the element once (no atomics, and
//     no zeroed accumulator needed).
// Its bytes beside the atomic route's: the index (4 + 8 bytes an entry,
// written and read a few times) and one write of every accumulator
// element; the g reads are the same gather.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
// A block takes a tile of kTileH x kTileW pixels.
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTilePixels = kTileH * kTileW;
constexpr int kEntries = 4 * kTilePixels;  // (pixel, corner) pairs a tile
// The widest slab of channels a block takes.
constexpr int kMaxSlab = 72;
// The most box pixels a tile may gather into; a larger box (divergent or
// out-of-bounds flow) takes the global route.
constexpr int kMaxCells = 1024;

// 16-byte words that hold `bytes` contiguous bytes at any alignment.
__host__ __device__ constexpr int words_for(int bytes) {
  return (bytes + 30) / 16;
}
// The tile's g in shared memory: kTileH tile rows (the slab is all of C) or
// kTilePixels pixels' slabs, each at a pitch of words_for(its bytes).
constexpr int kRowWords = kTileH * words_for(kTileW * kMaxSlab * 4);
constexpr int kSlabWords = kTilePixels * words_for(kMaxSlab * 4);
constexpr int kStageWords = kRowWords > kSlabWords ? kRowWords : kSlabWords;
constexpr int kStageLoads = (kStageWords + kThreads - 1) / kThreads;

// One (pixel, corner) pair of the tile, on its box pixel's list.
struct alignas(16) Entry {
  float w;   // the corner's bilinear weight
  int at;    // the pixel's channel 0 in the staged g, in elements
  int next;  // next entry on the same box pixel's list, -1 at the end
};

// Grid: (tiles across W, tiles across H, B * slabs), `slab` channels per
// block (the last slab takes the rest).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    splat_tile_kernel(const T* __restrict__ g,
                      const float2* __restrict__ flow,
                      float* __restrict__ acc, int H, int W, int C,
                      int slab) {
  __shared__ uint4 s_stage[kStageWords];   // the tile's g, as in memory
  __shared__ Entry s_entry[kEntries];
  __shared__ int s_head[kMaxCells];        // first entry of a box pixel
  __shared__ int64_t s_base[kMaxCells];    // a box pixel's slab in acc
  __shared__ int64_t s_corner[kTilePixels];  // acc offset of the top-left corner
  __shared__ float4 s_w[kTilePixels];        // w00, w01, w10, w11
  __shared__ int s_at[kTilePixels];          // as Entry::at; -1 outside
  __shared__ int s_bounds[kTilePixels / 32][4];
  const T* s_g = reinterpret_cast<const T*>(s_stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slabs = (C + slab - 1) / slab;
  const int64_t plane = (int64_t)(blockIdx.z / slabs) * H;
  const int s0 = (int)(blockIdx.z % slabs) * slab;
  const int cs = min(slab, C - s0);
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int vh = min(kTileH, H - y0), vw = min(kTileW, W - x0);

  // Stage the tile's g: segment s is tile row s (the slab is all of C, so a
  // row of the tile is contiguous in g) or tile pixel s's slab; its 16-byte
  // words land at s * pitch. The loads do not depend on the flow, and a
  // thread starts all of its loads before it stores any.
  const bool rows = cs == C;
  const int seg_len = rows ? vw * C : cs;  // elements
  const int pitch = words_for(seg_len * (int)sizeof(T));
  const int segs = rows ? vh : kTilePixels;
  auto segment = [&](int k) -> const T* {  // NULL outside the image
    const int y = rows ? k : k / kTileW, x = rows ? 0 : k % kTileW;
    if (y >= vh || x >= vw) return nullptr;
    return g + ((plane + y0 + y) * W + x0 + x) * C + (rows ? 0 : s0);
  };
  {
    uint4 v[kStageLoads];
    FlatWalk walk(tid, kThreads, pitch);
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const T* first = walk.i < segs ? segment(walk.i) : nullptr;
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(first) & ~(uintptr_t)15;
      const uintptr_t at = a0 + 16 * (uintptr_t)walk.c;
      const bool ok = first != nullptr &&
                      at < reinterpret_cast<uintptr_t>(first + seg_len);
      v[j] = ok ? __ldg(reinterpret_cast<const uint4*>(at))
                : make_uint4(0, 0, 0, 0);
      walk.next();
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int f = tid + j * kThreads;
      if (f < segs * pitch) s_stage[f] = v[j];
    }
  }

  // The tile's pixels: where their g is staged, corners, weights and the
  // corners' bounding box.
  int iy = 0, ix = 0;
  bool inside = false;
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < kTilePixels) {
    const int ty = tid / kTileW, tx = tid % kTileW;
    const int y = y0 + ty, x = x0 + tx;
    int lo_y = INT_MAX, hi_y = INT_MIN, lo_x = INT_MAX, hi_x = INT_MIN;
    inside = ty < vh && tx < vw;
    int at = -1;
    if (inside) {
      const int k = rows ? ty : tid;
      const int shift = (int)(reinterpret_cast<uintptr_t>(segment(k)) & 15);
      at = (k * pitch * 16 + shift) / (int)sizeof(T) + (rows ? tx * C : 0);
      const Query q = query(y, x, flow[(plane + y) * W + x], H, W);
      iy = q.iy;
      ix = q.ix;
      w = make_float4((1.f - q.ay) * (1.f - q.ax), (1.f - q.ay) * q.ax,
                      q.ay * (1.f - q.ax), q.ay * q.ax);
      lo_y = hi_y = iy;
      lo_x = hi_x = ix;
    }
    s_at[tid] = at;
    s_corner[tid] = ((plane + iy) * W + ix) * C + s0;
    s_w[tid] = w;
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    if (lane == 0) {
      s_bounds[warp][0] = lo_y;
      s_bounds[warp][1] = hi_y;
      s_bounds[warp][2] = lo_x;
      s_bounds[warp][3] = hi_x;
    }
  }
  __syncthreads();
  // The tile's first pixel lies in the image, so the box is not empty.
  int y_lo = s_bounds[0][0], y_hi = s_bounds[0][1];
  int x_lo = s_bounds[0][2], x_hi = s_bounds[0][3];
#pragma unroll
  for (int k = 1; k < kTilePixels / 32; ++k) {
    y_lo = min(y_lo, s_bounds[k][0]);
    y_hi = max(y_hi, s_bounds[k][1]);
    x_lo = min(x_lo, s_bounds[k][2]);
    x_hi = max(x_hi, s_bounds[k][3]);
  }
  const int64_t bh = y_hi - y_lo + 2, bw = x_hi - x_lo + 2;

  if (bh * bw > kMaxCells) {
    // Global route: each element straight into acc, four scalar atomics;
    // a warp's lanes add into consecutive channels of one corner.
    const int64_t row = (int64_t)W * C;
    FlatWalk walk(tid, kThreads, cs);
    for (int e = tid; e < kTilePixels * cs; e += kThreads) {
      const int i = walk.i, c = walk.c;
      walk.next();
      const int at = s_at[i];
      if (at < 0) continue;
      const float v = to_float(s_g[at + c]);
      if (v == 0.f) continue;
      const float4 wi = s_w[i];
      float* t = acc + s_corner[i] + c;
      atomicAdd(t, wi.x * v);
      atomicAdd(t + C, wi.y * v);
      atomicAdd(t + row, wi.z * v);
      atomicAdd(t + row + C, wi.w * v);
    }
    return;
  }

  // Shared route. Each box pixel's list of the (pixel, corner) pairs that
  // land on it, and its slab's offset in acc.
  const int cells = (int)(bh * bw);
  for (int k = tid; k < cells; k += kThreads) {
    const int ry = k / (int)bw, rx = k % (int)bw;
    s_head[k] = -1;
    s_base[k] = ((plane + y_lo + ry) * W + x_lo + rx) * C + s0;
  }
  __syncthreads();
  if (inside) {
    const int cell = (iy - y_lo) * (int)bw + (ix - x_lo);
    const int box[4] = {cell, cell + 1, cell + (int)bw, cell + (int)bw + 1};
    const float wk[4] = {w.x, w.y, w.z, w.w};
    const int at = s_at[tid];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * tid + k;
      s_entry[e] = Entry{wk[k], at, atomicExch(&s_head[box[k]], e)};
    }
  }
  __syncthreads();

  // Flush: the box's flat (box pixel, channel) elements, each the sum over
  // its list, one atomic into acc where it is not 0. A box row's pixels are
  // consecutive in acc where the slab is all of C, so a warp's adds fall on
  // consecutive floats.
  FlatWalk walk(tid, kThreads, cs);
  for (int e = tid; e < cells * cs; e += kThreads) {
    const int cell = walk.i, c = walk.c;
    walk.next();
    float sum = 0.f;
    for (int j = s_head[cell]; j >= 0;) {
      const Entry n = s_entry[j];
      sum += n.w * to_float(s_g[n.at + c]);
      j = n.next;
    }
    if (sum != 0.f) atomicAdd(acc + s_base[cell] + c, sum);
  }
}

template <typename T>
int launch_splat(const void* g, const void* flow, void* acc, int B, int H,
                 int W, int C, void* stream) {
  if (H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  // The fewest slabs of at most kMaxSlab channels, as equal as they come.
  const int fewest = (C + kMaxSlab - 1) / kMaxSlab;
  const int slab = (C + fewest - 1) / fewest;
  const int64_t slabs = (C + slab - 1) / slab;  // as the kernel counts them
  const int64_t tiles_x = (W + kTileW - 1) / kTileW;
  const int64_t tiles_y = (H + kTileH - 1) / kTileH;
  if (tiles_x > 0x7fffffffLL || tiles_y > 65535 || B * slabs > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y,
                  (unsigned)(B * slabs));
  splat_tile_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const float2*>(flow),
      static_cast<float*>(acc), H, W, C, slab);
  return (int)cudaGetLastError();
}

// ---- the fixed-order route --------------------------------------------------

constexpr int kScanThreads = 512;
constexpr int kScanPerThread = 8;
constexpr int kScanChunk = kScanThreads * kScanPerThread;
constexpr int kFixedThreads = 256;
// A segment of at most this many entries is sorted by one thread.
constexpr int kShortSegment = 32;
constexpr int kSortThreads = 1024;
constexpr int kSortBlocks = 132;

// One source pixel's four corners: destination pixels and weights, as the
// atomic route computes them.
struct Corners {
  int64_t d[4];
  float w[4];
};

__device__ __forceinline__ Corners corners(int64_t p, const float2* flow,
                                           int H, int W) {
  const int x = (int)(p % W);
  const int64_t by = p / W;
  const int y = (int)(by % H);
  const int64_t plane = by / H * H;
  const Query q = query(y, x, flow[p], H, W);
  Corners k;
  k.d[0] = (plane + q.iy) * W + q.ix;
  k.d[1] = k.d[0] + 1;
  k.d[2] = k.d[0] + W;
  k.d[3] = k.d[2] + 1;
  k.w[0] = (1.f - q.ay) * (1.f - q.ax);
  k.w[1] = (1.f - q.ay) * q.ax;
  k.w[2] = q.ay * (1.f - q.ax);
  k.w[3] = q.ay * q.ax;
  return k;
}

// 1. Entries a destination receives; a weight of exactly 0 adds nothing
// and takes no entry (a NaN weight does).
__global__ void __launch_bounds__(kFixedThreads)
    splat_count_kernel(const float2* __restrict__ flow, int* __restrict__ count,
                       int64_t pixels, int H, int W) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const Corners k = corners(p, flow, H, W);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k.w[j] != 0.f) atomicAdd(count + k.d[j], 1);
  }
}

// A block's inclusive scan of one value a thread; returns it, and the
// block's total through `total`.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < warps) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[warps - 1];
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  __syncthreads();
  return v + before;
}

// 2a. Each chunk of kScanChunk counts scanned in place (inclusive); its
// total into chunk_total.
__global__ void __launch_bounds__(kScanThreads)
    splat_scan_chunks_kernel(int* __restrict__ a, int* __restrict__ chunk_total,
                             int64_t n) {
  __shared__ int s_warp[32];
  const int64_t base = (int64_t)blockIdx.x * kScanChunk +
                       (int64_t)threadIdx.x * kScanPerThread;
  int v[kScanPerThread];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    v[j] = base + j < n ? a[base + j] : 0;
    sum += v[j];
    v[j] = sum;
  }
  int total;
  const int before = block_scan(sum, s_warp, total) - sum;
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    if (base + j < n) a[base + j] = v[j] + before;
  }
  if (threadIdx.x == 0) chunk_total[blockIdx.x] = total;
}

// 2b. One block: the chunks' totals to exclusive bases, in place.
__global__ void __launch_bounds__(kScanThreads)
    splat_scan_totals_kernel(int* __restrict__ chunk_total, int chunks) {
  __shared__ int s_warp[32];
  const int per = (chunks + kScanThreads - 1) / kScanThreads;
  const int first = threadIdx.x * per;
  int sum = 0;
  for (int j = 0; j < per && first + j < chunks; ++j) {
    sum += chunk_total[first + j];
  }
  int total;
  int run = block_scan(sum, s_warp, total) - sum;
  for (int j = 0; j < per && first + j < chunks; ++j) {
    const int t = chunk_total[first + j];
    chunk_total[first + j] = run;
    run += t;
  }
}

// 2c. Each chunk's base added: `a` holds the inclusive prefix.
__global__ void __launch_bounds__(kScanThreads)
    splat_scan_add_kernel(int* __restrict__ a,
                          const int* __restrict__ chunk_total, int64_t n) {
  const int add = chunk_total[blockIdx.x];
  if (add == 0) return;
  const int64_t base = (int64_t)blockIdx.x * kScanChunk;
  for (int j = threadIdx.x; j < kScanChunk; j += kScanThreads) {
    if (base + j < n) a[base + j] += add;
  }
}

// 3. Each entry into its destination's segment: `end` holds each
// segment's end and is counted down to its start. An entry is the key
// pixel * 4 + corner and the weight's bits.
__global__ void __launch_bounds__(kFixedThreads)
    splat_fill_kernel(const float2* __restrict__ flow, int* __restrict__ end,
                      int2* __restrict__ entries, int64_t pixels, int H,
                      int W) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const Corners k = corners(p, flow, H, W);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k.w[j] != 0.f) {
      const int slot = atomicSub(end + k.d[j], 1) - 1;
      entries[slot] = make_int2((int)(4 * p + j), __float_as_int(k.w[j]));
    }
  }
}

// 4a. Short segments sorted by their thread; the long ones listed.
__global__ void __launch_bounds__(kFixedThreads)
    splat_sort_short_kernel(const int* __restrict__ start,
                            int2* __restrict__ entries, int* __restrict__ longs,
                            int* __restrict__ long_count, int64_t pixels) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= pixels) return;
  const int s = start[d], n = start[d + 1] - s;
  if (n > kShortSegment) {
    longs[atomicAdd(long_count, 1)] = (int)d;
    return;
  }
  int2* e = entries + s;
  for (int i = 1; i < n; ++i) {
    const int2 v = e[i];
    int j = i - 1;
    while (j >= 0 && e[j].x > v.x) {
      e[j + 1] = e[j];
      --j;
    }
    e[j + 1] = v;
  }
}

__device__ __forceinline__ void order_pair(int2* e, int lo, int hi, int n) {
  if (hi < n && e[lo].x > e[hi].x) {
    const int2 t = e[lo];
    e[lo] = e[hi];
    e[hi] = t;
  }
}

// 4b. The long segments, a block each in turn: a bitonic sort whose every
// comparison puts the smaller key first, so the segment's length need not
// be a power of two (the missing entries count as the largest keys and
// never move). The number of long segments is read on the device.
__global__ void __launch_bounds__(kSortThreads)
    splat_sort_long_kernel(const int* __restrict__ start,
                           int2* __restrict__ entries,
                           const int* __restrict__ longs,
                           const int* __restrict__ long_count) {
  const int count = *long_count;
  for (int l = blockIdx.x; l < count; l += gridDim.x) {
    const int d = longs[l];
    const int s = start[d], n = start[d + 1] - s;
    int2* e = entries + s;
    int size = 1;
    while (size < n) size <<= 1;
    for (int k = 2; k <= size; k <<= 1) {
      // The first merge step compares mirrored pairs of each k-block.
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int block = t / (k / 2), off = t % (k / 2);
        order_pair(e, block * k + off, block * k + k - 1 - off, n);
      }
      __syncthreads();
      for (int j = k / 4; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
          const int lo = (t / j) * 2 * j + t % j;
          order_pair(e, lo, lo + j, n);
        }
        __syncthreads();
      }
    }
  }
}

// 5. Each accumulator element the sum of its segment's products in key
// order; a warp's lanes on consecutive channels.
template <typename T>
__global__ void __launch_bounds__(kFixedThreads)
    splat_sum_kernel(const T* __restrict__ g, const int* __restrict__ start,
                     const int2* __restrict__ entries, float* __restrict__ acc,
                     int64_t total, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t d = i / C;
  const int c = (int)(i - d * C);
  const int s = start[d], end = start[d + 1];
  float sum = 0.f;
  for (int j = s; j < end; ++j) {
    const int2 e = entries[j];
    sum += __int_as_float(e.y) * to_float(g[(int64_t)(e.x >> 2) * C + c]);
  }
  acc[i] = sum;
}

// The workspace of the fixed-order route, in int32 words: the entries
// (4 * pixels, two words each), the segment starts (pixels + 1), the long
// segments' list (pixels) and count (1), the scan's chunk totals.
int64_t fixed_chunks(int64_t pixels) {
  return (pixels + 1 + kScanChunk - 1) / kScanChunk;
}

int64_t fixed_workspace_words(int64_t pixels) {
  return (pixels + 1) + 8 * pixels + pixels + 1 + fixed_chunks(pixels);
}

template <typename T>
int launch_splat_fixed(const void* g, const void* flow, void* acc,
                       void* workspace, int B, int H, int W, int C,
                       void* stream) {
  if (H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int64_t pixels = (int64_t)B * H * W;
  // Keys (4 * pixel + corner) and segment offsets are 32-bit.
  if (4 * pixels + 4 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The entries first: an int2 array needs 8-byte alignment.
  if (reinterpret_cast<uintptr_t>(workspace) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int2* entries = static_cast<int2*>(workspace);
  int* start = reinterpret_cast<int*>(entries + 4 * pixels);
  int* longs = start + pixels + 1;
  int* long_count = longs + pixels;
  int* chunk_total = long_count + 1;
  const int64_t chunks = fixed_chunks(pixels);
  const float2* fl = static_cast<const float2*>(flow);
  const unsigned pixel_blocks =
      (unsigned)((pixels + kFixedThreads - 1) / kFixedThreads);
  const int64_t total = pixels * C;
  const int64_t sum_blocks = (total + kFixedThreads - 1) / kFixedThreads;
  if (sum_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;

  cudaError_t err = cudaMemsetAsync(start, 0, (pixels + 1) * sizeof(int), s);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(long_count, 0, sizeof(int), s);
  }
  if (err != cudaSuccess) return (int)err;
  splat_count_kernel<<<pixel_blocks, kFixedThreads, 0, s>>>(fl, start,
                                                            pixels, H, W);
  // Inclusive over pixels + 1 counts (the last is 0): start[pixels] is
  // then the number of entries, and after the fill start[d] is d's first.
  splat_scan_chunks_kernel<<<(unsigned)chunks, kScanThreads, 0, s>>>(
      start, chunk_total, pixels + 1);
  splat_scan_totals_kernel<<<1, kScanThreads, 0, s>>>(chunk_total,
                                                      (int)chunks);
  splat_scan_add_kernel<<<(unsigned)chunks, kScanThreads, 0, s>>>(
      start, chunk_total, pixels + 1);
  splat_fill_kernel<<<pixel_blocks, kFixedThreads, 0, s>>>(fl, start, entries,
                                                           pixels, H, W);
  splat_sort_short_kernel<<<pixel_blocks, kFixedThreads, 0, s>>>(
      start, entries, longs, long_count, pixels);
  splat_sort_long_kernel<<<kSortBlocks, kSortThreads, 0, s>>>(
      start, entries, longs, long_count);
  splat_sum_kernel<T><<<(unsigned)sum_blocks, kFixedThreads, 0, s>>>(
      static_cast<const T*>(g), start, entries, static_cast<float*>(acc),
      total, C);
  return (int)cudaGetLastError();
}

}  // namespace

// acc: (B, H, W, C) f32, zeroed by the caller.
extern "C" int fi_splat_bf16(const void* g, const void* flow, void* acc,
                             int B, int H, int W, int C, void* stream) {
  return launch_splat<__nv_bfloat16>(g, flow, acc, B, H, W, C, stream);
}

extern "C" int fi_splat_f32(const void* g, const void* flow, void* acc, int B,
                            int H, int W, int C, void* stream) {
  return launch_splat<float>(g, flow, acc, B, H, W, C, stream);
}

// The fixed-order route. acc: (B, H, W, C) f32, every element written
// (need not be zeroed); workspace: fi_splat_fixed_workspace_bytes(B, H, W)
// bytes, 8-byte aligned, its contents free.
extern "C" long long fi_splat_fixed_workspace_bytes(int B, int H, int W) {
  return 4LL * fixed_workspace_words((int64_t)B * H * W);
}

extern "C" int fi_splat_fixed_bf16(const void* g, const void* flow, void* acc,
                                   void* workspace, int B, int H, int W,
                                   int C, void* stream) {
  return launch_splat_fixed<__nv_bfloat16>(g, flow, acc, workspace, B, H, W,
                                           C, stream);
}

extern "C" int fi_splat_fixed_f32(const void* g, const void* flow, void* acc,
                                  void* workspace, int B, int H, int W, int C,
                                  void* stream) {
  return launch_splat_fixed<float>(g, flow, acc, workspace, B, H, W, C,
                                   stream);
}
