// Bilinear splat for Hopper (sm_90a), NHWC: the image cotangent of the
// backward warp.
//
// Replaces both TPU splat kernels of the JAX package: _splat_kernel
// (frame_interpolation_tpu/ops/warp_splat.py, via backward_warp_splat) and
// _splat_resident_kernel (same file, via backward_warp_splat_resident). The
// two differ only in how they keep the accumulator in VMEM; here one route
// serves every plane size.
//
//   acc[b, iy + i, ix + j, c] += w_ij * g[b, y, x, c]      for i, j in {0, 1}
//
// with (iy, ix, ay, ax) the warp's clamped corner and alphas for output
// pixel (y, x) (ops/warp.py _query_coords_full: floor clamped to
// [0, size-2], alpha clamped to [0, 1]) and the forward's weights
// w00 = (1-ay)(1-ax), w01 = (1-ay)ax, w10 = ay(1-ax), w11 = ay*ax: the
// transpose of the warp's gather. The accumulator is f32 whatever the
// cotangent's dtype, and every element of it is written.
//
// The order of the sums is fixed: each accumulator element is the f32 sum
// of its products in the order of the source pixel's flat index, then the
// corner (00, 01, 10, 11), from 0, one rounding a product and one an add,
// so a launch gives the same bits on every run whatever the flow
// (ops/warp.splat_fixed_order_plain computes the same sums in plain tensor
// ops, bit for bit). The TPU kernels get a fixed order from their grid,
// whose tiles run one after another with strict read-after-write ordering;
// blocks here run in no order, so adds into the accumulator by atomics
// would sum in another order on each run. Here the splat becomes a gather
// through an index built on the device.
//
// What bounds it on the H100: building the index and the gather's latency,
// not the adds. So the index is small: for each destination tile of 8x8
// pixels, the source pixels with a corner in it (one entry for each tile a
// pixel's corners reach: one for most pixels of smooth flow, where a
// (pixel, corner) index holds four), in five kernels and a memset:
//  1. count: each tile's sources (integer atomics, one for each group of
//     a warp's lanes that land in one tile: counts do not depend on the
//     order);
//  2. scan: one block turns the counts into the tiles' starts;
//  3. fill: each source's flat index into its tiles' lists, slot order
//     free;
//  4. sum: a block of a warp for each 32 channels (up to 256) takes a
//     (tile, slab of channels): it sorts the tile's list in shared memory
//     (a bitonic sort), recomputes each
//     source's corners (the count's f32 operations), and each warp adds
//     them in source order into its channels of the tile's accumulators
//     in shared memory, loading each source's g once, 8 sources' loads in
//     flight; every element is written once (no float atomics, and no
//     zeroed accumulator needed). A destination element's products come
//     one a source, so source order is the documented order;
//  5. long tiles: a list longer than kernel 4 sorts (out-of-bounds flow
//     piles sources onto the frame's edges) is sorted by a block of 1024
//     threads in 128 KB of shared memory (in place in the workspace beyond
//     that) and summed the same way.
// Its bytes beside the compulsory ones (g and the flow read, the
// accumulator written once): 4 bytes a (source, tile) pair written and
// read twice, and the flow read twice more. Offsets into g and acc are
// 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bilinear.cuh"

namespace {

// A destination tile of kTileH x kTileW pixels.
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTilePixels = kTileH * kTileW;

constexpr int kFixedThreads = 256;
constexpr int kScanThreads = 1024;
// Kernel 4 sorts a destination tile's source list in shared memory up to
// kSortSources; a longer list (out-of-bounds flow piles sources onto the
// frame's edges) goes to kernel 5, which sorts up to kLongSources in
// dynamic shared memory and longer ones in place in the workspace.
constexpr int kSortSources = 1024;
constexpr int kLongThreads = 1024;
constexpr int kLongSources = 32768;

// One source pixel's four corners, by the warp's query (bilinear.cuh): the
// destination tile each lands in (flat over (b, tile row, tile column)),
// the destination pixel's place in that tile (row * 8 + column) and the
// weight.
struct Corners {
  int tile[4];
  int pos[4];
  float w[4];
};

__device__ __forceinline__ Corners corners(uint32_t p, const float2* flow,
                                           int H, int W, int tiles_h,
                                           int tiles_w) {
  const int x = (int)(p % (uint32_t)W);
  const uint32_t by = p / (uint32_t)W;
  const int y = (int)(by % (uint32_t)H);
  const int b = (int)(by / (uint32_t)H);
  const Query q = query(y, x, flow[p], H, W);
  Corners k;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int yy = q.iy + (j >> 1), xx = q.ix + (j & 1);
    k.tile[j] = (b * tiles_h + yy / kTileH) * tiles_w + xx / kTileW;
    k.pos[j] = (yy % kTileH) * kTileW + xx % kTileW;
  }
  k.w[0] = (1.f - q.ay) * (1.f - q.ax);
  k.w[1] = (1.f - q.ay) * q.ax;
  k.w[2] = q.ay * (1.f - q.ax);
  k.w[3] = q.ay * q.ax;
  return k;
}

// 1. and 3. Each source pixel's destination tiles: the tiles its corners
// with a non-zero weight land in (a weight of exactly 0 adds nothing; a
// NaN weight does), each once, counted (`fill` false) or the pixel's flat
// index written into the tile's list (`fill` true; `next` then holds each
// tile's next free slot). A warp's lanes are 32 consecutive pixels, whose
// corners mostly share a tile: each group of lanes with one tile takes one
// integer atomic. The order of a list varies from run to run; kernel 4
// sorts it.
template <bool fill>
__global__ void __launch_bounds__(kFixedThreads)
    splat_index_kernel(const float2* __restrict__ flow, int* __restrict__ next,
                       uint32_t* __restrict__ sources, int64_t pixels, int H,
                       int W, int tiles_h, int tiles_w) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int tile[4] = {-1, -1, -1, -1};
  if (p < pixels) {
    const Corners k = corners((uint32_t)p, flow, H, W, tiles_h, tiles_w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k.w[j] != 0.f) tile[j] = k.tile[j];
#pragma unroll
      for (int i = 0; i < j; ++i) {
        if (tile[i] == tile[j]) tile[j] = -1;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, tile[j]);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (tile[j] >= 0 && lane == leader) {
      base = atomicAdd(next + tile[j], __popc(peers));
    }
    if (!fill) continue;
    base = __shfl_sync(0xffffffffu, base, leader);
    if (tile[j] >= 0) {
      sources[base + __popc(peers & ((1u << lane) - 1))] = (uint32_t)p;
    }
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

// 2. One block: the n = tiles + 1 counts to exclusive starts in place
// (start[tiles] is then the number of entries), copied into `next`; in
// rounds of 4 consecutive counts a thread, each round's loads coalesced.
__global__ void __launch_bounds__(kScanThreads)
    splat_scan_kernel(int* __restrict__ start, int* __restrict__ next,
                      int n) {
  __shared__ int s_warp[32];
  int carry = 0;
  for (int base = 0; base < n; base += 4 * kScanThreads) {
    const int first = base + 4 * threadIdx.x;
    int v[4], sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = first + j < n ? start[first + j] : 0;
      sum += v[j];
    }
    int total;
    int run = carry + block_scan(sum, s_warp, total) - sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (first + j < n) start[first + j] = run;
      if (first + j < n - 1) next[first + j] = run;
      run += v[j];
    }
    carry += total;
  }
}

// The block sorts n keys ascending: a bitonic sort whose every comparison
// puts the smaller key first, so n need not be a power of two (the missing
// keys count as the largest and never move).
__device__ void sort_keys(uint32_t* key, int n) {
  int size = 1, log_size = 0;
  while (size < n) {
    size <<= 1;
    ++log_size;
  }
  for (int lk = 1; lk <= log_size; ++lk) {
    for (int lj = lk - 1; lj >= 0; --lj) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        // The first step of a merge compares mirrored pairs of each
        // 2^lk-block, the later ones pairs 2^lj apart.
        const int block = (t >> lj) << (lj + 1), off = t & ((1 << lj) - 1);
        const int lo = block + off;
        const int hi = lj == lk - 1 ? block + (2 << lj) - 1 - off
                                    : lo + (1 << lj);
        if (hi < n && key[lo] > key[hi]) {
          const uint32_t v = key[lo];
          key[lo] = key[hi];
          key[hi] = v;
        }
      }
      __syncthreads();
    }
  }
}

// Shared memory of kernels 4 and 5: the sorted source list (`capacity`
// keys), a chunk of it unpacked (one a thread: the mask of its corners in
// this tile, their accumulator offsets, the source, 16 bytes; the corners'
// weights, 16 bytes), the tile's f32 accumulators for a slab of up to
// `width` channels.
__host__ __device__ constexpr int tile_smem(int capacity, int threads,
                                            int width) {
  return capacity * 4 + threads * 32 + kTilePixels * width * 4;
}

// Loads the g of up to 8 unpacked sources [i0, i0 + 8) of a chunk of
// `chunk`, channel c (0 past C).
template <typename T>
__device__ __forceinline__ void load_sources(const T* __restrict__ g,
                                             const uint4* s_pack, int i0,
                                             int chunk, int C, int c,
                                             float (&v)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    v[u] = i0 + u < chunk && c < C
               ? to_float(g[(int64_t)s_pack[i0 + u].w * C + c])
               : 0.f;
  }
}

// One destination tile (one slab of its channels): its source list sorted
// by the source pixel's flat index (in shared memory, or in place in the
// workspace when it is longer than `capacity`), unpacked a chunk of
// blockDim sources at a time (each recomputes its corners with the count's
// f32 operations), each source's corners in this tile added into the
// tile's accumulators, then every element of the slab written once. Warp
// w < G takes channel group w for all 64 pixels, so each element is summed
// by one lane, from 0, over its sources in order, one rounding a product
// and one an add (__fmul_rn and __fadd_rn: no FMA contraction). A source
// adds to a destination pixel through one corner at most, so source order
// is the documented (source, corner) order, and a source's four
// accumulators are distinct: they are read, summed and written together.
// Each source's g is loaded once a warp, the next 8 sources' loads in
// flight while 8 are added.
template <typename T>
__device__ void sum_tile(const T* __restrict__ g, const float2* __restrict__ flow,
                         uint32_t* list, int n, int capacity,
                         unsigned char* smem, float* __restrict__ acc,
                         int tile, int slab, int groups, int H, int W, int C,
                         int tiles_h, int tiles_w) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* s_list = reinterpret_cast<uint32_t*>(smem);
  uint4* s_pack = reinterpret_cast<uint4*>(s_list + capacity);
  float4* s_w = reinterpret_cast<float4*>(s_pack + blockDim.x);
  float* s_acc = reinterpret_cast<float*>(s_w + blockDim.x);
  // The slab's channels, and whether this lane sums one of them.
  const int width = min(32 * groups, C - slab * 32 * groups);
  const bool summing = warp * 32 + lane < width;
  float* my_acc = s_acc + warp * 32 + lane;
  if (summing) {
    for (int q = 0; q < kTilePixels; ++q) my_acc[q * width] = 0.f;
  }
  uint32_t* sorted = list;
  if (n <= capacity) {
    for (int i = tid; i < n; i += blockDim.x) s_list[i] = list[i];
    sorted = s_list;
  }
  __syncthreads();
  sort_keys(sorted, n);

  const int c = slab * 32 * groups + warp * 32 + lane;
  for (int c0 = 0; c0 < n; c0 += blockDim.x) {
    const int chunk = min((int)blockDim.x, n - c0);
    __syncthreads();  // the previous chunk is summed
    if (tid < chunk) {
      const uint32_t p = sorted[c0 + tid];
      const Corners k = corners(p, flow, H, W, tiles_h, tiles_w);
      uint32_t mask = 0, off[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k.w[j] != 0.f && k.tile[j] == tile) {
          mask |= 1u << j;
          off[j] = (uint32_t)(k.pos[j] * width);
        }
      }
      s_pack[tid] = make_uint4(mask, off[0] | off[1] << 16,
                               off[2] | off[3] << 16, p);
      s_w[tid] = make_float4(k.w[0], k.w[1], k.w[2], k.w[3]);
    }
    __syncthreads();
    if (warp >= groups) continue;
    float v[8], next[8];
    load_sources(g, s_pack, 0, chunk, C, c, v);
    for (int i0 = 0; i0 < chunk; i0 += 8) {
      load_sources(g, s_pack, i0 + 8, chunk, C, c, next);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u >= chunk) break;
        const uint4 pk = s_pack[i0 + u];
        const float4 w4 = s_w[i0 + u];
        const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
        const uint32_t offs[4] = {pk.y & 0xffffu, pk.y >> 16, pk.z & 0xffffu,
                                  pk.z >> 16};
        const uint32_t mask = summing ? pk.x : 0u;
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (mask >> j & 1u) a[j] = my_acc[offs[j]];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (mask >> j & 1u) {
            my_acc[offs[j]] = __fadd_rn(a[j], __fmul_rn(wk[j], v[u]));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = next[u];
    }
  }
  __syncthreads();
  if (!summing) return;
  const int tx = tile % tiles_w;
  const int ty = (tile / tiles_w) % tiles_h;
  const int64_t b = tile / (tiles_w * tiles_h);
  for (int q = 0; q < kTilePixels; ++q) {
    const int y = ty * kTileH + q / kTileW, x = tx * kTileW + q % kTileW;
    if (y < H && x < W) acc[((b * H + y) * W + x) * C + c] = my_acc[q * width];
  }
}

// 4. A block of 32 G threads a (destination tile, slab of 32 G channels).
// A tile whose list is longer than kSortSources goes on the long list for
// kernel 5.
template <typename T>
__global__ void __launch_bounds__(kFixedThreads)
    splat_tile_sum_kernel(const T* __restrict__ g,
                          const float2* __restrict__ flow,
                          const int* __restrict__ start,
                          uint32_t* __restrict__ sources,
                          float* __restrict__ acc, int* __restrict__ longs,
                          int* __restrict__ long_count, int groups, int slabs,
                          int H, int W, int C, int tiles_h, int tiles_w) {
  extern __shared__ uint4 smem_words[];
  const int tile = blockIdx.x / slabs, slab = blockIdx.x % slabs;
  const int s = start[tile], n = start[tile + 1] - s;
  if (n > kSortSources) {
    if (slab == 0 && threadIdx.x == 0) {
      longs[atomicAdd(long_count, 1)] = tile;
    }
    return;
  }
  sum_tile(g, flow, sources + s, n, kSortSources,
           reinterpret_cast<unsigned char*>(smem_words), acc, tile, slab,
           groups, H, W, C, tiles_h, tiles_w);
}

// 5. The long tiles, a block of kLongThreads each in turn (all of them
// sort and unpack, G warps sum), slab after slab (a list sorted in place
// in the workspace is sorted by one block).
// The number of long tiles is read on the device.
template <typename T>
__global__ void __launch_bounds__(kLongThreads)
    splat_long_sum_kernel(const T* __restrict__ g,
                          const float2* __restrict__ flow,
                          const int* __restrict__ start,
                          uint32_t* __restrict__ sources,
                          float* __restrict__ acc,
                          const int* __restrict__ longs,
                          const int* __restrict__ long_count, int groups,
                          int slabs, int H, int W, int C, int tiles_h,
                          int tiles_w) {
  extern __shared__ uint4 smem_words[];
  const int count = *long_count;
  for (int l = blockIdx.x; l < count; l += gridDim.x) {
    const int tile = longs[l];
    const int s = start[tile], n = start[tile + 1] - s;
    for (int slab = 0; slab < slabs; ++slab) {
      sum_tile(g, flow, sources + s, n, kLongSources,
               reinterpret_cast<unsigned char*>(smem_words), acc, tile, slab,
               groups, H, W, C, tiles_h, tiles_w);
      __syncthreads();
    }
  }
}

// The workspace of the fixed-order route: the tiles' source lists (up to
// 4 entries a pixel, 4 bytes each), then each tile's start (tiles + 1
// ints), the long tiles' count (1), each tile's next free slot (tiles)
// and the long tiles' list (tiles).
struct FixedPlan {
  int64_t pixels, tiles;
  int tiles_h, tiles_w;
  FixedPlan(int B, int H, int W)
      : pixels((int64_t)B * H * W),
        tiles((int64_t)B * ((H + kTileH - 1) / kTileH) *
              ((W + kTileW - 1) / kTileW)),
        tiles_h((H + kTileH - 1) / kTileH),
        tiles_w((W + kTileW - 1) / kTileW) {}
  int64_t bytes() const { return 4 * (4 * pixels + 3 * tiles + 2); }
};

// Devices on which an instance's dynamic shared memory limit has been
// raised (after its first launch there); a device beyond them raises it on
// every launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int bytes, int device,
                       std::atomic<int>* raised) {
  const bool kept = device >= 0 && device < kMaxDevices;
  if (kept && raised[device].load(std::memory_order_relaxed) >= bytes) {
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && kept) {
    raised[device].store(bytes, std::memory_order_relaxed);
  }
  return err;
}

template <typename T>
int launch_splat_fixed(const void* g, const void* flow, void* acc,
                       void* workspace, int B, int H, int W, int C,
                       void* stream) {
  if (H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const FixedPlan plan(B, H, W);
  // Pixel indices and slots are 32-bit.
  if (4 * plan.pixels + 4 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // The channel groups of 32 a block's slab takes (at most 8), the slabs.
  const int all_groups = (C + 31) / 32;
  const int groups = all_groups < 8 ? all_groups : 8;
  const int slabs = (all_groups + groups - 1) / groups;
  if (plan.tiles * slabs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = 32 * groups;
  const int width = C < 32 * groups ? C : 32 * groups;
  const int smem = tile_smem(kSortSources, threads, width);
  const int long_smem = tile_smem(kLongSources, kLongThreads, width);
  static std::atomic<int> raised[kMaxDevices], long_raised[kMaxDevices];
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = raise_smem(splat_tile_sum_kernel<T>, smem, device, raised);
  }
  if (err == cudaSuccess) {
    err = raise_smem(splat_long_sum_kernel<T>, long_smem, device, long_raised);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* sources = static_cast<uint32_t*>(workspace);
  int* start = reinterpret_cast<int*>(sources + 4 * plan.pixels);
  int* long_count = start + plan.tiles + 1;
  int* next = long_count + 1;
  int* longs = next + plan.tiles;
  const float2* fl = static_cast<const float2*>(flow);
  const T* gt = static_cast<const T*>(g);
  float* out = static_cast<float*>(acc);
  const unsigned pixel_blocks =
      (unsigned)((plan.pixels + kFixedThreads - 1) / kFixedThreads);

  // The counts and the long tiles' count start at 0.
  err = cudaMemsetAsync(start, 0, (plan.tiles + 2) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  splat_index_kernel<false><<<pixel_blocks, kFixedThreads, 0, s>>>(
      fl, start, sources, plan.pixels, H, W, plan.tiles_h, plan.tiles_w);
  splat_scan_kernel<<<1, kScanThreads, 0, s>>>(start, next,
                                               (int)plan.tiles + 1);
  splat_index_kernel<true><<<pixel_blocks, kFixedThreads, 0, s>>>(
      fl, next, sources, plan.pixels, H, W, plan.tiles_h, plan.tiles_w);
  splat_tile_sum_kernel<T>
      <<<(unsigned)(plan.tiles * slabs), threads, smem, s>>>(
          gt, fl, start, sources, out, longs, long_count, groups, slabs, H,
          W, C, plan.tiles_h, plan.tiles_w);
  splat_long_sum_kernel<T><<<sms, kLongThreads, long_smem, s>>>(
      gt, fl, start, sources, out, longs, long_count, groups, slabs, H, W, C,
      plan.tiles_h, plan.tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// acc: (B, H, W, C) f32, every element written (need not be zeroed);
// workspace: fi_splat_fixed_workspace_bytes(B, H, W) bytes, 8-byte
// aligned, its contents free.
extern "C" long long fi_splat_fixed_workspace_bytes(int B, int H, int W) {
  return FixedPlan(B, H, W).bytes();
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
