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
// The sum order is not deterministic, so checks use tolerances. Offsets
// into g and acc are 64-bit.
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
