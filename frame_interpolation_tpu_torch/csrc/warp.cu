// Backward bilinear warp for Hopper (sm_90a), NHWC, and its derivative
// planes.
//
// Replaces the TPU window warp of the JAX package: _warp_window_kernel in
// frame_interpolation_tpu/ops/warp_window.py, in both of its modes. The
// primal mode (emit_planes off, reached through _forward /
// backward_warp_window) is fi_warp_*; the planes mode (emit_planes on,
// reached through the window VJP's _bwd) is fi_warp_planes_*; the primal
// on a slab of output rows (_forward with row_offset and clamp_h, reached
// through backward_warp_window_rows) is fi_warp_rows_*. fi_warp_into_* is
// the primal written into a slice of channels of a wider buffer (below).
//
//   out[b, y, x, c] = bilerp(image[b], y + flow[b,y,x,1], x + flow[b,y,x,0])
//
// with the tfa clamp rule of ops/warp.py _query_coords_full: f32 query
// coordinates, floor clamped to [0, size-2], alpha clamped to [0, 1]. The
// blend (1-ay)*((1-ax)*t00 + ax*t01) + ay*((1-ax)*t10 + ax*t11) runs in f32
// and rounds once to the image dtype, as the TPU kernel does.
//
// What bounds it on the H100: bytes. A warp reads four C-vectors and the
// flow and writes one C-vector per pixel, with about one FLOP per byte; the
// 22 warps of a 1080p pair move about 5.5 GB of compulsory traffic, some
// 1.6 ms at 3.35 TB/s. The four taps of nearby pixels overlap, so most tap
// reads hit L1 or L2 for smooth flow; what the kernel must get right is
// that every warp-wide load and store uses whole sectors.
//
// What the design does about it: the TPU kernel's windows and planar
// layout exist to get taps into VMEM; here the image stays NHWC, so each
// tap is one contiguous C-vector in device memory, and the kernel has two
// routes over it.
//  * Vector route, where C and the output's pitch are multiples of the
//    16-byte vector (8 bf16 or 4 f32: the flow estimator's C = 64 ... 960
//    and the fusion's feature warps) and the pointers are 16-byte aligned:
//    one thread per output pixel and 16-byte piece of channels, one uint4
//    load per tap; neighbouring threads read neighbouring pieces of one
//    tap.
//  * Run route, for every other C (the fusion's image warps, C = 3; the
//    training step's image+feature warps, C = 67, 195, 451, 963): a block
//    of 128 threads takes a run of up to 32 consecutive output pixels,
//    computes each pixel's tap offset and alphas once into shared memory,
//    and its threads then stride over the run's flat (pixel, channel)
//    elements, two consecutive elements a thread. A warp's lanes read
//    consecutive channels of a tap (one or two contiguous pieces where the
//    warp straddles two pixels), and its stores are one contiguous piece
//    of the output where the run's output is contiguous in NHWC. A pair
//    of elements is stored as one where its two outputs are adjacent and
//    the first is pair-aligned, else as two: into a slice (below) a pair
//    that spans two pixels, or starts at an odd channel, is two stores.
//    Taps at odd C lie at any alignment, so the loads are one element
//    wide; in bf16 the route runs eight times the vector route's load
//    instructions for the same bytes, and that, not the bytes, is what it
//    runs into first.
//
// Slice mode (fi_warp_into_*): the output is channels [k, k + C) of a
// buffer of `pitch` channels a pixel, and the launch writes those and no
// others: the fusion's input (models/film_net.py) is one buffer a level
// whose channel slices the warps of both frames' features and images
// write in place, so no concat copies them again. The store of pixel p's
// channel c goes to out + p * pitch + c, `out` pointing at channel k of
// pixel 0; every other mode has pitch = C. At the fusion's layout the
// feature slices start on 16-byte boundaries and the pitch is a multiple
// of 8, so the feature warps take the vector route.
//
// Row mode: the row-sharded forward (ops/warp.py backward_warp_rows) warps
// each shard's slab of H_out output rows, whose first row is global row
// row_offset, against the frame's clamp_h rows as n_slabs slabs of
// slab_rows rows each, one per shard: a table of the slabs' addresses,
// passed in the kernel's parameters, so a captured graph reads every
// shard's slab where it lies and no rows are copied or exchanged. The JAX
// kernel takes a halo or the whole frame, chosen by the flow's reach
// (lax.pmax + cond); a tap here finds its row's slab itself, so there is
// no reach and no branch. Queries are computed and clamped in global
// coordinates, so they are the whole-frame warp's bit for bit; a tap's
// two rows may lie in two slabs, so each pixel keeps the offsets of its
// top and bottom tap rows. The same routes and the same bytes per output
// pixel as the whole-frame warp, which is this mode with one slab of H
// rows and H_out = clamp_h = H.
//
// Planes mode: the flow-derivative planes of the warp, for the training
// backward (ops/warp.py flow_cotangent_from_planes reduces them against
// the cotangent):
//
//   du = ((1-ay)*(t01-t00) + ay*(t11-t10)) * cg(tx)      d out / d flow_x
//   dv = (bot - top) * cg(ty)                            d out / d flow_y
//
// with top/bot the forward's row blends and cg JAX's clip gradient of the
// RAW (pre-clip) offsets tx = qx - floor_clamped(qx), ty likewise: 1 inside
// (0, 1), 0.5 at exactly 0 or 1 (lax min/max tie rule), 0 outside. The
// same taps and routes as the primal, two outputs; f32 math, one rounding
// to the image dtype per plane. It moves 1.5x the primal's bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bilinear.cuh"

namespace {

// Vector route: threads a block.
constexpr int kVectorThreads = 256;
// Run route: threads a block, at most kMaxRun output pixels a block and
// about kRunElements (pixel, channel) elements, so wide C still gives many
// blocks. A thread takes pairs of consecutive elements and starts the loads
// of kUnroll pairs before it computes either.
constexpr int kRunThreads = 128;
constexpr int kMaxRun = 32;
constexpr int kRunElements = 4096;
constexpr int kUnroll = 2;

// The most slabs of a row-mode launch.
constexpr int kMaxSlabs = 16;

// The rows of a launch (see Row mode above).
struct Rows {
  int h_out;       // rows of the flow and the output
  int row_offset;  // global row of the output's first row
  int clamp_h;     // global rows the taps clamp to: n_slabs * slab_rows
  int slab_rows;   // rows of a slab, (B, slab_rows, W, C) each
  int n_slabs;
  int64_t slab[kMaxSlabs];  // each slab's offset from slab 0, in elements
};

// Output pixel p of the flat (B * h_out * W) range: the query at its
// global row, and the offsets from slab 0 of its top-left tap and of the
// tap below it.
struct Pixel {
  Query q;
  int64_t tap, below;
};

// Offset from slab 0 of global row `y`, column `x`, of plane b.
__device__ __forceinline__ int64_t row_at(const Rows& r, int64_t b, int y,
                                          int x, int W, int C) {
  const int s = y / r.slab_rows;
  return r.slab[s] +
         ((b * r.slab_rows + (y - s * r.slab_rows)) * W + x) * (int64_t)C;
}

__device__ __forceinline__ Pixel locate(int64_t p, const float2* flow,
                                        const Rows& r, int W, int C) {
  const int x = (int)(p % W);
  const int64_t by = p / W;
  const int y = (int)(by % r.h_out);
  const int64_t b = by / r.h_out;
  Pixel px;
  px.q = query(y + r.row_offset, x, flow[p], r.clamp_h, W);
  px.tap = row_at(r, b, px.q.iy, px.q.ix, W, C);
  px.below = row_at(r, b, px.q.iy + 1, px.q.ix, W, C);
  return px;
}

// One element as f32, through the read-only path.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Stores two consecutive elements at an address aligned to the pair,
// rounding each once.
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ float blend(float ax, float ay, float t00,
                                       float t01, float t10, float t11) {
  return (1.f - ay) * ((1.f - ax) * t00 + ax * t01) +
         ay * ((1.f - ax) * t10 + ax * t11);
}

// d clip(t, 0, 1) / dt with JAX's tie rule.
__device__ __forceinline__ float clip_grad(float t) {
  if (t > 0.f && t < 1.f) return 1.f;
  return (t == 0.f || t == 1.f) ? 0.5f : 0.f;
}

__device__ __forceinline__ float plane_du(float ay, float t00, float t01,
                                          float t10, float t11) {
  return (1.f - ay) * (t01 - t00) + ay * (t11 - t10);
}

__device__ __forceinline__ float plane_dv(float ax, float t00, float t01,
                                          float t10, float t11) {
  return ((1.f - ax) * t10 + ax * t11) - ((1.f - ax) * t00 + ax * t01);
}

// Vector route: C is a multiple of the 16-byte vector and the pointers are
// 16-byte aligned, so every piece is one uint4 load per tap.
// kPlanes: write du to `out` and dv to `dv_out` instead of the warp.
template <typename T, bool kPlanes>
__global__ void __launch_bounds__(kVectorThreads)
    warp_vector_kernel(const T* __restrict__ image,
                       const float2* __restrict__ flow, T* __restrict__ out,
                       T* __restrict__ dv_out, Rows rows, int W, int C,
                       int pitch, int pieces, int64_t total) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int piece = (int)(idx % pieces);
  const int64_t p = idx / pieces;  // output pixel: (b * h_out + y) * W + x
  const Pixel px = locate(p, flow, rows, W, C);
  const Query& q = px.q;
  const float cgx = kPlanes ? clip_grad(q.tx) : 0.f;
  const float cgy = kPlanes ? clip_grad(q.ty) : 0.f;

  const int c0 = piece * kVec;
  const T* t00 = image + px.tap + c0;
  const uint4 v00 = *reinterpret_cast<const uint4*>(t00);
  const uint4 v01 = *reinterpret_cast<const uint4*>(t00 + C);
  const T* t10 = image + px.below + c0;
  const uint4 v10 = *reinterpret_cast<const uint4*>(t10);
  const uint4 v11 = *reinterpret_cast<const uint4*>(t10 + C);
  const T* e00 = reinterpret_cast<const T*>(&v00);
  const T* e01 = reinterpret_cast<const T*>(&v01);
  const T* e10 = reinterpret_cast<const T*>(&v10);
  const T* e11 = reinterpret_cast<const T*>(&v11);
  uint4 r, rv;
  T* er = reinterpret_cast<T*>(&r);
  T* ev = reinterpret_cast<T*>(&rv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float s00 = to_float(e00[j]), s01 = to_float(e01[j]);
    const float s10 = to_float(e10[j]), s11 = to_float(e11[j]);
    if (kPlanes) {
      er[j] = from_float<T>(plane_du(q.ay, s00, s01, s10, s11) * cgx);
      ev[j] = from_float<T>(plane_dv(q.ax, s00, s01, s10, s11) * cgy);
    } else {
      er[j] = from_float<T>(blend(q.ax, q.ay, s00, s01, s10, s11));
    }
  }
  *reinterpret_cast<uint4*>(out + p * pitch + c0) = r;
  if (kPlanes) *reinterpret_cast<uint4*>(dv_out + p * pitch + c0) = rv;
}

// Run route: block `blockIdx.x` takes output pixels [p0, p0 + run) of the
// flat (B*H*W) pixel range, `run` even; any C. A thread takes pairs of
// consecutive elements (e, e+1), e even, which share their address
// arithmetic and one aligned two-element store; the second element is the
// next channel of the same pixel, or channel 0 of the next pixel where the
// pair spans two (a select, not a branch, so the warp does not diverge).
// Where the output is contiguous (pitch = C, `out` pair-aligned: every mode
// but the slice) element e of the run lies at p0 * C + e. Into a slice
// (kPitched) the outputs of element (i, c) lie at (p0 + i) * pitch + c; a
// pair whose two outputs are adjacent and whose first is pair-aligned
// takes one store, any other pair two. The contiguous form is kept apart
// because the slice's address arithmetic costs the run route up to 16%
// on an H100 (1088x1920x67 bf16), whose one-element loads leave it no
// slack.
struct alignas(16) RunPixel {
  int64_t tap, below;  // offsets of the top-left tap and the tap below it
  float ax, ay;
};

template <typename T, bool kPlanes, bool kPitched>
__global__ void __launch_bounds__(kRunThreads)
    warp_run_kernel(const T* __restrict__ image,
                    const float2* __restrict__ flow, T* __restrict__ out,
                    T* __restrict__ dv_out, Rows rows, int W, int C,
                    int pitch, int64_t pixels, int run) {
  static_assert(!(kPlanes && kPitched), "the planes are contiguous");
  __shared__ RunPixel s_px[kMaxRun];
  __shared__ float2 s_cg[kPlanes ? kMaxRun : 1];  // clip gradients (x, y)
  const int tid = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = (int)(pixels - p0 < run ? pixels - p0 : run);
  if (tid < n) {
    const Pixel px = locate(p0 + tid, flow, rows, W, C);
    s_px[tid] = RunPixel{px.tap, px.below, px.q.ax, px.q.ay};
    if (kPlanes) {
      s_cg[tid] = make_float2(clip_grad(px.q.tx), clip_grad(px.q.ty));
    }
  }
  __syncthreads();

  const int total = n * C;
  T* o = out + p0 * C;
  T* v = kPlanes ? dv_out + p0 * C : nullptr;
  FlatWalk walk(2 * tid, 2 * kRunThreads, C);
  for (int e0 = 2 * tid; e0 < total; e0 += 2 * kUnroll * kRunThreads) {
    int px[kUnroll], qx[kUnroll];  // the pixels of the pair's elements
    int cx[kUnroll];               // the channel of its first element
    float2 t[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = e0 + 2 * u * kRunThreads < total;
      const int c = walk.c;
      cx[u] = c;
      px[u] = min(walk.i, n - 1);
      qx[u] = c + 1 < C ? px[u] : min(px[u] + 1, n - 1);
      walk.next();
      const int64_t a = s_px[px[u]].tap + c;
      const int64_t b = c + 1 < C ? a + 1 : s_px[qx[u]].tap;
      const int64_t a2 = s_px[px[u]].below + c;
      const int64_t b2 = c + 1 < C ? a2 + 1 : s_px[qx[u]].below;
      const int64_t first[4] = {a, a + C, a2, a2 + C};
      const int64_t second[4] = {b, b + C, b2, b2 + C};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        t[u][k] = live ? make_float2(load1(image + first[k]),
                                     load1(image + second[k]))
                       : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + 2 * u * kRunThreads;
      if (e >= total) continue;
      const RunPixel P = s_px[px[u]], Q = s_px[qx[u]];
      float2 r, rv;
      if (kPlanes) {
        const float2 g = s_cg[px[u]], h = s_cg[qx[u]];
        r.x = plane_du(P.ay, t[u][0].x, t[u][1].x, t[u][2].x, t[u][3].x) *
              g.x;
        r.y = plane_du(Q.ay, t[u][0].y, t[u][1].y, t[u][2].y, t[u][3].y) *
              h.x;
        rv.x = plane_dv(P.ax, t[u][0].x, t[u][1].x, t[u][2].x, t[u][3].x) *
               g.y;
        rv.y = plane_dv(Q.ax, t[u][0].y, t[u][1].y, t[u][2].y, t[u][3].y) *
               h.y;
      } else {
        r.x = blend(P.ax, P.ay, t[u][0].x, t[u][1].x, t[u][2].x, t[u][3].x);
        r.y = blend(Q.ax, Q.ay, t[u][0].y, t[u][1].y, t[u][2].y, t[u][3].y);
      }
      const bool two = e + 1 < total;  // the pair's second element is live
      if constexpr (kPitched) {
        const int64_t a = (p0 + px[u]) * pitch + cx[u];
        const int64_t b = cx[u] + 1 < C ? a + 1 : (p0 + qx[u]) * pitch;
        if (two && b == a + 1 &&
            reinterpret_cast<uintptr_t>(out + a) % (2 * sizeof(T)) == 0) {
          store2(out + a, r);
        } else {
          out[a] = from_float<T>(r.x);
          if (two) out[b] = from_float<T>(r.y);
        }
      } else if (two) {
        store2(o + e, r);
        if (kPlanes) store2(v + e, rv);
      } else {
        o[e] = from_float<T>(r.x);
        if (kPlanes) v[e] = from_float<T>(rv.x);
      }
    }
  }
}

// dv_out is NULL for the warp and the dv plane for the planes mode (where
// `out` takes du). `pitch`: elements from one output pixel to the next.
template <typename T, bool kPlanes>
int launch_warp(const void* image, const void* flow, void* out, void* dv_out,
                int B, Rows rows, int W, int C, int pitch, void* stream) {
  if (rows.clamp_h < 2 || W < 2 || C < 1 || B < 1 || rows.h_out < 1 ||
      pitch < C ||
      rows.row_offset < 0 || rows.row_offset + rows.h_out > rows.clamp_h ||
      rows.n_slabs < 1 || rows.n_slabs > kMaxSlabs || rows.slab_rows < 1 ||
      (int64_t)rows.n_slabs * rows.slab_rows != rows.clamp_h) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kVec = 16 / sizeof(T);
  const T* in = static_cast<const T*>(image);
  const float2* fl = static_cast<const float2*>(flow);
  T* o = static_cast<T*>(out);
  T* v = static_cast<T*>(dv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t pixels = (int64_t)B * rows.h_out * W;
  bool slabs_aligned = true;
  for (int k = 0; k < rows.n_slabs; ++k) {
    slabs_aligned = slabs_aligned &&
        (reinterpret_cast<uintptr_t>(in + rows.slab[k]) % 16 == 0);
  }
  const bool vector = C % kVec == 0 && pitch % kVec == 0 && slabs_aligned &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dv_out) % 16 == 0;
  if (vector) {
    const int pieces = C / kVec;
    const int64_t total = pixels * pieces;
    const int64_t blocks = (total + kVectorThreads - 1) / kVectorThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    warp_vector_kernel<T, kPlanes><<<(unsigned)blocks, kVectorThreads, 0, s>>>(
        in, fl, o, v, rows, W, C, pitch, pieces, total);
  } else {
    // The contiguous form stores aligned pairs: p0 * C is even and so
    // must be the outputs' addresses in elements (the wrapper's fresh
    // tensors are). The planes take no other form.
    const bool pairs =
        reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0 &&
        reinterpret_cast<uintptr_t>(dv_out) % (2 * sizeof(T)) == 0;
    if (C > 0x7fffffff / kMaxRun || (kPlanes && (pitch != C || !pairs))) {
      return (int)cudaErrorInvalidValue;
    }
    const int run = std::max(2, std::min(kMaxRun, kRunElements / C)) & ~1;
    const int64_t blocks = (pixels + run - 1) / run;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (pitch == C && pairs) {
      warp_run_kernel<T, kPlanes, false>
          <<<(unsigned)blocks, kRunThreads, 0, s>>>(in, fl, o, v, rows, W, C,
                                                    pitch, pixels, run);
    } else if constexpr (!kPlanes) {
      warp_run_kernel<T, false, true>
          <<<(unsigned)blocks, kRunThreads, 0, s>>>(in, fl, o, v, rows, W, C,
                                                    pitch, pixels, run);
    }
  }
  return (int)cudaGetLastError();
}

// A whole frame: one slab, whose rows are the output's and the clamp's.
Rows frame_rows(int H) {
  Rows r{};
  r.h_out = r.clamp_h = r.slab_rows = H;
  r.n_slabs = 1;
  return r;
}

// The row mode's table of slabs, as offsets in elements from slab 0.
template <typename T>
int rows_of(const void* const* slabs, int n_slabs, int slab_rows, int H_out,
            int row_offset, int clamp_h, Rows* r) {
  if (slabs == nullptr || n_slabs < 1 || n_slabs > kMaxSlabs) {
    return (int)cudaErrorInvalidValue;
  }
  *r = Rows{};
  r->h_out = H_out;
  r->row_offset = row_offset;
  r->clamp_h = clamp_h;
  r->slab_rows = slab_rows;
  r->n_slabs = n_slabs;
  const char* base = static_cast<const char*>(slabs[0]);
  for (int k = 0; k < n_slabs; ++k) {
    if (slabs[k] == nullptr) return (int)cudaErrorInvalidValue;
    const int64_t bytes = static_cast<const char*>(slabs[k]) - base;
    if (bytes % (int64_t)sizeof(T) != 0) return (int)cudaErrorInvalidValue;
    r->slab[k] = bytes / (int64_t)sizeof(T);
  }
  return 0;
}

template <typename T>
int launch_warp_rows(const void* const* slabs, int n_slabs, int slab_rows,
                     const void* flow, void* out, int B, int H_out, int W,
                     int C, int row_offset, int clamp_h, void* stream) {
  Rows rows;
  const int code = rows_of<T>(slabs, n_slabs, slab_rows, H_out, row_offset,
                              clamp_h, &rows);
  if (code != 0) return code;
  return launch_warp<T, false>(slabs[0], flow, out, nullptr, B, rows, W, C,
                               C, stream);
}

}  // namespace

extern "C" int fi_warp_bf16(const void* image, const void* flow, void* out,
                            int B, int H, int W, int C, void* stream) {
  return launch_warp<__nv_bfloat16, false>(image, flow, out, nullptr, B,
                                           frame_rows(H), W, C, C, stream);
}

extern "C" int fi_warp_f32(const void* image, const void* flow, void* out,
                           int B, int H, int W, int C, void* stream) {
  return launch_warp<float, false>(image, flow, out, nullptr, B,
                                   frame_rows(H), W, C, C, stream);
}

// Slice mode: `out` points at the slice's first channel of pixel 0 of a
// buffer with out_pitch >= C channels a pixel; only the slice is written.
extern "C" int fi_warp_into_bf16(const void* image, const void* flow,
                                 void* out, int out_pitch, int B, int H,
                                 int W, int C, void* stream) {
  return launch_warp<__nv_bfloat16, false>(image, flow, out, nullptr, B,
                                           frame_rows(H), W, C, out_pitch,
                                           stream);
}

extern "C" int fi_warp_into_f32(const void* image, const void* flow,
                                void* out, int out_pitch, int B, int H,
                                int W, int C, void* stream) {
  return launch_warp<float, false>(image, flow, out, nullptr, B,
                                   frame_rows(H), W, C, out_pitch, stream);
}

// slabs: a host array of n_slabs device pointers, each slab (B, slab_rows,
// W, C); the frame is their rows in order, n_slabs * slab_rows = clamp_h.
extern "C" int fi_warp_rows_bf16(const void* const* slabs, int n_slabs,
                                 int slab_rows, const void* flow, void* out,
                                 int B, int H_out, int W, int C,
                                 int row_offset, int clamp_h, void* stream) {
  return launch_warp_rows<__nv_bfloat16>(slabs, n_slabs, slab_rows, flow,
                                         out, B, H_out, W, C, row_offset,
                                         clamp_h, stream);
}

extern "C" int fi_warp_rows_f32(const void* const* slabs, int n_slabs,
                                int slab_rows, const void* flow, void* out,
                                int B, int H_out, int W, int C,
                                int row_offset, int clamp_h, void* stream) {
  return launch_warp_rows<float>(slabs, n_slabs, slab_rows, flow, out, B,
                                 H_out, W, C, row_offset, clamp_h, stream);
}

extern "C" int fi_warp_planes_bf16(const void* image, const void* flow,
                                   void* du, void* dv, int B, int H, int W,
                                   int C, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_warp<__nv_bfloat16, true>(image, flow, du, dv, B,
                                          frame_rows(H), W, C, C, stream);
}

extern "C" int fi_warp_planes_f32(const void* image, const void* flow,
                                  void* du, void* dv, int B, int H, int W,
                                  int C, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_warp<float, true>(image, flow, du, dv, B, frame_rows(H), W,
                                  C, C, stream);
}

extern "C" const char* fi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
