// Backward bilinear warp for Hopper (sm_90a), NHWC, and its derivative
// planes.
//
// Replaces the TPU window warp of the JAX package: _warp_window_kernel in
// frame_interpolation_tpu/ops/warp_window.py, in both of its modes. The
// primal mode (emit_planes off, reached through _forward /
// backward_warp_window) is fi_warp_*; the planes mode (emit_planes on,
// reached through the window VJP's _bwd) is fi_warp_planes_*.
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
// 1.6 ms at 3.35 TB/s.
//
// What the design does about it: the TPU kernel's windows and planar
// layout exist to get taps into VMEM; here the image stays NHWC, so each
// tap is one contiguous C-vector in device memory. One thread handles one
// output pixel and 16 bytes of channels (8 bf16 or 4 f32): neighbouring
// threads read neighbouring 16-byte pieces of the same tap, so the loads
// coalesce, and the four taps of nearby pixels mostly hit L2 for smooth
// flow. The coordinate math is repeated per 16-byte piece (a few FLOPs,
// free under the byte bound). Channel counts that are not a multiple of
// the vector (C = 67, 195, ... on the fusion's image+feature warps) take
// the same mapping with scalar loads.
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
// same taps and mapping as the primal, two outputs; f32 math, one rounding
// to the image dtype per plane. It moves 1.5x the primal's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

// kVector: C is a multiple of the 16-byte vector and the pointers are
// 16-byte aligned, so every piece is one uint4 load per tap.
// kPlanes: write du to `out` and dv to `dv_out` instead of the warp.
template <typename T, bool kVector, bool kPlanes>
__global__ void __launch_bounds__(256)
    warp_kernel(const T* __restrict__ image, const float2* __restrict__ flow,
                T* __restrict__ out, T* __restrict__ dv_out, int H, int W,
                int C, int pieces, int64_t total) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int piece = (int)(idx % pieces);
  const int64_t p = idx / pieces;  // output pixel: (b * H + y) * W + x
  const int x = (int)(p % W);
  const int64_t by = p / W;
  const int y = (int)(by % H);
  const int64_t b = by / H;

  const float2 f = flow[p];
  const float qx = (float)x + f.x;
  const float qy = (float)y + f.y;
  const float fx = fminf(fmaxf(floorf(qx), 0.f), (float)(W - 2));
  const float fy = fminf(fmaxf(floorf(qy), 0.f), (float)(H - 2));
  const float ax = fminf(fmaxf(qx - fx, 0.f), 1.f);
  const float ay = fminf(fmaxf(qy - fy, 0.f), 1.f);
  const float cgx = kPlanes ? clip_grad(qx - fx) : 0.f;
  const float cgy = kPlanes ? clip_grad(qy - fy) : 0.f;

  const int c0 = piece * kVec;
  const T* t00 = image + ((b * H + (int)fy) * W + (int)fx) * C + c0;
  const T* t01 = t00 + C;
  const T* t10 = t00 + (int64_t)W * C;
  const T* t11 = t10 + C;
  T* o = out + p * C + c0;
  T* v = kPlanes ? dv_out + p * C + c0 : nullptr;

  if (kVector) {
    const uint4 v00 = *reinterpret_cast<const uint4*>(t00);
    const uint4 v01 = *reinterpret_cast<const uint4*>(t01);
    const uint4 v10 = *reinterpret_cast<const uint4*>(t10);
    const uint4 v11 = *reinterpret_cast<const uint4*>(t11);
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
        er[j] = from_float<T>(plane_du(ay, s00, s01, s10, s11) * cgx);
        ev[j] = from_float<T>(plane_dv(ax, s00, s01, s10, s11) * cgy);
      } else {
        er[j] = from_float<T>(blend(ax, ay, s00, s01, s10, s11));
      }
    }
    *reinterpret_cast<uint4*>(o) = r;
    if (kPlanes) *reinterpret_cast<uint4*>(v) = rv;
  } else {
    const int n = min(kVec, C - c0);
    for (int j = 0; j < n; ++j) {
      const float s00 = to_float(t00[j]), s01 = to_float(t01[j]);
      const float s10 = to_float(t10[j]), s11 = to_float(t11[j]);
      if (kPlanes) {
        o[j] = from_float<T>(plane_du(ay, s00, s01, s10, s11) * cgx);
        v[j] = from_float<T>(plane_dv(ax, s00, s01, s10, s11) * cgy);
      } else {
        o[j] = from_float<T>(blend(ax, ay, s00, s01, s10, s11));
      }
    }
  }
}

// dv_out is NULL for the warp and the dv plane for the planes mode (where
// `out` takes du).
template <typename T>
int launch_warp(const void* image, const void* flow, void* out, void* dv_out,
                int B, int H, int W, int C, void* stream) {
  if (H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const int pieces = (C + kVec - 1) / kVec;
  const int64_t total = (int64_t)B * H * W * pieces;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vector = C % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(image) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dv_out) % 16 == 0;
  const T* in = static_cast<const T*>(image);
  const float2* fl = static_cast<const float2*>(flow);
  T* o = static_cast<T*>(out);
  T* v = static_cast<T*>(dv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (v == nullptr) {
    if (vector) {
      warp_kernel<T, true, false><<<grid, kThreads, 0, s>>>(
          in, fl, o, v, H, W, C, pieces, total);
    } else {
      warp_kernel<T, false, false><<<grid, kThreads, 0, s>>>(
          in, fl, o, v, H, W, C, pieces, total);
    }
  } else if (vector) {
    warp_kernel<T, true, true><<<grid, kThreads, 0, s>>>(
        in, fl, o, v, H, W, C, pieces, total);
  } else {
    warp_kernel<T, false, true><<<grid, kThreads, 0, s>>>(
        in, fl, o, v, H, W, C, pieces, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fi_warp_bf16(const void* image, const void* flow, void* out,
                            int B, int H, int W, int C, void* stream) {
  return launch_warp<__nv_bfloat16>(image, flow, out, nullptr, B, H, W, C,
                                    stream);
}

extern "C" int fi_warp_f32(const void* image, const void* flow, void* out,
                           int B, int H, int W, int C, void* stream) {
  return launch_warp<float>(image, flow, out, nullptr, B, H, W, C, stream);
}

extern "C" int fi_warp_planes_bf16(const void* image, const void* flow,
                                   void* du, void* dv, int B, int H, int W,
                                   int C, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_warp<__nv_bfloat16>(image, flow, du, dv, B, H, W, C, stream);
}

extern "C" int fi_warp_planes_f32(const void* image, const void* flow,
                                  void* du, void* dv, int B, int H, int W,
                                  int C, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_warp<float>(image, flow, du, dv, B, H, W, C, stream);
}

extern "C" const char* fi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
