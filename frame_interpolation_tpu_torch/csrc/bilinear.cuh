// Helpers shared by warp.cu and splat.cu: dtype conversions, the warp's
// query under the tfa clamp rule, and the walk over the flat (pixel,
// channel) elements of a run that warp.cu's run route takes.
#pragma once

#include <cuda_bf16.h>
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

// The warp's query at output pixel (y, x) under flow f = (dx, dy), as
// ops/warp.py _query_coords_full computes it: f32 query coordinates, the
// top-left corner (iy, ix) with the floor clamped to [0, size-2], the
// alphas clamped to [0, 1], and the raw pre-clip offsets (ty, tx).
struct Query {
  int iy, ix;
  float ay, ax, ty, tx;
};

__device__ __forceinline__ Query query(int y, int x, float2 f, int H, int W) {
  const float qx = (float)x + f.x;
  const float qy = (float)y + f.y;
  const float fx = fminf(fmaxf(floorf(qx), 0.f), (float)(W - 2));
  const float fy = fminf(fmaxf(floorf(qy), 0.f), (float)(H - 2));
  Query q;
  q.ix = (int)fx;
  q.iy = (int)fy;
  q.tx = qx - fx;
  q.ty = qy - fy;
  q.ax = fminf(fmaxf(q.tx, 0.f), 1.f);
  q.ay = fminf(fmaxf(q.ty, 0.f), 1.f);
  return q;
}

// A run of n pixels with C channels each is the flat range [0, n*C) of
// elements e = i*C + c. A thread that starts at e = tid and strides by the
// block's size keeps (i, c) and advances both without a division:
// di = stride / C, dc = stride % C, set once.
struct FlatWalk {
  int i, c, di, dc, C;

  __device__ __forceinline__ FlatWalk(int start, int stride, int C_)
      : i(start / C_), c(start % C_), di(stride / C_), dc(stride % C_),
        C(C_) {}

  __device__ __forceinline__ void next() {
    c += dc;
    i += di;
    if (c >= C) {
      c -= C;
      ++i;
    }
  }
};

}  // namespace
