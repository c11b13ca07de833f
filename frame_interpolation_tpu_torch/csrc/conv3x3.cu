// conv3x3 ('SAME') + bias + leaky-relu, with an optional fused 2x2 average
// pool, for Hopper (sm_90a), NHWC.
//
// Replaces two TPU kernels of the JAX package's feature extractor:
//   * _stack_kernel in frame_interpolation_tpu/ops/conv_stack.py (the C=64
//     second conv of sub-level 0 and its 2x2 pool; via conv_stack_flat /
//     extractor_stack);
//   * _flat_stack_kernel in frame_interpolation_tpu/ops/conv_stack_wide.py
//     (the C in {128, 256, 512} second convs with their pools, and the
//     rectangular first convs 128->256 and 256->512; via conv_flat /
//     wide_extractor_stack).
// Both compute y = leaky(conv(x, w) + b) with f32 accumulation and take the
// pool from the f32 values before y is rounded; so does this kernel.
//
// What bounds it on the H100: tensor-core FLOPs. The 62 conv sites of a
// 1080p pair are about 2.05 TFLOP against a few GB of traffic (hundreds of
// FLOPs per byte, above the card's ~295 FLOP/byte ridge for bf16).
//
// What the design does about it: an implicit GEMM with M = output pixels,
// N = Cout, K = 9 * Cin, so the work lands on the tensor cores with no
// im2col buffer in device memory. A block owns an 8 x 16 pixel tile (128
// rows of M) and 64 output channels; it walks K as 9 taps x Cin/32 steps,
// staging a 128 x 32 slice of shifted input pixels (zeros outside the
// image: the SAME padding) and a 32 x 64 slice of weights in shared memory.
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments with f32
// accumulators (8 warps, 32 x 32 each); f32 runs the same tiles on the
// CUDA cores in full f32, so it is exact to f32 rounding and not TF32. The
// epilogue stages the f32 tile in shared memory, adds bias, applies the
// activation, writes y, and, as tiles start at even rows and columns,
// pools each 2x2 window inside the block from the same f32 values. Loads
// are synchronous (no cp.async/TMA pipeline, no wgmma): a simple, correct
// first kernel; the pipelined Hopper version is later work.
//
// Weights come repacked by the caller as (3, 3, Cin, Cout) in the input
// dtype; bias is f32. Cin and Cout must be multiples of 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;   // output rows per block (even: pools in-block)
constexpr int kTileCols = 16;  // output columns per block (even)
constexpr int kBM = kTileRows * kTileCols;  // output pixels per block
constexpr int kBN = 64;                     // output channels per block
constexpr int kBK = 32;                     // input channels per K step
constexpr int kThreads = 256;
constexpr int kCStride = kBN + 4;  // f32 staging row stride (floats)

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

// Shared-memory tile strides, padded by one 16-byte vector per row so rows
// start in different banks (and stay 16-byte aligned for uint4 stores and
// 32-byte aligned for WMMA at every 16-row fragment).
template <typename T>
struct Tiles {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kAStride = kBK + kVec;
  static constexpr int kBStride = kBN + kVec;
  static constexpr int kABytes = kBM * kAStride * sizeof(T);
  static constexpr int kBBytes = kBK * kBStride * sizeof(T);
  static constexpr int kCBytes = kBM * kCStride * sizeof(float);
  static constexpr int kSmem =
      kABytes + kBBytes > kCBytes ? kABytes + kBBytes : kCBytes;
};

// The block's kBM x kBN accumulator and its per-K-step product.
template <typename T>
struct Accumulator;

// bf16: 8 warps as 4 (M) x 2 (N), each a 32 x 32 tile of 2 x 2 fragments.
template <>
struct Accumulator<__nv_bfloat16> {
  using T = __nv_bfloat16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void step(const T* As, const T* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(
            a[i], As + (wm * 32 + i * 16) * Tiles<T>::kAStride + kk,
            Tiles<T>::kAStride);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(
            b[j], Bs + kk * Tiles<T>::kBStride + wn * 32 + j * 16,
            Tiles<T>::kBStride);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
  }

  __device__ void store(float* Cs) {
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        nvcuda::wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * kCStride + wn * 32 + j * 16, acc[i][j],
            kCStride, nvcuda::wmma::mem_row_major);
      }
  }
};

// f32: each thread owns 8 pixels x 4 channels, in full f32 FMAs.
template <>
struct Accumulator<float> {
  float acc[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ void step(const float* As, const float* Bs) {
    const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(
          Bs + k * Tiles<float>::kBStride + tn * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(tm * 8 + i) * Tiles<float>::kAStride + k];
        acc[i][0] += a * b.x;
        acc[i][1] += a * b.y;
        acc[i][2] += a * b.z;
        acc[i][3] += a * b.w;
      }
    }
  }

  __device__ void store(float* Cs) {
    const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(tm * 8 + i) * kCStride + tn * 4 + j] = acc[i][j];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   T* __restrict__ pool, int H, int W, int Cin, int Cout,
                   int tiles_w, float slope) {
  using S = Tiles<T>;
  constexpr int kVec = S::kVec;
  __shared__ __align__(128) unsigned char smem[S::kSmem];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + S::kABytes);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * kTileRows;
  const int x0 = (blockIdx.x % tiles_w) * kTileCols;
  const int n0 = blockIdx.y * kBN;
  const int64_t img = blockIdx.z;
  const T* xb = x + img * H * (int64_t)W * Cin;

  Accumulator<T> acc;
  acc.zero();

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      // A: kBM shifted input pixels x kBK channels; zeros off the image.
      constexpr int kAParts = kBK / kVec;
      for (int i = tid; i < kBM * kAParts; i += kThreads) {
        const int m = i / kAParts, part = i % kAParts;
        const int yy = y0 + m / kTileCols + dy;
        const int xx = x0 + m % kTileCols + dx;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          v = *reinterpret_cast<const uint4*>(
              xb + ((int64_t)yy * W + xx) * Cin + c0 + part * kVec);
        }
        *reinterpret_cast<uint4*>(As + m * S::kAStride + part * kVec) = v;
      }
      // B: kBK input channels x kBN output channels of this tap.
      constexpr int kBParts = kBN / kVec;
      for (int i = tid; i < kBK * kBParts; i += kThreads) {
        const int k = i / kBParts, part = i % kBParts;
        const uint4 v = *reinterpret_cast<const uint4*>(
            w + ((int64_t)tap * Cin + c0 + k) * Cout + n0 + part * kVec);
        *reinterpret_cast<uint4*>(Bs + k * S::kBStride + part * kVec) = v;
      }
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
  }

  // Epilogue: f32 tile -> bias + leaky -> y; then the 2x2 pool of the
  // same f32 values.
  acc.store(Cs);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int m = i / kBN, n = i % kBN;
    const int yy = y0 + m / kTileCols, xx = x0 + m % kTileCols;
    float v = Cs[m * kCStride + n] + bias[n0 + n];
    v = v >= 0.f ? v : v * slope;
    Cs[m * kCStride + n] = v;
    if (yy < H && xx < W) {
      out[((img * H + yy) * W + xx) * Cout + n0 + n] = from_float<T>(v);
    }
  }
  if (pool != nullptr) {
    __syncthreads();
    const int Hp = H / 2, Wp = W / 2;
    constexpr int kPoolCols = kTileCols / 2;
    for (int i = tid; i < (kBM / 4) * kBN; i += kThreads) {
      const int pm = i / kBN, n = i % kBN;
      const int pr = pm / kPoolCols, pc = pm % kPoolCols;
      const int py = y0 / 2 + pr, px = x0 / 2 + pc;
      if (py < Hp && px < Wp) {
        const float* c = Cs + (2 * pr * kTileCols + 2 * pc) * kCStride + n;
        const float s = (c[0] + c[kCStride]) +
                        (c[kTileCols * kCStride] +
                         c[(kTileCols + 1) * kCStride]);
        pool[((img * Hp + py) * Wp + px) * Cout + n0 + n] =
            from_float<T>(0.25f * s);
      }
    }
  }
}

template <typename T>
int launch_conv(const void* x, const void* w, const void* bias, void* out,
                void* pool, int N, int H, int W, int Cin, int Cout,
                float slope, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin % kBK != 0 || Cout % kBN != 0 ||
      Cin < kBK || Cout < kBN || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_w = (W + kTileCols - 1) / kTileCols;
  const int tiles_h = (H + kTileRows - 1) / kTileRows;
  const dim3 grid(tiles_w * tiles_h, Cout / kBN, N);
  conv3x3_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out),
      static_cast<T*>(pool), H, W, Cin, Cout, tiles_w, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fi_conv3x3_bf16(const void* x, const void* w, const void* bias,
                               void* out, void* pool, int N, int H, int W,
                               int Cin, int Cout, float slope, void* stream) {
  return launch_conv<__nv_bfloat16>(x, w, bias, out, pool, N, H, W, Cin, Cout,
                                    slope, stream);
}

extern "C" int fi_conv3x3_f32(const void* x, const void* w, const void* bias,
                              void* out, void* pool, int N, int H, int W,
                              int Cin, int Cout, float slope, void* stream) {
  return launch_conv<float>(x, w, bias, out, pool, N, H, W, Cin, Cout, slope,
                            stream);
}
