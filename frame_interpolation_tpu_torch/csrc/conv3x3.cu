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
// pool from the f32 values before y is rounded; so does this kernel, and
// each output rounds once to x's dtype.
//
// What bounds it on the H100: tensor-core FLOPs at every site but one. A
// site is 2 * H * W * 9 * Cin * Cout FLOPs; the 62 sites of a 1080p pair are
// about 2.05 TFLOP, about 2.1 ms at 989 TFLOP/s (dense bf16), against a few
// GB of traffic. The exception is the 64->64 + pool site at 1088x1920: 154
// GFLOP (0.156 ms) but 0.60 GB in and out (0.180 ms at 3.35 TB/s), so bytes
// bound it. In f32 the train step's 62 sites are about 515 GFLOP: about 1.0
// ms at 495 TFLOP/s in TF32, 7.7 ms at 67 TFLOP/s in exact f32.
//
// What the design does about it: an implicit GEMM with M = output pixels,
// N = Cout and K = 9 * Cin, walked tap by tap and then channel chunk by
// channel chunk, on the tensor cores through wgmma with no im2col buffer:
//   * A block owns an 8 x 16 pixel tile (128 rows of M, starting at even
//     coordinates, so the 2x2 pool stays inside the block) and BN output
//     channels: all of Cout up to 256, 256 beyond (BN = 64, 128 or 256), so
//     each A tile feeds as many output channels as the accumulator
//     registers hold. Where that grid would fill under 3/4 of the card's
//     block slots (the coarse levels), BN narrows so more SMs share the K
//     loop.
//   * TMA brings every operand. A: a 4-D tiled tensor map over x, (C, W, H,
//     N) innermost first; step (tap, chunk) loads the box (BK, 16, 8, 1) at
//     (c0, x0 + dx, y0 + dy, n). TMA fills the elements outside the image
//     with zeros, which is the SAME padding, so there is no masking code.
//     B: a 2-D map over the weights packed K-major, (Cout, 3, 3, Cin), the
//     box (BK, BN). Each box row is 128 bytes (BK = 64 bf16 or 32 f32) and
//     lands with the 128-byte swizzle: exactly a K-major wgmma operand.
//   * A ring of 3-4 stages in dynamic shared memory, 1024-byte aligned. One
//     producer thread keeps TMA loads in flight, each stage completing on
//     an mbarrier; two consumer warpgroups (64 rows of M each) wait on it,
//     issue wgmma.mma_async (bf16: m64nBNk16; f32 under TF32: m64nBNk8, f32
//     accumulators), keep one wgmma group in flight and release the
//     previous stage to the producer.
//   * The epilogue stages the f32 tile in shared memory (the ring's space),
//     adds the bias, applies the activation, writes y, and pools 2x2 from
//     the same f32 values; stores are masked at the ragged edge.
// Tensor maps are encoded on the host on every call (the pointers change),
// through cuTensorMapEncodeTiled reached with cudaGetDriverEntryPoint, so
// the library links nothing beyond the CUDA runtime. They reach the kernel
// as __grid_constant__ parameters. The rest of a launch's host work is done
// once per device: the SM count is read, and each kernel instance's dynamic
// shared memory limit raised, on its first launch there.
//
// Exact f32 (fi_conv3x3_f32, taken when TF32 is not allowed) runs on the
// CUDA cores: synchronous shared-memory tiles of 128 pixels x 64 output
// channels x 32 input channels, K innermost in both, and f32 FMAs, exact to
// f32 rounding.
//
// Weights come repacked by the caller as (Cout, 3, 3, Cin) in the input
// dtype (K-major, one packing for every route); bias is f32. Cin and Cout
// must be multiples of 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileRows = 8;   // output rows per block (even: pools in-block)
constexpr int kTileCols = 16;  // output columns per block (even)
constexpr int kBM = kTileRows * kTileCols;  // output pixels per block

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The epilogue shared by both kernels: Cs holds the block's kBM x BN f32
// conv sums (row m = pixel (m / 16, m % 16) of the tile, row stride
// kCStride floats); `threads` threads, numbered from 0, run it and `sync`
// joins them. Adds the bias, applies the activation, writes y, then pools
// 2x2 from the same f32 values.
template <typename T, int BN, int kCStride, typename Sync>
__device__ __forceinline__ void epilogue(
    float* Cs, const float* __restrict__ bias, T* __restrict__ out,
    T* __restrict__ pool, int H, int W, int Cout, int y0, int x0, int n0,
    int64_t img, float slope, int tid, int threads, Sync sync) {
  constexpr int kVecs = BN / 4;
  for (int i = tid; i < kBM * kVecs; i += threads) {
    const int m = i / kVecs, n = (i % kVecs) * 4;
    float4 v = *reinterpret_cast<float4*>(Cs + m * kCStride + n);
    const float4 b = *reinterpret_cast<const float4*>(bias + n0 + n);
    v.x = leaky(v.x + b.x, slope);
    v.y = leaky(v.y + b.y, slope);
    v.z = leaky(v.z + b.z, slope);
    v.w = leaky(v.w + b.w, slope);
    *reinterpret_cast<float4*>(Cs + m * kCStride + n) = v;
    const int yy = y0 + m / kTileCols, xx = x0 + m % kTileCols;
    if (yy < H && xx < W) {
      store4(out + ((img * H + yy) * W + xx) * Cout + n0 + n, v);
    }
  }
  if (pool == nullptr) return;
  sync();
  const int Hp = H / 2, Wp = W / 2;
  constexpr int kPoolCols = kTileCols / 2;
  for (int i = tid; i < (kBM / 4) * kVecs; i += threads) {
    const int pm = i / kVecs, n = (i % kVecs) * 4;
    const int pr = pm / kPoolCols, pc = pm % kPoolCols;
    const int py = y0 / 2 + pr, px = x0 / 2 + pc;
    if (py < Hp && px < Wp) {
      const float* c = Cs + (2 * pr * kTileCols + 2 * pc) * kCStride + n;
      const float4 a = *reinterpret_cast<const float4*>(c);
      const float4 b = *reinterpret_cast<const float4*>(c + kCStride);
      const float4 d =
          *reinterpret_cast<const float4*>(c + kTileCols * kCStride);
      const float4 e =
          *reinterpret_cast<const float4*>(c + (kTileCols + 1) * kCStride);
      const float4 s = make_float4(
          0.25f * ((a.x + b.x) + (d.x + e.x)), 0.25f * ((a.y + b.y) + (d.y + e.y)),
          0.25f * ((a.z + b.z) + (d.z + e.z)), 0.25f * ((a.w + b.w) + (d.w + e.w)));
      store4(pool + ((img * Hp + py) * Wp + px) * Cout + n0 + n, s);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: TMA + mbarrier ring + wgmma (bf16, and f32 as TF32).
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                        // warpgroups, 64 rows each
constexpr int kProducerWarp = 4 * kConsumers;        // warp 8
constexpr int kTcThreads = 128 * kConsumers + 32;    // + the producer warp
constexpr int kRowBytes = 128;                       // one K chunk per row
constexpr int kKStepBytes = 32;                      // one wgmma's K depth

template <typename T>
struct Operand;
template <>
struct Operand<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Operand<float> {
  static constexpr int kBK = 32;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// Shared-memory plan for an N tile of BN channels. BN = 64 and 128 fit two
// blocks on an SM (about 97 KB each); BN = 256 one block of 4 stages.
template <int BN>
struct Ring {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // f32 staging: +8 floats a row, so each half-warp's float2 fragment
  // stores (4 rows x 32 bytes) cover the 32 banks once.
  static constexpr int kCStride = BN + 8;
  static constexpr int kCBytes = kBM * kCStride * 4;
  static constexpr int kDataBytes =
      kStages * kStageBytes > kCBytes ? kStages * kStageBytes : kCBytes;
  static constexpr int kSmem = kDataBytes + 2 * kStages * 8 + 1024;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused by this layout (1). Advancing K by one wgmma step
// (32 bytes) adds 2 to the address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FI_R0_31                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define FI_R32_63                                                          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63"
#define FI_R64_127                                                         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "  \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define FI_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FI_ACC32(i) FI_ACC8(i), FI_ACC8(i + 8), FI_ACC8(i + 16), FI_ACC8(i + 24)
// One wgmma: d (64 x N f32, N/2 registers a thread) += A x B, both operands
// K-major in shared memory. bf16 takes the transpose immediates (0, 0);
// tf32 has none (K-major only).
#define FI_WGMMA(SHAPE_TYPES, REGS, DA, DB, SCALE, TAIL, ...)              \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %" #SCALE ", 0;\n"                  \
      "wgmma.mma_async.sync.aligned." SHAPE_TYPES " {" REGS "}, %" #DA     \
      ", %" #DB ", p, 1, 1" TAIL ";\n}\n"                                   \
      : __VA_ARGS__                                                      \
      : "l"(a), "l"(b), "r"(1))

template <typename T, int N>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16, 64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n64k16.f32.bf16.bf16", FI_R0_31, 32, 33, 34, ", 0, 0",
             FI_ACC32(0));
  }
};
template <>
struct Wgmma<__nv_bfloat16, 128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n128k16.f32.bf16.bf16", FI_R0_31 ", " FI_R32_63, 64, 65, 66,
             ", 0, 0", FI_ACC32(0), FI_ACC32(32));
  }
};
template <>
struct Wgmma<__nv_bfloat16, 256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n256k16.f32.bf16.bf16",
             FI_R0_31 ", " FI_R32_63 ", " FI_R64_127, 128, 129, 130, ", 0, 0",
             FI_ACC32(0), FI_ACC32(32), FI_ACC32(64), FI_ACC32(96));
  }
};
template <>
struct Wgmma<float, 64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n64k8.f32.tf32.tf32", FI_R0_31, 32, 33, 34, "",
             FI_ACC32(0));
  }
};
template <>
struct Wgmma<float, 128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n128k8.f32.tf32.tf32", FI_R0_31 ", " FI_R32_63, 64, 65, 66,
             "", FI_ACC32(0), FI_ACC32(32));
  }
};
template <>
struct Wgmma<float, 256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n256k8.f32.tf32.tf32",
             FI_R0_31 ", " FI_R32_63 ", " FI_R64_127, 128, 129, 130, "",
             FI_ACC32(0), FI_ACC32(32), FI_ACC32(64), FI_ACC32(96));
  }
};
#undef FI_WGMMA
#undef FI_ACC32
#undef FI_ACC8
#undef FI_R64_127
#undef FI_R32_63
#undef FI_R0_31

// Grid: x = pixel tile * n_blocks + N block (the N blocks of one pixel tile
// run side by side, so the second reads its A tiles from L2), y = image.
template <typename T, int BN>
__global__ void __launch_bounds__(kTcThreads, Ring<BN>::kMinBlocks)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ bias, T* __restrict__ out,
                         T* __restrict__ pool, int H, int W, int Cin,
                         int Cout, int tiles_w, int n_blocks, float slope) {
  using R = Ring<BN>;
  constexpr int kBK = Operand<T>::kBK;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes of shared address: align
  // the ring to it so TMA's and wgmma's swizzles agree.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + R::kDataBytes;   // kStages mbarriers
  const uint32_t empty = full + 8 * R::kStages;  // kStages mbarriers

  const int nb = blockIdx.x % n_blocks;
  const int tile = blockIdx.x / n_blocks;
  const int y0 = (tile / tiles_w) * kTileRows;
  const int x0 = (tile % tiles_w) * kTileCols;
  const int n0 = nb * BN;
  const int img = blockIdx.y;
  const int chunks = Cin / kBK;
  const int iters = 9 * chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < iters; ++it) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const int tap = it / chunks, c0 = (it % chunks) * kBK;
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = ring + stage * R::kStageBytes;
        mbar_expect_tx(bar, R::kStageBytes);
        tma_load_4d(dst, &xmap, bar, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1,
                    img);
        tma_load_2d(dst + R::kABytes, &wmap, bar, tap * Cin + c0, n0);
        if (++stage == R::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of the A
  // tile by the whole B tile.
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t a = ring + stage * R::kStageBytes + wg * 64 * kRowBytes;
    const uint32_t b = ring + stage * R::kStageBytes + R::kABytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kRowBytes / kKStepBytes; ++k) {
      Wgmma<T, BN>::run(acc, smem_desc(a + k * kKStepBytes),
                        smem_desc(b + k * kKStepBytes));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    // Keep this step's group in flight; the previous one is done, so its
    // stage goes back to the producer.
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = stage;
    if (++stage == R::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // Both warpgroups are done with the ring (named barrier 1: the 256
  // consumer threads); it now holds the f32 tile. Accumulator layout of
  // wgmma m64nN: register 4j + r of thread (warp w, lane l) is row
  // 16 w + l / 4 + 8 (r / 2), column 8 j + 2 (l % 4) + r % 2.
  auto sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  };
  sync();
  float* Cs = reinterpret_cast<float*>(smem);
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(Cs + row * R::kCStride + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(Cs + (row + 8) * R::kCStride + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  sync();
  epilogue<T, BN, R::kCStride>(Cs, bias, out, pool, H, W, Cout, y0, x0, n0,
                               img, slope, threadIdx.x, 128 * kConsumers,
                               sync);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled find_encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                              &found) == cudaSuccess &&
      found == cudaDriverEntryPointSuccess) {
    return reinterpret_cast<EncodeTiled>(p);
  }
  return nullptr;
}

// Looked up once, by whichever host thread launches first: C++11 runs a
// function-local static's initializer exactly once, the other threads
// waiting for it (the sharded paths launch from several threads).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = find_encode_tiled();
  return fn;
}

// A tiled map with 128-byte rows swizzled 128B, zeros outside the tensor.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_tiled()(map, Operand<T>::kType, rank, const_cast<void*>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Devices whose per-device facts are kept after their first launch; a
// device beyond them asks the runtime on every launch.
constexpr int kMaxDevices = 64;

cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> counts[kMaxDevices];
  const bool kept = device >= 0 && device < kMaxDevices;
  if (kept && (*sms = counts[device].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && kept) {
    counts[device].store(*sms, std::memory_order_relaxed);
  }
  return err;
}

template <typename T, int BN>
int launch_wgmma(const void* x, const void* w, const void* bias, void* out,
                 void* pool, int N, int H, int W, int Cin, int Cout,
                 float slope, int device, cudaStream_t stream) {
  using R = Ring<BN>;
  constexpr int kBK = Operand<T>::kBK;
  const cuuint64_t e = sizeof(T);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {Cin * e, (cuuint64_t)W * Cin * e,
                                  (cuuint64_t)H * W * Cin * e};
  const cuuint32_t xbox[4] = {kBK, kTileCols, kTileRows, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * Cin, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * Cin * e};
  const cuuint32_t wbox[2] = {kBK, BN};
  if (!encode<T>(&xmap, x, 4, xdims, xstrides, xbox) ||
      !encode<T>(&wmap, w, 2, wdims, wstrides, wbox)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = conv3x3_wgmma_kernel<T, BN>;
  // Raised once per device for this instance (each holds its own flags).
  // Two threads that launch at once may both raise it: the same value,
  // set twice, and the flag is atomic.
  static std::atomic<bool> smem_raised[kMaxDevices];
  const bool kept = device >= 0 && device < kMaxDevices;
  if (!kept || !smem_raised[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (kept) smem_raised[device].store(true, std::memory_order_relaxed);
  }
  const int tiles_w = (W + kTileCols - 1) / kTileCols;
  const int tiles_h = (H + kTileRows - 1) / kTileRows;
  const int n_blocks = Cout / BN;
  const dim3 grid(tiles_w * tiles_h * n_blocks, N);
  kernel<<<grid, kTcThreads, R::kSmem, stream>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<T*>(out),
      static_cast<T*>(pool), H, W, Cin, Cout, tiles_w, n_blocks, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tensor_cores(const void* x, const void* w, const void* bias,
                        void* out, void* pool, int N, int H, int W, int Cin,
                        int Cout, float slope, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 64 || Cout < 64 || Cin % 64 != 0 ||
      Cout % 64 != 0 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  const int64_t pixel_tiles = (int64_t)((W + kTileCols - 1) / kTileCols) *
                              ((H + kTileRows - 1) / kTileRows);
  if (pixel_tiles * (Cout / 64) > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  // The widest N tile that divides Cout (256, 128, 64): each A tile then
  // feeds the most output channels. A grid that would fill under 3/4 of
  // the card's block slots (the coarse pyramid levels: a few pixel tiles
  // and K loops of up to 144 steps) narrows the tile instead, down to 64,
  // so that more SMs share the work.
  auto fills = [&](int bn, int per_sm) {
    return 4 * pixel_tiles * N * (Cout / bn) >= 3 * (int64_t)sms * per_sm;
  };
  if (Cout % 256 == 0 && fills(256, Ring<256>::kMinBlocks)) {
    return launch_wgmma<T, 256>(x, w, bias, out, pool, N, H, W, Cin, Cout,
                                slope, device, s);
  }
  if (Cout % 128 == 0 && fills(128, Ring<128>::kMinBlocks)) {
    return launch_wgmma<T, 128>(x, w, bias, out, pool, N, H, W, Cin, Cout,
                                slope, device, s);
  }
  return launch_wgmma<T, 64>(x, w, bias, out, pool, N, H, W, Cin, Cout, slope,
                             device, s);
}

// ---------------------------------------------------------------------------
// Exact f32 route: CUDA-core FMAs (taken when TF32 is not allowed).
// ---------------------------------------------------------------------------

constexpr int kFmaBN = 64;   // output channels per block
constexpr int kFmaBK = 32;   // input channels per K step
constexpr int kFmaThreads = 256;
// Both tiles keep K innermost, as the packed weights do: rows of kFmaBK
// floats + 16 bytes, so a quarter-warp's 16-byte row loads and stores fall
// on distinct banks.
constexpr int kFmaStride = kFmaBK + 4;
constexpr int kFmaCStride = kFmaBN + 4;
constexpr int kFmaABytes = kBM * kFmaStride * 4;
constexpr int kFmaBBytes = kFmaBN * kFmaStride * 4;
constexpr int kFmaCBytes = kBM * kFmaCStride * 4;
constexpr int kFmaSmem = kFmaABytes + kFmaBBytes > kFmaCBytes
                             ? kFmaABytes + kFmaBBytes
                             : kFmaCBytes;

// Each thread owns 8 pixels (tm * 8 ...) x 4 channels (tn + 16 j), in full
// f32 FMAs, summed over K in order. The channel stride of 16 puts the B
// rows that a quarter-warp reads on distinct banks.
__global__ void __launch_bounds__(kFmaThreads)
    conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ pool, int H, int W, int Cin,
                       int Cout, int tiles_w, float slope) {
  __shared__ __align__(128) unsigned char smem[kFmaSmem];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + kFmaABytes);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * kTileRows;
  const int x0 = (blockIdx.x % tiles_w) * kTileCols;
  const int n0 = blockIdx.y * kFmaBN;
  const int64_t img = blockIdx.z;
  const float* xb = x + img * H * (int64_t)W * Cin;
  const int tn = tid % 16, tm = tid / 16;
  constexpr int kParts = kFmaBK / 4;  // 16-byte parts of a K row

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kFmaBK) {
      // A: kBM shifted input pixels x kFmaBK channels; zeros off the image.
      for (int i = tid; i < kBM * kParts; i += kFmaThreads) {
        const int m = i / kParts, part = i % kParts;
        const int yy = y0 + m / kTileCols + dy;
        const int xx = x0 + m % kTileCols + dx;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          v = *reinterpret_cast<const float4*>(
              xb + ((int64_t)yy * W + xx) * Cin + c0 + part * 4);
        }
        *reinterpret_cast<float4*>(As + m * kFmaStride + part * 4) = v;
      }
      // B: kFmaBN output channels x kFmaBK input channels of this tap, each
      // row 128 contiguous bytes of the K-major (Cout, 3, 3, Cin) weights.
      for (int i = tid; i < kFmaBN * kParts; i += kFmaThreads) {
        const int n = i / kParts, part = i % kParts;
        *reinterpret_cast<float4*>(Bs + n * kFmaStride + part * 4) =
            *reinterpret_cast<const float4*>(
                w + ((int64_t)(n0 + n) * 9 + tap) * Cin + c0 + part * 4);
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < kFmaBK; k += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = *reinterpret_cast<const float4*>(
              Bs + (tn + 16 * j) * kFmaStride + k);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              As + (tm * 8 + i) * kFmaStride + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += a.x * b[j].x;
            acc[i][j] += a.y * b[j].y;
            acc[i][j] += a.z * b[j].z;
            acc[i][j] += a.w * b[j].w;
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Cs[(tm * 8 + i) * kFmaCStride + tn + 16 * j] = acc[i][j];
    }
  __syncthreads();
  epilogue<float, kFmaBN, kFmaCStride>(Cs, bias, out, pool, H, W, Cout, y0,
                                       x0, n0, img, slope, tid, kFmaThreads,
                                       [] { __syncthreads(); });
}

int launch_fma(const void* x, const void* w, const void* bias, void* out,
               void* pool, int N, int H, int W, int Cin, int Cout, float slope,
               void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin % kFmaBK != 0 || Cout % kFmaBN != 0 ||
      Cin < kFmaBK || Cout < kFmaBN || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_w = (W + kTileCols - 1) / kTileCols;
  const int tiles_h = (H + kTileRows - 1) / kTileRows;
  const dim3 grid(tiles_w * tiles_h, Cout / kFmaBN, N);
  conv3x3_fma_kernel<<<grid, kFmaThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(pool), H, W, Cin, Cout, tiles_w, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 in and out, wgmma on bf16 with f32 accumulators.
extern "C" int fi_conv3x3_bf16(const void* x, const void* w, const void* bias,
                               void* out, void* pool, int N, int H, int W,
                               int Cin, int Cout, float slope, void* stream) {
  return launch_tensor_cores<__nv_bfloat16>(x, w, bias, out, pool, N, H, W,
                                            Cin, Cout, slope, stream);
}

// f32 in and out, wgmma in TF32 with f32 accumulators.
extern "C" int fi_conv3x3_tf32(const void* x, const void* w, const void* bias,
                               void* out, void* pool, int N, int H, int W,
                               int Cin, int Cout, float slope, void* stream) {
  return launch_tensor_cores<float>(x, w, bias, out, pool, N, H, W, Cin, Cout,
                                    slope, stream);
}

// f32 in and out, exact f32 FMAs.
extern "C" int fi_conv3x3_f32(const void* x, const void* w, const void* bias,
                              void* out, void* pool, int N, int H, int W,
                              int Cin, int Cout, float slope, void* stream) {
  return launch_fma(x, w, bias, out, pool, N, H, W, Cin, Cout, slope, stream);
}
