// Hopper building blocks shared by conv3x3.cu, conv3x3_pieces.cu and
// upconv2x2.cu: mbarriers, TMA loads and tensor maps (128-byte rows,
// 128-byte swizzle, zeros outside the tensor), wgmma descriptors and
// instructions for bf16 and TF32 (A from shared memory, or from registers,
// rounded to nearest by load_tf32), the f32 -> T stores and leaky relu of
// an epilogue, and the SM count a launch sizes its grid by.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

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

// The f32 at shared address `addr`, rounded to the nearest TF32 value
// (ties away from zero): its bits, the 13 below TF32's mantissa cleared.
// Volatile, so that it stays after the mbarrier wait that guards it.
__device__ __forceinline__ uint32_t load_tf32(uint32_t addr) {
  uint32_t r;
  asm volatile(
      "{\n.reg .f32 v;\nld.shared.f32 v, [%1];\n"
      "cvt.rna.tf32.f32 %0, v;\nand.b32 %0, %0, 0xFFFFE000;\n}\n"
      : "=r"(r)
      : "r"(addr));
  return r;
}

// The f32 v rounded to the nearest TF32 value (ties away from zero), as
// load_tf32 rounds a value it loads: for operands that wgmma reads from
// shared memory.
__device__ __forceinline__ float round_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments in registers: keeps them live, and unmoved,
// until this point (a wgmma in flight reads them).
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define FI_R0_15                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
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
#define FI_ACC16(i) FI_ACC8(i), FI_ACC8(i + 8)
#define FI_ACC32(i) FI_ACC16(i), FI_ACC16(i + 16)
// One wgmma: d (64 x N f32, N/2 registers a thread) += A x B, both operands
// K-major in shared memory. bf16 takes the transpose immediates (0, 0),
// TF32 none.
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
struct Wgmma<__nv_bfloat16, 32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n32k16.f32.bf16.bf16", FI_R0_15, 16, 17, 18, ", 0, 0",
             FI_ACC16(0));
  }
};
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
// TF32 with both operands K-major in shared memory: wgmma reads the top 19
// bits of each f32, so operands meant to be rounded to nearest must hold
// rounded values already (csrc/conv3x3_pieces.cu rounds A's tile in place).
template <>
struct Wgmma<float, 32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n32k8.f32.tf32.tf32", FI_R0_15, 16, 17, 18, "", FI_ACC16(0));
  }
};
template <>
struct Wgmma<float, 64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    FI_WGMMA("m64n64k8.f32.tf32.tf32", FI_R0_31, 32, 33, 34, "", FI_ACC32(0));
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
// One TF32 wgmma with A from registers: a holds the thread's 4 A elements
// of one K step (wgmma's m64nNk8 .tf32 A fragment: rows l / 4 and l / 4 +
// 8 of the warp's 16, columns l % 4 and l % 4 + 4, as a0 (r, c), a1 (r +
// 8, c), a2 (r, c + 4), a3 (r + 8, c + 4)); B from shared memory, K-major.
#define FI_WGMMA_RS(SHAPE, REGS, AREGS, DB, SCALE, ...)                    \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %" #SCALE ", 0;\n"                  \
      "wgmma.mma_async.sync.aligned." SHAPE ".f32.tf32.tf32 {" REGS "}, {" \
      AREGS "}, %" #DB ", p, 1, 1;\n}\n"                                   \
      : __VA_ARGS__                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <int N>
struct WgmmaTf32;
template <>
struct WgmmaTf32<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t* a, uint64_t b) {
    FI_WGMMA_RS("m64n64k8", FI_R0_31, "%32, %33, %34, %35", 36, 37,
                FI_ACC32(0));
  }
};
template <>
struct WgmmaTf32<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t* a, uint64_t b) {
    FI_WGMMA_RS("m64n128k8", FI_R0_31 ", " FI_R32_63, "%64, %65, %66, %67",
                68, 69, FI_ACC32(0), FI_ACC32(32));
  }
};
template <>
struct WgmmaTf32<256> {
  __device__ __forceinline__ static void run(float (&d)[128],
                                             const uint32_t* a, uint64_t b) {
    FI_WGMMA_RS("m64n256k8", FI_R0_31 ", " FI_R32_63 ", " FI_R64_127,
                "%128, %129, %130, %131", 132, 133, FI_ACC32(0),
                FI_ACC32(32), FI_ACC32(64), FI_ACC32(96));
  }
};
#undef FI_WGMMA_RS
#undef FI_WGMMA
#undef FI_ACC32
#undef FI_ACC16
#undef FI_ACC8
#undef FI_R64_127
#undef FI_R32_63
#undef FI_R0_31
#undef FI_R0_15

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

// The device's SM count, asked once for each of the first kMaxDevices
// devices.
inline cudaError_t sm_count(int device, int* sms) {
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

// Leaky relu in f32: JAX's where(v >= 0, v, slope v), gradient 1 at 0.
__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

}  // namespace
