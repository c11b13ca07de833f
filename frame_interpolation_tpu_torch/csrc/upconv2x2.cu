// The fusion decoder's upsampling conv for Hopper (sm_90a), NHWC:
//
//   y = conv2x2_tf_same(nearest_x2(x), w) + b
//
// in one kernel, which reads the coarse level x (N, h, w, Cin) and writes
// the fine output y (N, 2h, 2w, Cout) once. It replaces no TPU kernel: the
// JAX package leaves the step (models/fusion.py, resize_nearest then the
// 2x2 `conv_{i}_0`) to XLA, and the port ran it as PyTorch ops, a strided
// copy for each axis of the upsample, a copy of the upsampled tensor into
// its TF-SAME padding (nothing before, one row and one column after) and a
// cuDNN conv of it: about 5 GB of copies a 1080p bf16 midpoint.
//
// What it computes: u[r, c] = x[r / 2, c / 2] for r < 2h and c < 2w, 0
// beyond, and y[Y, X, co] = b[co] + sum over taps (dy, dx) in {0, 1}^2 and
// ci of w[co, ci, dy, dx] * u[Y + dy, X + dx, ci]. Output (2i + a, 2j + b),
// the phase (a, b), reads coarse pixel (i + (a + dy) / 2, j + (b + dx) / 2):
// the coarse tile itself or the tile shifted by one row and/or one column.
// Every tap's products are kept and summed in f32 (no weights folded by
// phase, which would round other values in bf16), then the bias is added
// and y rounds once to x's dtype.
//
// What bounds it on the H100: at the released widths each of the three
// sites (coarse 544x960 128->64, 272x480 256->128, 136x240 512->256 at
// 1080p) is 137 GFLOP (0.14 ms at 989 TFLOP/s) and moves 0.10-0.40 GB
// (0.03-0.12 ms at 3.35 TB/s): tensor-core FLOPs, closely followed by the
// finest site's bytes.
//
// What the design does about it: an implicit GEMM over the four phases,
// M = coarse pixels, N = Cout, K = 4 taps x Cin, on the tensor cores
// through wgmma, as csrc/conv3x3.cu's ring kernel:
//   * A block owns a 4 x 16 coarse tile (64 rows of M, so 8 x 32 fine
//     pixels) and 64 output channels. Warpgroup a computes the output rows
//     of parity a, both column phases: two 64 x 64 f32 accumulators.
//   * A stage of the ring holds one K chunk (BK channels, one 128-byte row
//     a pixel): the coarse tile at its four shifts (0 or 1 row, 0 or 1
//     column), brought by TMA as four boxes of the same tensor map (TMA
//     fills the row and column beyond the image with zeros: the padding),
//     and the four taps' weights. Each of the 16 (phase, tap) products is a
//     wgmma of one shifted tile by one tap's weights; warpgroup 0 reads two
//     of the shifts, warpgroup 1 all four, 8 products each.
//   * bf16: wgmma on bf16 with both operands in shared memory. f32 under
//     TF32 (torch.backends.cudnn.allow_tf32): as conv3x3.cu's TF32 route,
//     the weights come rounded to TF32 by the caller and the activations
//     are rounded to nearest (ties away) on their way into wgmma's A
//     registers; a K step's A fragment of one shift feeds every product
//     of that shift.
//   * The epilogue stages the f32 tile in shared memory (the ring's
//     space), interleaving the phases into the 8 x 32 fine tile, adds the
//     bias and writes it pixel by pixel, masked at the ragged edge.
// Weights come repacked by the caller as (Cout, 2, 2, Cin) in x's dtype
// (K-major: tap (dy, dx) major, input channel minor); bias is f32. Cin and
// Cout must be multiples of 64.
#include <stdint.h>

#include <atomic>

#include "tma_wgmma.cuh"

namespace {

constexpr int kUpRows = 4;                    // coarse rows per block
constexpr int kUpCols = 16;                   // coarse columns per block
constexpr int kUpM = kUpRows * kUpCols;       // 64: one wgmma's M
constexpr int kFineCols = 2 * kUpCols;        // fine columns per block
constexpr int kUpBN = 64;                     // output channels per block
constexpr int kUpThreads = 2 * 128 + 32;      // 2 warpgroups + the producer
constexpr int kUpProducerWarp = 8;
constexpr int kUpTileBytes = kUpM * kRowBytes;  // a shifted A tile, 8 KB
static_assert(kUpBN * kRowBytes == kUpTileBytes, "a tap's B tile is 8 KB");
// A stage: the 4 shifted A tiles, then the 4 taps' B tiles.
constexpr int kUpStageBytes = 8 * kUpTileBytes;
constexpr int kUpStages = 3;
// f32 staging of the 8 x 32 fine tile: +4 floats a row, so the fragment
// stores of a warp (rows two fine columns apart) spread over the banks.
constexpr int kUpCStride = kUpBN + 4;
constexpr int kUpCBytes = 4 * kUpM * kUpCStride * 4;
constexpr int kUpDataBytes = kUpStages * kUpStageBytes > kUpCBytes
                                 ? kUpStages * kUpStageBytes
                                 : kUpCBytes;
constexpr int kUpSmem = kUpDataBytes + 2 * kUpStages * 8 + 1024;

// The A tile (shift slot 2 sy + sx) that tap (dy, dx) of phase (a, b)
// reads: coarse pixel (i + (a + dy) / 2, j + (b + dx) / 2).
__host__ __device__ constexpr int shift_slot(int a, int b, int dy, int dx) {
  return 2 * ((a + dy) >> 1) + ((b + dx) >> 1);
}

// bf16 consumers: warpgroup of row parity A, both operands from shared
// memory. Each stage's 4 K steps x 8 products go as one commit group; one
// group stays in flight, and the stage before it goes back to the
// producer.
template <int A>
__device__ __forceinline__ void consume_bf16(float (&acc)[2][32],
                                             uint32_t ring, uint32_t full,
                                             uint32_t empty, int chunks,
                                             int lane) {
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < chunks; ++it) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t base = ring + stage * kUpStageBytes;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kRowBytes / kKStepBytes; ++k) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const int slot = shift_slot(A, b, tap / 2, tap % 2);
          Wgmma<__nv_bfloat16, 64>::run(
              acc[b], smem_desc(base + slot * kUpTileBytes + k * kKStepBytes),
              smem_desc(base + (4 + tap) * kUpTileBytes + k * kKStepBytes));
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = stage;
    if (++stage == kUpStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// TF32 consumers: warpgroup of row parity A, A through registers as in
// conv3x3.cu's consume_tf32. Thread (warp w, lane l) reads tile rows r =
// 16 (w % 4) + l / 4 and r + 8, word l % 4 of each 16-byte chunk, chunk c
// of row r at c ^ (r % 8) (the 128-byte swizzle). Each K step loads the
// fragments of the shifts this warpgroup reads (2 for A = 0, 4 for A = 1)
// into one of two register buffers, rounded, and issues its 8 products as
// one commit group; the group before it (the other buffer) is waited for
// next, and only then is that buffer loaded again.
template <int A>
__device__ __forceinline__ void consume_tf32(float (&acc)[2][32],
                                             uint32_t ring, uint32_t full,
                                             uint32_t empty, int chunks,
                                             int warp, int lane) {
  constexpr int kSlots = A == 0 ? 2 : 4;
  constexpr int kSteps = kRowBytes / kKStepBytes;  // 4 K steps a stage
  uint32_t a[2][4 * kSlots] = {};
  const int r = 16 * (warp % 4) + lane / 4, swz = r % 8;
  const uint32_t rows0 = ring + r * kRowBytes + (lane % 4) * 4;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < chunks; ++it) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t rows = rows0 + stage * kUpStageBytes;
    const uint32_t b_tiles = ring + stage * kUpStageBytes + 4 * kUpTileBytes;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      uint32_t(&cur)[4 * kSlots] = a[k % 2];
      uint32_t(&other)[4 * kSlots] = a[(k + 1) % 2];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const uint32_t lo = rows + s * kUpTileBytes + (((2 * k) ^ swz) << 4);
        const uint32_t hi =
            rows + s * kUpTileBytes + (((2 * k + 1) ^ swz) << 4);
        cur[4 * s] = load_tf32(lo);
        cur[4 * s + 1] = load_tf32(lo + 8 * kRowBytes);
        cur[4 * s + 2] = load_tf32(hi);
        cur[4 * s + 3] = load_tf32(hi + 8 * kRowBytes);
      }
      fence_regs(cur);
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const int slot = shift_slot(A, b, tap / 2, tap % 2);
          WgmmaTf32<64>::run(
              acc[b], cur + 4 * slot,
              smem_desc(b_tiles + tap * kUpTileBytes + k * kKStepBytes));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      // The group before this one is done: its registers are free, and
      // after a stage's first group, so is the previous stage.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(other);
      if (k == 0 && it > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    }
    prev = stage;
    if (++stage == kUpStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(a[0]);
  fence_regs(a[1]);
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// Grid: x = coarse tile * n_blocks + N block (the N blocks of one tile run
// side by side, so the later ones read its A boxes from L2), y = image.
// H = 2h and W = 2w are the output's rows and columns.
template <typename T>
__global__ void __launch_bounds__(kUpThreads, 1)
    upconv2x2_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ bias, T* __restrict__ out,
                           int H, int W, int Cin, int Cout, int tiles_w,
                           int n_blocks) {
  constexpr int kBK = Operand<T>::kBK;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes of shared address: align
  // the ring to it so TMA's and wgmma's swizzles agree.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + kUpDataBytes;   // kUpStages mbarriers
  const uint32_t empty = full + 8 * kUpStages;  // kUpStages mbarriers

  const int nb = blockIdx.x % n_blocks;
  const int tile = blockIdx.x / n_blocks;
  const int y0 = (tile / tiles_w) * kUpRows;  // coarse origin
  const int x0 = (tile % tiles_w) * kUpCols;
  const int n0 = nb * kUpBN;
  const int img = blockIdx.y;
  const int chunks = Cin / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kUpStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kUpProducerWarp) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < chunks; ++it) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const int c0 = it * kBK;
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = ring + stage * kUpStageBytes;
        mbar_expect_tx(bar, kUpStageBytes);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          tma_load_4d(dst + s * kUpTileBytes, &xmap, bar, c0, x0 + s % 2,
                      y0 + s / 2, img);
        }
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          tma_load_2d(dst + (4 + tap) * kUpTileBytes, &wmap, bar,
                      tap * Cin + c0, n0);
        }
        if (++stage == kUpStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int a = warp / 4;  // the warpgroup's output row parity
  float acc[2][32];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  if constexpr (sizeof(T) == 4) {
    if (a == 0) {
      consume_tf32<0>(acc, ring, full, empty, chunks, warp, lane);
    } else {
      consume_tf32<1>(acc, ring, full, empty, chunks, warp, lane);
    }
  } else {
    if (a == 0) {
      consume_bf16<0>(acc, ring, full, empty, chunks, lane);
    } else {
      consume_bf16<1>(acc, ring, full, empty, chunks, lane);
    }
  }

  // Both warpgroups are done with the ring (named barrier 1: the 256
  // consumer threads); it now holds the f32 fine tile. Accumulator layout
  // of wgmma m64n64: register 4j + r of thread (warp w, lane l) is row m =
  // 16 (w % 4) + l / 4 + 8 (r / 2), column 8 j + 2 (l % 4) + r % 2; row m is
  // coarse pixel (m / 16, m % 16), whose phase (a, b) is fine pixel
  // (2 (m / 16) + a, 2 (m % 16) + b) of the tile.
  auto sync = [] { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };
  sync();
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * (warp % 4) + lane / 4 + 8 * half;
      const int fine = (2 * (m / kUpCols) + a) * kFineCols + 2 * (m % kUpCols) + b;
#pragma unroll
      for (int j = 0; j < kUpBN / 8; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(Cs + fine * kUpCStride + col) =
            make_float2(acc[b][4 * j + 2 * half], acc[b][4 * j + 2 * half + 1]);
      }
    }
  }
  sync();
  constexpr int kVecs = kUpBN / 4;
  const int fy0 = 2 * y0, fx0 = 2 * x0;
  for (int i = threadIdx.x; i < 4 * kUpM * kVecs; i += 256) {
    const int m = i / kVecs, n = (i % kVecs) * 4;
    float4 v = *reinterpret_cast<const float4*>(Cs + m * kUpCStride + n);
    const float4 bv = *reinterpret_cast<const float4*>(bias + n0 + n);
    v.x += bv.x;
    v.y += bv.y;
    v.z += bv.z;
    v.w += bv.w;
    const int yy = fy0 + m / kFineCols, xx = fx0 + m % kFineCols;
    if (yy < H && xx < W) {
      store4(out + (((int64_t)img * H + yy) * W + xx) * Cout + n0 + n, v);
    }
  }
}

// Launches the kernel on x (N, H, W, Cin), out (N, 2H, 2W, Cout).
template <typename T>
int launch_upconv(const void* x, const void* w, const void* bias, void* out,
                  int N, int H, int W, int Cin, int Cout, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 64 || Cout < 64 || Cin % 64 != 0 ||
      Cout % 64 != 0 || N > 65535 || H > 0x3FFFFFFF || W > 0x3FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  const int64_t tiles_w = (W + kUpCols - 1) / kUpCols;
  const int64_t tiles_h = (H + kUpRows - 1) / kUpRows;
  const int n_blocks = Cout / kUpBN;
  if (tiles_w * tiles_h * n_blocks > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kBK = Operand<T>::kBK;
  const cuuint64_t e = sizeof(T);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {Cin * e, (cuuint64_t)W * Cin * e,
                                  (cuuint64_t)H * W * Cin * e};
  const cuuint32_t xbox[4] = {kBK, kUpCols, kUpRows, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)4 * Cin, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)4 * Cin * e};
  const cuuint32_t wbox[2] = {kBK, kUpBN};
  if (!encode<T>(&xmap, x, 4, xdims, xstrides, xbox) ||
      !encode<T>(&wmap, w, 2, wdims, wstrides, wbox)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  // Raised once per device for this instance, as conv3x3.cu's launch does.
  static std::atomic<bool> smem_raised[kMaxDevices];
  const bool kept = device >= 0 && device < kMaxDevices;
  if (!kept || !smem_raised[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(upconv2x2_wgmma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kUpSmem);
    if (err != cudaSuccess) return (int)err;
    if (kept) smem_raised[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((unsigned)(tiles_w * tiles_h * n_blocks), N);
  upconv2x2_wgmma_kernel<T>
      <<<grid, kUpThreads, kUpSmem, static_cast<cudaStream_t>(stream)>>>(
          xmap, wmap, static_cast<const float*>(bias), static_cast<T*>(out),
          2 * H, 2 * W, Cin, Cout, (int)tiles_w, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 in and out, wgmma on bf16 with f32 accumulators. x (N, H, W, Cin),
// out (N, 2H, 2W, Cout).
extern "C" int fi_upconv2x2_bf16(const void* x, const void* w,
                                 const void* bias, void* out, int N, int H,
                                 int W, int Cin, int Cout, void* stream) {
  return launch_upconv<__nv_bfloat16>(x, w, bias, out, N, H, W, Cin, Cout,
                                      stream);
}

// f32 in and out, wgmma in TF32 with f32 accumulators; w already rounded
// to TF32 (ties away from zero), x rounded in the kernel.
extern "C" int fi_upconv2x2_tf32(const void* x, const void* w,
                                 const void* bias, void* out, int N, int H,
                                 int W, int Cin, int Cout, void* stream) {
  return launch_upconv<float>(x, w, bias, out, N, H, W, Cin, Cout, stream);
}
