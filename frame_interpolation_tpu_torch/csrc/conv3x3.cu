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
// each output rounds once to x's dtype. The flow estimators' and the fusion
// decoder's 3x3 convs, with the same arithmetic and epilogue but no pool,
// inputs in two pieces, N tiles of 32 and 16-channel K tails, run on their
// own kernel, csrc/conv3x3_pieces.cu (conv3x3_pieces_wgmma_kernel), so that
// this one stays tuned to the extractor's sites and its time (the
// benchmark's conv3x3_roofline readings) holds only theirs.
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
//   * TF32 operands are rounded to nearest (ties away), as cuDNN's are:
//     wgmma's .tf32 reads the top 19 bits of each f32 and drops the rest,
//     which truncates (every product shrinks by about 7e-4 on average).
//     The weights (B) come rounded by the caller. A, the activations that
//     TMA lands, is read from shared memory into registers in wgmma's A
//     fragment layout and rounded there (cvt.rna.tf32.f32), and the TF32
//     wgmma takes A from registers: no pass over the tile, no proxy fence,
//     no barrier, and the same shared-memory traffic as a descriptor's
//     read. A stage's 4 K steps go as commit groups of 2 (BN = 64) or 1,
//     so that the A registers of the group in flight are held apart from
//     those being loaded; one group stays in flight as before.
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
// CUDA cores, with f32 FMAs summed over K in a fixed order (the same bits
// on every run). FMA issue bounds it: 67 TFLOP/s, so the 136x240 512->512
// site alone needs 2.3 ms. To stay at that bound the FMAs must never wait
// on a load, and shared memory must feed them: this route keeps the
// tensor-core route's producer and ring (TMA loads, SAME padding by TMA's
// zero fill, 4 stages on mbarriers), so the next steps' tiles arrive while
// this step's FMAs run, and swaps the wgmma consumers for FMA consumers
// that read the swizzled tiles as they lie: 128 pixels x BN = 128 output
// channels a block (64 where a wider grid would not fill the SMs), an
// 8 x 8 register tile a thread, 16 conflict-free 16-byte shared loads for
// every 256 FMAs. Where even BN = 64 leaves most SMs idle (the coarsest
// levels of a train step), K is split into parts, each a block's K range
// written to a workspace, and a second pass sums the parts in order and
// runs the epilogue.
//
// Weights come repacked by the caller as (Cout, 3, 3, Cin) in the input
// dtype (K-major, one layout for every route; for fi_conv3x3_tf32 each
// value rounded to TF32); bias is f32. Cin and Cout must be multiples of
// 64.
#include <stdint.h>

#include <atomic>

#include "tma_wgmma.cuh"

namespace {

constexpr int kTileRows = 8;   // output rows per block (even: pools in-block)
constexpr int kTileCols = 16;  // output columns per block (even)
constexpr int kBM = kTileRows * kTileCols;  // output pixels per block

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

// The producer of both ring kernels, run by one thread: step it = (tap,
// chunk), for it in [it0, it1), loads x's box at the tap's shifted origin
// (TMA zero-fills what lies outside the image: the SAME padding) and the
// weights' box of that K range, into the ring's next stage once the
// consumers have released it.
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full,
                                       uint32_t empty, const CUtensorMap* xmap,
                                       const CUtensorMap* wmap, int stages,
                                       int stage_bytes, int a_bytes, int it0,
                                       int it1, int chunks, int bk, int Cin,
                                       int x0, int y0, int img, int n0) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(xmap))
               : "memory");
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(wmap))
               : "memory");
  int stage = 0;
  uint32_t phase = 0;
  for (int it = it0; it < it1; ++it) {
    mbar_wait(empty + 8 * stage, phase ^ 1);
    const int tap = it / chunks, c0 = (it % chunks) * bk;
    const uint32_t bar = full + 8 * stage;
    const uint32_t dst = ring + stage * stage_bytes;
    mbar_expect_tx(bar, stage_bytes);
    tma_load_4d(dst, xmap, bar, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
    tma_load_2d(dst + a_bytes, wmap, bar, tap * Cin + c0, n0);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The TF32 consumers' loop: warpgroup rows [row0 - (row0 % 64), + 64) of
// each stage's A tile by its B tile, A through registers. Thread (warp w,
// lane l) reads rows r = row0 + l / 4 and r + 8 (row0 = 64 wg + 16 w),
// word l % 4 of each 16-byte chunk: chunk c of row r lies at c ^ (r % 8)
// (the 128-byte swizzle; r % 8 = l / 4), so a warp's 32 loads hit 32
// banks. Every kGroupSteps K steps go to one of two register buffers and
// one commit group; the group before it (the other buffer) is waited for
// next, and only then is that buffer loaded again. A stage goes back to
// the producer once its last group is done.
template <int BN, int kStages, int kStageBytes, int kABytes>
__device__ __forceinline__ void consume_tf32(float (&acc)[BN / 2],
                                             uint32_t ring, uint32_t full,
                                             uint32_t empty, int iters,
                                             int row0, int lane) {
  constexpr int kSteps = kRowBytes / kKStepBytes;  // 4 K steps a stage
  // K steps a group: as many as leave ptxas the registers to keep the
  // wgmmas in flight (with 2, it serializes them at BN = 128 and 256; at
  // BN = 128 it does with 1 too, within the 96 registers that two blocks
  // of 288 threads leave a thread).
  constexpr int kGroupSteps = BN == 64 ? 2 : 1;
  constexpr int kGroups = kSteps / kGroupSteps;  // even: buffer g % 2
  uint32_t a[2][4 * kGroupSteps] = {};
  const int r = row0 + lane / 4, swz = r % 8;
  const uint32_t rows0 = ring + r * kRowBytes + (lane % 4) * 4;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t rows = rows0 + stage * kStageBytes;
    const uint32_t b = ring + stage * kStageBytes + kABytes;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      uint32_t(&cur)[4 * kGroupSteps] = a[g % 2];
      uint32_t(&other)[4 * kGroupSteps] = a[(g + 1) % 2];
#pragma unroll
      for (int s = 0; s < kGroupSteps; ++s) {
        const int c = 2 * (g * kGroupSteps + s);  // K step's first chunk
        const uint32_t lo = rows + ((c ^ swz) << 4);
        const uint32_t hi = rows + (((c + 1) ^ swz) << 4);
        cur[4 * s] = load_tf32(lo);
        cur[4 * s + 1] = load_tf32(lo + 8 * kRowBytes);
        cur[4 * s + 2] = load_tf32(hi);
        cur[4 * s + 3] = load_tf32(hi + 8 * kRowBytes);
      }
      fence_regs(cur);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < kGroupSteps; ++s) {
        WgmmaTf32<BN>::run(
            acc, cur + 4 * s,
            smem_desc(b + (g * kGroupSteps + s) * kKStepBytes));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // The group before this one is done: its registers are free, and
      // after a stage's first group, so is the previous stage.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(other);
      if (g == 0 && it > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    }
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(a[0]);
  fence_regs(a[1]);
}

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
    if (lane == 0) {
      produce(ring, full, empty, &xmap, &wmap, R::kStages, R::kStageBytes,
              R::kABytes, 0, iters, chunks, kBK, Cin, x0, y0, img, n0);
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of the A
  // tile by the whole B tile.
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if constexpr (sizeof(T) == 4) {
    consume_tf32<BN, R::kStages, R::kStageBytes, R::kABytes>(
        acc, ring, full, empty, iters, wg * 64 + (warp % 4) * 16, lane);
  } else {
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

// ---------------------------------------------------------------------------
// Exact f32 route: the same TMA ring, consumed by CUDA-core FMAs (taken
// when TF32 is not allowed).
// ---------------------------------------------------------------------------

// Plan for an N tile of BN channels: 16 pixel groups x BN/8 channel groups
// of consumer threads, each owning an 8 x 8 register tile, plus the
// producer warp. BN = 128: 256 consumer threads and 4 stages of 32 KB, one
// block an SM; BN = 64: 128 consumer threads and 4 stages of 24 KB, two
// blocks an SM.
template <int BN>
struct FmaRing {
  static constexpr int kConsumerThreads = 2 * BN;
  static constexpr int kConsumerWarps = kConsumerThreads / 32;
  static constexpr int kThreads = kConsumerThreads + 32;
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  // f32 staging: +8 floats a row, so a warp's scalar stores of its 4 pixel
  // groups x 8 channel groups cover the 32 banks once.
  static constexpr int kCStride = BN + 8;
  static constexpr int kCBytes = kBM * kCStride * 4;
  static constexpr int kDataBytes =
      kStages * kStageBytes > kCBytes ? kStages * kStageBytes : kCBytes;
  static constexpr int kSmem = kDataBytes + 2 * kStages * 8 + 1024;
  static constexpr int kMinBlocks = BN == 128 ? 1 : 2;
};

// The exact f32 consumers. Thread (pixel group pg, channel group cg) owns
// the tile's pixels pg + 16 i (column pg, rows i = 0..7) and the channels
// cg + BN/8 j (j = 0..7): 64 accumulators, each summed over K in order
// (tap, then input channel) with f32 FMAs. The operands stay where TMA put
// them: K-major rows of 128 bytes (32 channels), 16-byte chunk c of row r
// at chunk c ^ (r % 8) (the 128-byte swizzle). A warp holds 4 pixel groups
// x 8 channel groups; its 8 lanes of a pixel group read one 16-byte chunk
// (a broadcast), and the rows a warp reads fall on distinct chunks, so a
// 16-byte load costs one pass of the shared memory. Per 4 k a thread makes
// 16 such loads for 256 FMAs.
template <int BN>
__global__ void __launch_bounds__(FmaRing<BN>::kThreads,
                                  FmaRing<BN>::kMinBlocks)
    conv3x3_fma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ pool, float* __restrict__ part,
                       int H, int W, int Cin, int Cout, int tiles_w,
                       int n_blocks, float slope) {
  using R = FmaRing<BN>;
  constexpr int kBK = Operand<float>::kBK;
  constexpr int kGroups = BN / 8;  // channel groups
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + R::kDataBytes;
  const uint32_t empty = full + 8 * R::kStages;

  const int nb = blockIdx.x % n_blocks;
  const int tile = blockIdx.x / n_blocks;
  const int y0 = (tile / tiles_w) * kTileRows;
  const int x0 = (tile % tiles_w) * kTileCols;
  const int n0 = nb * BN;
  const int img = blockIdx.y;
  const int chunks = Cin / kBK;
  // Part blockIdx.z of gridDim.z sums the K steps [it0, it1).
  const int iters = 9 * chunks, splits = gridDim.z;
  const int it0 = (int)((int64_t)blockIdx.z * iters / splits);
  const int it1 = (int)((int64_t)(blockIdx.z + 1) * iters / splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, R::kConsumerWarps);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == R::kConsumerWarps) {
    if (lane == 0) {
      produce(ring, full, empty, &xmap, &wmap, R::kStages, R::kStageBytes,
              R::kABytes, it0, it1, chunks, kBK, Cin, x0, y0, img, n0);
    }
    return;
  }

  const int pg = 4 * (warp % 4) + lane / 8;
  const int cg = lane % 8 + 8 * (warp / 4);
  // Byte offsets inside a stage: the thread's first A row (pixel pg) and
  // first B row (channel cg), and the swizzle of each (row % 8 is the same
  // for all 8 rows of either: they step by 16 and by BN/8 rows).
  const int a_row = pg * kRowBytes, b_row = R::kABytes + cg * kRowBytes;
  const int a_swz = (pg & 7) << 4, b_swz = (cg & 7) << 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int it = it0; it < it1; ++it) {
    mbar_wait(full + 8 * stage, phase);
    const unsigned char* base = smem + stage * R::kStageBytes;
#pragma unroll 2
    for (int c = 0; c < kRowBytes / 16; ++c) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = *reinterpret_cast<const float4*>(
            base + b_row + j * kGroups * kRowBytes + ((c << 4) ^ b_swz));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            base + a_row + i * kTileCols * kRowBytes + ((c << 4) ^ a_swz));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    // The warp has read the stage: back to the producer.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == R::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (splits > 1) {
    // A part of K: its f32 sums to the part's plane, (N, H, W, Cout), for
    // conv3x3_split_finish_kernel.
    float* plane = part + (int64_t)(blockIdx.z * gridDim.y + img) * H * W * Cout;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int yy = y0 + i, xx = x0 + pg;
      if (yy >= H || xx >= W) continue;
      float* row = plane + ((int64_t)yy * W + xx) * Cout + n0 + cg;
#pragma unroll
      for (int j = 0; j < 8; ++j) row[j * kGroups] = acc[i][j];
    }
    return;
  }

  // Every load has landed and been read; the ring now holds the f32 tile.
  auto sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(R::kConsumerThreads) : "memory");
  };
  sync();
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Cs[(pg + i * kTileCols) * R::kCStride + cg + j * kGroups] = acc[i][j];
    }
  sync();
  epilogue<float, BN, R::kCStride>(Cs, bias, out, pool, H, W, Cout, y0, x0,
                                   n0, img, slope, threadIdx.x,
                                   R::kConsumerThreads, sync);
}

// Launches one ring kernel: the wgmma kernel (kFma false) or the exact
// f32 FMA kernel, over the same tensor maps and grid.
template <typename T, int BN, bool kFma>
int launch_ring(const void* x, const void* w, const void* bias, void* out,
                void* pool, void* part, int splits, int N, int H, int W,
                int Cin, int Cout, float slope, int device,
                cudaStream_t stream) {
  constexpr int kBK = Operand<T>::kBK;
  constexpr int kSmem = kFma ? FmaRing<BN>::kSmem : Ring<BN>::kSmem;
  constexpr int kThreads = kFma ? FmaRing<BN>::kThreads : kTcThreads;
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
  const void* kernel;
  if constexpr (kFma) {
    kernel = reinterpret_cast<const void*>(conv3x3_fma_kernel<BN>);
  } else {
    kernel = reinterpret_cast<const void*>(conv3x3_wgmma_kernel<T, BN>);
  }
  // Raised once per device for this instance (each holds its own flags).
  // Two threads that launch at once may both raise it: the same value,
  // set twice, and the flag is atomic.
  static std::atomic<bool> smem_raised[kMaxDevices];
  const bool kept = device >= 0 && device < kMaxDevices;
  if (!kept || !smem_raised[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    if (kept) smem_raised[device].store(true, std::memory_order_relaxed);
  }
  const int tiles_w = (W + kTileCols - 1) / kTileCols;
  const int tiles_h = (H + kTileRows - 1) / kTileRows;
  const int n_blocks = Cout / BN;
  const dim3 grid(tiles_w * tiles_h * n_blocks, N, splits);
  if constexpr (kFma) {
    conv3x3_fma_kernel<BN><<<grid, kThreads, kSmem, stream>>>(
        xmap, wmap, static_cast<const float*>(bias), static_cast<float*>(out),
        static_cast<float*>(pool), static_cast<float*>(part), H, W, Cin, Cout,
        tiles_w, n_blocks, slope);
  } else {
    conv3x3_wgmma_kernel<T, BN><<<grid, kThreads, kSmem, stream>>>(
        xmap, wmap, static_cast<const float*>(bias), static_cast<T*>(out),
        static_cast<T*>(pool), H, W, Cin, Cout, tiles_w, n_blocks, slope);
  }
  return (int)cudaGetLastError();
}

// Checks the arguments every route takes and reads the device's SM count;
// returns the number of pixel tiles through `pixel_tiles`.
int prepare(int N, int H, int W, int Cin, int Cout, int* device, int* sms,
            int64_t* pixel_tiles) {
  if (N < 1 || H < 1 || W < 1 || Cin < 64 || Cout < 64 || Cin % 64 != 0 ||
      Cout % 64 != 0 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  *pixel_tiles = (int64_t)((W + kTileCols - 1) / kTileCols) *
                 ((H + kTileRows - 1) / kTileRows);
  if (*pixel_tiles * (Cout / 64) > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetDevice(device);
  if (err == cudaSuccess) err = sm_count(*device, sms);
  return (int)err;
}

template <typename T>
int launch_tensor_cores(const void* x, const void* w, const void* bias,
                        void* out, void* pool, int N, int H, int W, int Cin,
                        int Cout, float slope, void* stream) {
  int device = 0, sms = 0;
  int64_t pixel_tiles = 0;
  const int err = prepare(N, H, W, Cin, Cout, &device, &sms, &pixel_tiles);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The widest N tile that divides Cout (256, 128, 64): each A tile then
  // feeds the most output channels. A grid that would fill under 3/4 of
  // the card's block slots (the coarse pyramid levels: a few pixel tiles
  // and K loops of up to 144 steps) narrows the tile instead, down to 64,
  // so that more SMs share the work.
  auto fills = [&](int bn, int per_sm) {
    return 4 * pixel_tiles * N * (Cout / bn) >= 3 * (int64_t)sms * per_sm;
  };
  if (Cout % 256 == 0 && fills(256, Ring<256>::kMinBlocks)) {
    return launch_ring<T, 256, false>(x, w, bias, out, pool, nullptr, 1, N,
                                      H, W, Cin, Cout, slope, device, s);
  }
  if (Cout % 128 == 0 && fills(128, Ring<128>::kMinBlocks)) {
    return launch_ring<T, 128, false>(x, w, bias, out, pool, nullptr, 1, N,
                                      H, W, Cin, Cout, slope, device, s);
  }
  return launch_ring<T, 64, false>(x, w, bias, out, pool, nullptr, 1, N, H,
                                   W, Cin, Cout, slope, device, s);
}

// The exact route's N tile: 128 (one block an SM) where its grid fills 3/4
// of the SMs, else 64 (two an SM), which doubles a coarse level's blocks.
int fma_bn(int64_t pixel_tiles, int N, int Cout, int sms) {
  return Cout % 128 == 0 && 4 * pixel_tiles * N * (Cout / 128) >= 3 * sms
             ? 128
             : 64;
}

// The parts the exact route splits K into: 1 where its blocks fill at
// least half the SMs; else the count (at most kMaxSplits, at most one a K
// step) that minimises the waves of blocks times the K steps a block
// takes. A coarse level (8x8x8 and smaller in a train step) otherwise
// leaves most SMs idle through a K loop of up to 144 steps; at 128 blocks
// a split measured slower than none (the parts' writes and the second
// pass). The count is chosen for a batch of kSplitBatch whatever the
// batch is, so that a sample's sums do not depend on the batch it is in:
// data-parallel ranks, each with a part of the batch, then compute one
// process's bits.
constexpr int kMaxSplits = 32;
constexpr int kSplitBatch = 8;

int fma_splits(int64_t pixel_tiles, int Cin, int Cout, int sms) {
  const int bn = fma_bn(pixel_tiles, kSplitBatch, Cout, sms);
  const int64_t blocks = pixel_tiles * kSplitBatch * (Cout / bn);
  if (2 * blocks > sms) return 1;
  const int64_t slots = (int64_t)sms * (bn == 128 ? FmaRing<128>::kMinBlocks
                                                  : FmaRing<64>::kMinBlocks);
  const int iters = 9 * (Cin / Operand<float>::kBK);
  int best = 1;
  int64_t best_cost = iters;  // one wave of all K
  for (int split = 2; split <= kMaxSplits && split <= iters; ++split) {
    const int64_t cost = (blocks * split + slots - 1) / slots *
                         ((iters + split - 1) / split);
    if (cost < best_cost) {
      best = split;
      best_cost = cost;
    }
  }
  return best;
}

constexpr int kFinishThreads = 256;

// The second pass of a split exact conv: each output element the sum of
// its parts in order (part 0 first), then bias, activation, y and the 2x2
// pool as the epilogue computes them. A thread takes 4 channels of a 2x2
// quad of pixels.
__global__ void __launch_bounds__(kFinishThreads)
    conv3x3_split_finish_kernel(const float* __restrict__ part, int splits,
                                const float* __restrict__ bias,
                                float* __restrict__ out,
                                float* __restrict__ pool, int N, int H, int W,
                                int Cout, float slope) {
  const int vecs = Cout / 4;
  const int qh = (H + 1) / 2, qw = (W + 1) / 2;
  const int64_t i = (int64_t)blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= (int64_t)N * qh * qw * vecs) return;
  const int n = (int)(i % vecs) * 4;
  const int64_t quad = i / vecs;
  const int qx = (int)(quad % qw), qy = (int)(quad / qw % qh);
  const int64_t img = quad / qw / qh;
  const int64_t plane = (int64_t)N * H * W * Cout;
  const float4 b = *reinterpret_cast<const float4*>(bias + n);
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = 2 * qy + k / 2, x = 2 * qx + k % 2;
    if (y >= H || x >= W) continue;
    const int64_t at = ((img * H + y) * W + x) * Cout + n;
    float4 sum = *reinterpret_cast<const float4*>(part + at);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(part + s * plane + at);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    v[k] = make_float4(leaky(sum.x + b.x, slope), leaky(sum.y + b.y, slope),
                       leaky(sum.z + b.z, slope), leaky(sum.w + b.w, slope));
    store4(out + at, v[k]);
  }
  if (pool == nullptr || qy >= H / 2 || qx >= W / 2) return;
  store4(pool + ((img * (H / 2) + qy) * (W / 2) + qx) * Cout + n,
         make_float4(0.25f * ((v[0].x + v[1].x) + (v[2].x + v[3].x)),
                     0.25f * ((v[0].y + v[1].y) + (v[2].y + v[3].y)),
                     0.25f * ((v[0].z + v[1].z) + (v[2].z + v[3].z)),
                     0.25f * ((v[0].w + v[1].w) + (v[2].w + v[3].w))));
}

int launch_fma(const void* x, const void* w, const void* bias, void* out,
               void* pool, void* part, int splits, int N, int H, int W,
               int Cin, int Cout, float slope, void* stream) {
  int device = 0, sms = 0;
  int64_t pixel_tiles = 0;
  const int err = prepare(N, H, W, Cin, Cout, &device, &sms, &pixel_tiles);
  if (err != 0) return err;
  if (splits < 1 || splits > 9 * (Cin / Operand<float>::kBK) ||
      (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      fma_bn(pixel_tiles, N, Cout, sms) == 128
          ? launch_ring<float, 128, true>(x, w, bias, out, pool, part, splits,
                                          N, H, W, Cin, Cout, slope, device, s)
          : launch_ring<float, 64, true>(x, w, bias, out, pool, part, splits,
                                         N, H, W, Cin, Cout, slope, device, s);
  if (rc != 0 || splits == 1) return rc;
  const int64_t threads =
      (int64_t)N * ((H + 1) / 2) * ((W + 1) / 2) * (Cout / 4);
  conv3x3_split_finish_kernel<<<(unsigned)((threads + kFinishThreads - 1) /
                                           kFinishThreads),
                                kFinishThreads, 0, s>>>(
      static_cast<const float*>(part), splits, static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(pool), N, H, W, Cout,
      slope);
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

// f32 in and out, wgmma in TF32 with f32 accumulators; w already rounded
// to TF32 (ties away from zero), x rounded in the kernel.
extern "C" int fi_conv3x3_tf32(const void* x, const void* w, const void* bias,
                               void* out, void* pool, int N, int H, int W,
                               int Cin, int Cout, float slope, void* stream) {
  return launch_tensor_cores<float>(x, w, bias, out, pool, N, H, W, Cin, Cout,
                                    slope, stream);
}

// The number of parts fi_conv3x3_f32 splits K into at this shape on the
// current device (1: none; 1 also when the arguments or the device are
// refused, which fi_conv3x3_f32 then reports).
extern "C" int fi_conv3x3_f32_splits(int N, int H, int W, int Cin, int Cout) {
  int device = 0, sms = 0;
  int64_t pixel_tiles = 0;
  if (prepare(N, H, W, Cin, Cout, &device, &sms, &pixel_tiles) != 0) return 1;
  return fma_splits(pixel_tiles, Cin, Cout, sms);
}

// f32 in and out, exact f32 FMAs. splits: as fi_conv3x3_f32_splits gives
// it; above 1, part holds splits * N * H * W * Cout floats (its contents
// free), else it may be NULL.
extern "C" int fi_conv3x3_f32(const void* x, const void* w, const void* bias,
                              void* out, void* pool, void* part, int splits,
                              int N, int H, int W, int Cin, int Cout,
                              float slope, void* stream) {
  return launch_fma(x, w, bias, out, pool, part, splits, N, H, W, Cin, Cout,
                    slope, stream);
}
