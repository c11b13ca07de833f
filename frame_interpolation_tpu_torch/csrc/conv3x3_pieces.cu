// conv3x3 ('SAME') over the channel concat of one or two NHWC pieces, plus
// bias and leaky relu, for Hopper (sm_90a):
//
//   y = leaky(sum over pieces p of conv3x3_same(x_p, w_p) + b, slope)
//
// The flow estimators' and the fusion decoder's 3x3 convs
// (models/flow_estimator.py, models/fusion.py `conv_{i}_1`, `conv_{i}_2`).
// It replaces no TPU kernel: the JAX package leaves these convs to XLA, and
// the port ran them as cuDNN convs, each followed by its bias add, the
// split form's sum of partial outputs and a leaky relu pass, every one a
// full read and write of a conv output. Here the pieces are summed in one
// f32 accumulator over every piece, tap and channel (the concat form's
// arithmetic, with no bf16 rounding of partial outputs); bias and
// activation run in f32 and y rounds once to x's dtype, as csrc/conv3x3.cu's
// epilogue does. The pieces are the flow's (features, warped features) and
// the fusion's (packed aligned level, upsampled net): no concat is built.
//
// What bounds it on the H100: tensor-core FLOPs at most sites. At the
// finest level (1088x1920 at 1080p, Cout 32 and 64) as much the bytes the
// blocks' operands take from L2, and shared memory: a wgmma of N = 64 with
// both operands there reads 128 bytes a cycle at the tensor cores' rate,
// all the SM's shared memory gives (N = 32: 1.5 times that). The 50 sites
// of a 1080p midpoint are about 5.9 TFLOP, about 6 ms at 989 TFLOP/s
// (dense bf16).
//
// What the design does about it: an implicit GEMM with M = output pixels,
// N = Cout and K = 9 x the pieces' channels, on wgmma, fed by TMA, as
// conv3x3.cu's ring kernel is, with these differences:
//   * A block owns R rows of 64 output columns (R = 2, 4 or 8) and BN output
//     channels; warpgroup g computes rows g R/2 .. (g+1) R/2 - 1, one m64
//     wgmma a row. For each K chunk (BK channels of one piece) TMA
//     brings the block's tile with its halo once, the box (BK, 66, R + 2)
//     at (c0, x0 - 1, y0 - 1): TMA's zero fill outside the image is the
//     SAME padding. The 9 taps read that one box, each at its shift
//     (dy, dx): 64 consecutive box rows from row (r + dy) 66 + dx, so an
//     input pixel comes from L2 about 1.25-2 times a chunk and not 9
//     times. Such a shifted tile starts off the swizzle pattern's 1024-byte
//     boundary, and its descriptor is the plain one at its first row's
//     address (base offset 0): wgmma swizzles by the shared address's own
//     bits, as TMA does, and a base offset of the row's phase gives wrong
//     sums (checked on the card).
//   * The K loop runs over the pieces, piece 0's chunks then piece 1's,
//     each through its own tensor map, so the concat is never written. A
//     piece whose channels are not a multiple of BK (the fusion's 2C + 16)
//     ends in a chunk that TMA fills with zeros past its last channel;
//     the packed weights hold zero columns there (nothing is padded in
//     memory but the weights). B, the weights packed K-major (Cout, K),
//     piece by piece, tap major, each piece's channels padded to BK, come
//     in their own ring, one (tap, chunk) box (BK, BN) a stage, while a
//     second ring holds the A boxes of two chunks.
//   * N tiles of 32 (the finest flow estimator's 32 filters) up to 256.
//     Where a grid would fill under 3/4 of the SMs (the coarse levels), R
//     and then BN narrow, so more SMs share the work; the narrowest tiles
//     (R = 2, BN <= 64) fit two blocks an SM. The finest levels (Cout 32
//     or 64) take R = 8, so a block's weights and halo serve 512 pixels:
//     there the operands' bytes from L2, not the tensor cores, set the
//     pace.
//   * A piece's last chunk runs only the K steps that hold channels (1 of
//     4 for the fusion's 16-channel tails in bf16): its zero-filled steps
//     are left out.
// bf16 runs on wgmma with both operands in shared memory. f32 runs on the
// TF32 route only (under torch.backends.cudnn.allow_tf32), with both
// operands rounded to nearest TF32 (ties away), as cuDNN and conv3x3.cu's
// TF32 route round them: the weights when packed, each A box in place once
// it lands (one pass over the box, read by 9 taps' wgmmas).
// One producer thread issues the loads; two consumer warpgroups keep one
// wgmma group in flight. The epilogue stages the f32 tile in shared memory
// (the rings' space), adds the bias, applies the activation and writes y,
// masked at the ragged edge. (A persistent grid, each block walking
// several tiles with its epilogue stored from the accumulators so that the
// rings run on, measured faster only at the two sites of Cout 32 and
// slower at most others: the accumulators' stores are 4 bytes wide.)
// Weights: (Cout, K) in x's dtype, K = sum over pieces of 9 * cpad_p, cpad_p
// the piece's channels rounded up to BK (64 bf16, 32 f32), zero columns
// past its channels; for the TF32 route each value rounded to TF32. Bias is
// f32. Each piece's channels must be a multiple of 16, Cout of 32.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tma_wgmma.cuh"

namespace {

constexpr int kPcCols = 64;                  // output columns a block
constexpr int kPcHaloCols = kPcCols + 2;     // with the halo
constexpr int kPcConsumers = 2;              // warpgroups
constexpr int kPcProducerWarp = 4 * kPcConsumers;
constexpr int kPcThreads = 128 * kPcConsumers + 32;
constexpr int kMaxPieces = 2;

// Shared-memory plan for R output rows of 64 columns and an N tile of BN.
// R = 2 with BN <= 64 fits two blocks an SM; the rest take one. The B ring
// takes what the A boxes leave of the budget, up to 8 stages.
template <int R, int BN>
struct Plan {
  static constexpr int kSubTiles = R / kPcConsumers;  // m64 rows a warpgroup
  static constexpr int kMinBlocks = R == 2 && BN <= 64 ? 2 : 1;
  static constexpr int kABoxBytes = (R + 2) * kPcHaloCols * kRowBytes;
  static constexpr int kABytes = (kABoxBytes + 1023) / 1024 * 1024;
  static constexpr int kAStages = 2;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kBudget = kMinBlocks == 2 ? 100352 : 203776;
  static constexpr int kBFit = (kBudget - kAStages * kABytes) / kBBytes;
  static constexpr int kBStages = kBFit < 8 ? kBFit : 8;
  static constexpr int kRingBytes = kAStages * kABytes + kBStages * kBBytes;
  // f32 staging of the R x 64 tile, +8 floats a row as in conv3x3.cu.
  static constexpr int kCStride = BN + 8;
  static constexpr int kCBytes = R * kPcCols * kCStride * 4;
  static constexpr int kDataBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static constexpr int kSmem =
      kDataBytes + 2 * (kAStages + kBStages) * 8 + 1024;
  static_assert(kBStages >= 4, "B stages");
  static_assert(kMinBlocks == 1 || 2 * (kSmem + 1024) <= 233472,
                "two blocks an SM");
  static_assert(kSmem <= 232448, "one block an SM");
};

// The pieces as the K loop walks them.
struct Pieces {
  int count;
  int channels[kMaxPieces];
  int chunks[kMaxPieces];  // K chunks of BK channels (cpad / BK)
  int kcol[kMaxPieces];    // the piece's first column of the packed weights
  int cpad[kMaxPieces];    // the piece's channels rounded up to BK
};

// Grid: x = pixel tile * n_blocks + N block (the N blocks of one tile run
// side by side, so the later ones read its A boxes from L2), y = image.
template <typename T, int R, int BN>
__global__ void __launch_bounds__(kPcThreads, Plan<R, BN>::kMinBlocks)
    conv3x3_pieces_wgmma_kernel(const __grid_constant__ CUtensorMap xmap0,
                                const __grid_constant__ CUtensorMap xmap1,
                                const __grid_constant__ CUtensorMap wmap,
                                const Pieces pieces,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int H, int W, int Cout,
                                int tiles_w, int n_blocks, float slope) {
  using P = Plan<R, BN>;
  constexpr int kBK = Operand<T>::kBK;
  constexpr int kSubTiles = P::kSubTiles;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes of shared address: align
  // the rings to it so TMA's and wgmma's swizzles agree.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t a_ring = smem_addr(smem);
  const uint32_t b_ring = a_ring + P::kAStages * P::kABytes;
  const uint32_t full_a = a_ring + P::kDataBytes;  // kAStages mbarriers
  const uint32_t empty_a = full_a + 8 * P::kAStages;
  const uint32_t full_b = empty_a + 8 * P::kAStages;  // kBStages mbarriers
  const uint32_t empty_b = full_b + 8 * P::kBStages;

  const int nb = blockIdx.x % n_blocks;
  const int tile = blockIdx.x / n_blocks;
  const int y0 = (tile / tiles_w) * R;
  const int x0 = (tile % tiles_w) * kPcCols;
  const int n0 = nb * BN;
  const int img = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks =
      pieces.chunks[0] + (pieces.count > 1 ? pieces.chunks[1] : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kAStages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 4 * kPcConsumers);  // one arrival a warp
    }
    for (int s = 0; s < P::kBStages; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 4 * kPcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kPcProducerWarp) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap0))
                   : "memory");
      if (pieces.count > 1) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&xmap1))
                     : "memory");
      }
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      // Chunk q's A box (halo included) goes into A stage q % 2, then its 9
      // taps' B boxes into the B ring. A box is asked for one chunk
      // ahead, right after the previous chunk's first tap: its stage is
      // free once the consumers have started that tap (they release the
      // chunk before it then), and it lands while they run the other 8.
      auto load_a = [&](int q) {
        const int p = q < pieces.chunks[0] ? 0 : 1;
        const int c = p == 0 ? q : q - pieces.chunks[0];
        const int stage = q % P::kAStages;
        mbar_wait(empty_a + 8 * stage, ((q / P::kAStages) & 1) ^ 1);
        mbar_expect_tx(full_a + 8 * stage, P::kABoxBytes);
        tma_load_4d(a_ring + stage * P::kABytes, p == 0 ? &xmap0 : &xmap1,
                    full_a + 8 * stage, c * kBK, x0 - 1, y0 - 1, img);
      };
      int b_stage = 0;
      uint32_t b_phase = 0;
      load_a(0);
      for (int q = 0; q < chunks; ++q) {
        const int p = q < pieces.chunks[0] ? 0 : 1;
        const int c = p == 0 ? q : q - pieces.chunks[0];
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(empty_b + 8 * b_stage, b_phase ^ 1);
          mbar_expect_tx(full_b + 8 * b_stage, P::kBBytes);
          tma_load_2d(b_ring + b_stage * P::kBBytes, &wmap,
                      full_b + 8 * b_stage,
                      pieces.kcol[p] + tap * pieces.cpad[p] + c * kBK, n0);
          if (++b_stage == P::kBStages) {
            b_stage = 0;
            b_phase ^= 1;
          }
          if (tap == 0 && q + 1 < chunks) load_a(q + 1);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg, rows [wg kSubTiles, (wg + 1) kSubTiles) of
  // the block's R.
  auto sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kPcConsumers) : "memory");
  };
  const int wg = warp / 4;
  float acc[kSubTiles][BN / 2];
#pragma unroll
  for (int s = 0; s < kSubTiles; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.f;
  int b_stage = 0;
  uint32_t b_phase = 0;
  // The stages the group in flight reads: released once it is done.
  int held_b = -1, held_a = -1;
  constexpr int kSteps = kRowBytes / kKStepBytes;  // K steps a chunk
  constexpr int kStepChannels = kKStepBytes / (int)sizeof(T);
  // A chunk's 9 taps, each the first `steps` K steps of its box and B
  // stage, one commit group a tap.
  auto run_chunk = [&](uint32_t a_box, int a_stage, auto steps) {
    constexpr int kUsed = decltype(steps)::value;
    for (int tap = 0; tap < 9; ++tap) {
      mbar_wait(full_b + 8 * b_stage, b_phase);
      const int dy = tap / 3, dx = tap % 3;
      const uint32_t b = b_ring + b_stage * P::kBBytes;
#pragma unroll
      for (int s = 0; s < kSubTiles; ++s) fence_acc(acc[s]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < kSubTiles; ++s) {
        const uint32_t a =
            a_box +
            ((wg * kSubTiles + s + dy) * kPcHaloCols + dx) * kRowBytes;
#pragma unroll
        for (int k = 0; k < kUsed; ++k) {
          Wgmma<T, BN>::run(acc[s], smem_desc(a + k * kKStepBytes),
                            smem_desc(b + k * kKStepBytes));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < kSubTiles; ++s) fence_acc(acc[s]);
      // Keep this group in flight; the one before it is done, so its B
      // stage, and after a chunk's last tap its A stage, go back to the
      // producer.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0) {
        if (held_b >= 0) mbar_arrive(empty_b + 8 * held_b);
        if (held_a >= 0) mbar_arrive(empty_a + 8 * held_a);
      }
      held_b = b_stage;
      held_a = tap == 8 ? a_stage : -1;
      if (++b_stage == P::kBStages) {
        b_stage = 0;
        b_phase ^= 1;
      }
    }
  };
  for (int q = 0; q < chunks; ++q) {
    const int a_stage = q % P::kAStages;
    mbar_wait(full_a + 8 * a_stage, (q / P::kAStages) & 1);
    const uint32_t a_box = a_ring + a_stage * P::kABytes;
    if constexpr (sizeof(T) == 4) {
      // TF32: round the box in place, once for its 9 taps, then hand it to
      // the async proxy that wgmma reads through.
      float4* box = reinterpret_cast<float4*>(smem + a_stage * P::kABytes);
      for (int i = threadIdx.x; i < P::kABoxBytes / 16;
           i += 128 * kPcConsumers) {
        float4 v = box[i];
        v.x = round_tf32(v.x);
        v.y = round_tf32(v.y);
        v.z = round_tf32(v.z);
        v.w = round_tf32(v.w);
        box[i] = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sync();
    }
    // The chunk's K steps that hold channels: a piece's last chunk may end
    // early, its zero-filled steps left out (3 of 4 run as 4).
    const int p = q < pieces.chunks[0] ? 0 : 1;
    const int valid =
        pieces.channels[p] - (p == 0 ? q : q - pieces.chunks[0]) * kBK;
    const int steps = (valid + kStepChannels - 1) / kStepChannels;
    if (steps > 2) {
      run_chunk(a_box, a_stage, std::integral_constant<int, kSteps>());
    } else if (steps == 2) {
      run_chunk(a_box, a_stage, std::integral_constant<int, 2>());
    } else {
      run_chunk(a_box, a_stage, std::integral_constant<int, 1>());
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kSubTiles; ++s) fence_acc(acc[s]);

  // Both warpgroups are done with the rings; they now hold the f32 tile,
  // row m = pixel (m / 64, m % 64) of the block. Accumulator layout of
  // wgmma m64nN: register 4j + r of thread (warp w, lane l) is row
  // 16 (w % 4) + l / 4 + 8 (r / 2), column 8 j + 2 (l % 4) + r % 2.
  sync();
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int s = 0; s < kSubTiles; ++s) {
    const int row =
        (wg * kSubTiles + s) * kPcCols + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(Cs + row * P::kCStride + col) =
          make_float2(acc[s][4 * j], acc[s][4 * j + 1]);
      *reinterpret_cast<float2*>(Cs + (row + 8) * P::kCStride + col) =
          make_float2(acc[s][4 * j + 2], acc[s][4 * j + 3]);
    }
  }
  sync();
  constexpr int kVecs = BN / 4;
  for (int i = threadIdx.x; i < R * kPcCols * kVecs; i += 128 * kPcConsumers) {
    const int m = i / kVecs, n = (i % kVecs) * 4;
    float4 v = *reinterpret_cast<const float4*>(Cs + m * P::kCStride + n);
    const float4 bv = *reinterpret_cast<const float4*>(bias + n0 + n);
    v.x = leaky(v.x + bv.x, slope);
    v.y = leaky(v.y + bv.y, slope);
    v.z = leaky(v.z + bv.z, slope);
    v.w = leaky(v.w + bv.w, slope);
    const int yy = y0 + m / kPcCols, xx = x0 + m % kPcCols;
    if (yy < H && xx < W) {
      store4(out + (((int64_t)img * H + yy) * W + xx) * Cout + n0 + n, v);
    }
  }
}

template <typename T, int R, int BN>
int launch_plan(const void* const* x, const Pieces& pieces, const int* c,
                const void* w, const void* bias, void* out, int N, int H,
                int W, int Cout, float slope, int device,
                cudaStream_t stream) {
  using P = Plan<R, BN>;
  constexpr int kBK = Operand<T>::kBK;
  const cuuint64_t e = sizeof(T);
  CUtensorMap xmaps[kMaxPieces], wmap;
  for (int p = 0; p < kMaxPieces; ++p) {
    // An absent second piece takes the first's map; the K loop never
    // reads it.
    const int q = p < pieces.count ? p : 0;
    const cuuint64_t dims[4] = {(cuuint64_t)c[q], (cuuint64_t)W,
                                (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {c[q] * e, (cuuint64_t)W * c[q] * e,
                                   (cuuint64_t)H * W * c[q] * e};
    const cuuint32_t box[4] = {kBK, kPcHaloCols, R + 2, 1};
    if (!encode<T>(&xmaps[p], x[q], 4, dims, strides, box)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int k = pieces.kcol[pieces.count - 1] +
                9 * pieces.cpad[pieces.count - 1];
  const cuuint64_t wdims[2] = {(cuuint64_t)k, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)k * e};
  const cuuint32_t wbox[2] = {kBK, BN};
  if (!encode<T>(&wmap, w, 2, wdims, wstrides, wbox)) {
    return (int)cudaErrorInvalidValue;
  }
  // Raised once per device for this instance, as conv3x3.cu's launch does.
  static std::atomic<bool> smem_raised[kMaxDevices];
  const bool kept = device >= 0 && device < kMaxDevices;
  if (!kept || !smem_raised[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_pieces_wgmma_kernel<T, R, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (kept) smem_raised[device].store(true, std::memory_order_relaxed);
  }
  const int tiles_w = (W + kPcCols - 1) / kPcCols;
  const int tiles_h = (H + R - 1) / R;
  const int n_blocks = Cout / BN;
  const dim3 grid((unsigned)((int64_t)tiles_w * tiles_h * n_blocks), N);
  conv3x3_pieces_wgmma_kernel<T, R, BN>
      <<<grid, kPcThreads, P::kSmem, stream>>>(
          xmaps[0], xmaps[1], wmap, pieces, static_cast<const float*>(bias),
          static_cast<T*>(out), H, W, Cout, tiles_w, n_blocks, slope);
  return (int)cudaGetLastError();
}

// The tile plan (R rows of 64 columns, an N tile of BN) for N images of
// H x W and Cout output channels on a device of `sms` SMs, as the header
// says: Cout 32 and 64 take BN = Cout on 8 rows where that grid fills 3/4
// of the SMs; otherwise the widest tile whose grid fills them, BN = 256 on
// 2 rows, then 128 on 4 rows and on 2, then 64 on 4; else BN = 64 (32) on
// 2 rows, two blocks an SM. The grid's last wave is not weighed.
void choose_plan(int N, int H, int W, int Cout, int sms, int* r, int* bn) {
  const int64_t rows8 = (H + 7) / 8, rows4 = (H + 3) / 4;
  const int64_t rows2 = (H + 1) / 2;
  const int64_t tiles_w = (W + kPcCols - 1) / kPcCols;
  auto fills = [&](int64_t rows, int b) {
    return 4 * rows * tiles_w * N * (Cout / b) >= 3 * (int64_t)sms;
  };
  *r = 2;
  *bn = 64;
  if (Cout % 64 != 0) {
    *r = fills(rows8, 32) ? 8 : 2;
    *bn = 32;
  } else if (Cout == 64 && fills(rows8, 64)) {
    *r = 8;
  } else if (Cout % 256 == 0 && fills(rows2, 256)) {
    *bn = 256;
  } else if (Cout % 128 == 0 && fills(rows4, 128)) {
    *r = 4;
    *bn = 128;
  } else if (Cout % 128 == 0 && fills(rows2, 128)) {
    *bn = 128;
  } else if (fills(rows4, 64)) {
    *r = 4;
  }
}

// The device's SM count for choose_plan.
cudaError_t device_sms(int* device, int* sms) {
  cudaError_t err = cudaGetDevice(device);
  return err == cudaSuccess ? sm_count(*device, sms) : err;
}

template <typename T>
int launch_pieces(const void* x0, const void* x1, int c0, int c1,
                  const void* w, const void* bias, void* out, int N, int H,
                  int W, int Cout, float slope, void* stream) {
  constexpr int kBK = Operand<T>::kBK;
  const int count = x1 == nullptr ? 1 : 2;
  const int c[kMaxPieces] = {c0, c1};
  if (N < 1 || H < 1 || W < 1 || N > 65535 || Cout < 32 || Cout % 32 != 0 ||
      c0 < 16 || c0 % 16 != 0 || (count == 2 && (c1 < 16 || c1 % 16 != 0)) ||
      (count == 1 && c1 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  Pieces pieces = {count, {c0, c1}, {0, 0}, {0, 0}, {0, 0}};
  int64_t k = 0;
  for (int p = 0; p < count; ++p) {
    pieces.chunks[p] = (c[p] + kBK - 1) / kBK;
    pieces.cpad[p] = pieces.chunks[p] * kBK;
    pieces.kcol[p] = (int)k;
    k += 9 * pieces.cpad[p];
  }
  const int64_t tiles_w = (W + kPcCols - 1) / kPcCols;
  if (k > 0x7FFFFFFF || (H + 1) / 2 * tiles_w * (Cout / 32) > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0, r = 0, bn = 0;
  cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return (int)err;
  choose_plan(N, H, W, Cout, sms, &r, &bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* x[kMaxPieces] = {x0, x1};
  switch (r * 1000 + bn) {
    case 8032:
      return launch_plan<T, 8, 32>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                   slope, device, s);
    case 2032:
      return launch_plan<T, 2, 32>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                   slope, device, s);
    case 8064:
      return launch_plan<T, 8, 64>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                   slope, device, s);
    case 2256:
      return launch_plan<T, 2, 256>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                    slope, device, s);
    case 4128:
      return launch_plan<T, 4, 128>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                    slope, device, s);
    case 2128:
      return launch_plan<T, 2, 128>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                    slope, device, s);
    case 4064:
      return launch_plan<T, 4, 64>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                   slope, device, s);
    default:
      return launch_plan<T, 2, 64>(x, pieces, c, w, bias, out, N, H, W, Cout,
                                   slope, device, s);
  }
}

}  // namespace

// bf16 in and out, wgmma on bf16 with f32 accumulators. x0 (N, H, W, C0)
// and x1 (N, H, W, C1), or x1 NULL and C1 0 for one piece; w (Cout, K)
// packed as the header says; out (N, H, W, Cout).
extern "C" int fi_conv3x3_pieces_bf16(const void* x0, const void* x1, int C0,
                                      int C1, const void* w, const void* bias,
                                      void* out, int N, int H, int W,
                                      int Cout, float slope, void* stream) {
  return launch_pieces<__nv_bfloat16>(x0, x1, C0, C1, w, bias, out, N, H, W,
                                      Cout, slope, stream);
}

// f32 in and out, wgmma in TF32 with f32 accumulators; w already rounded
// to TF32 (ties away from zero), x rounded in the kernel.
extern "C" int fi_conv3x3_pieces_tf32(const void* x0, const void* x1, int C0,
                                      int C1, const void* w, const void* bias,
                                      void* out, int N, int H, int W,
                                      int Cout, float slope, void* stream) {
  return launch_pieces<float>(x0, x1, C0, C1, w, bias, out, N, H, W, Cout,
                              slope, stream);
}

// The tile plan both entry points take for N images of H x W and Cout
// output channels on the current device: *rows (2, 4 or 8) rows of 64
// columns and an N tile of *bn (32 to 256) channels. For the card's checks,
// which must cover every plan the main path takes.
extern "C" int fi_conv3x3_pieces_plan(int N, int H, int W, int Cout,
                                      int* rows, int* bn) {
  if (N < 1 || H < 1 || W < 1 || Cout < 32 || Cout % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return (int)err;
  choose_plan(N, H, W, Cout, sms, rows, bn);
  return 0;
}
