// K6: the weight gradient of WaveGAN's "SAME" stride-4, kernel-25 1-D
// convolution, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no WaveGAN. It takes the
// place of cuDNN's weight-gradient kernels under both forms the training
// step asks for the sum (kernels/conv1d_wgrad.py): the first-order dW
// (backward-filter) and the penalty's second-order term, which PyTorch's
// double backward computes as a stride-1, dilation-4 convolution of
// batch-transposed tensors; cuDNN runs both without tensor cores. It
// computes
//
//   dw[co, ci, k] = sum_{b, t} gy[b, t, co] * x[b, 4 t + k - 10, ci]
//
// for x [B, 4L, C_in] and gy [B, L, C_out], contiguous (the channels-last
// memory of the model's [B, C, 1, length] tensors), x read as zero outside
// rows 0..4L-1 (the SAME padding: 10 left, 11 right), dw [C_out, C_in, 25]
// in bf16 from float32 sums.
//
// The stride folds into the channels: x is xv [B, L, 4 C_in], the same
// memory. Tap k with k + 2 = 4 j + p (j = 0..6, p = 0..3) reads row
// t + j - 3 of xv at channel p C_in + ci, so dw is seven stride-1 products
// G_j [C_out, 4 C_in] = sum over the B L rows of gy^T times xv shifted by
// j - 3 rows; three of the 28 (j, p) slots are dead: (0, 0), (0, 1), (6, 3).
//
// What bounds it on an H100: at the critic's and the generator's widths
// (C_in 64-1024, C_out 128-2048, L 4096-16, batch 64) each call is 107
// GFLOP over at most 12 MB of operands, so the bf16 tensor-core rate (989
// TFLOP/s), and the traffic from L2 into shared memory, which reads each
// operand tile once per output tile. For C_in = 1 (the critic's first
// layer, the generator's last) the call is 3.4 GFLOP over 142 MB at batch
// 64: bytes bound it.
//
// Design.
//  - 4 C_in a multiple of 8 and C_out a multiple of 8 (TMA's 16-byte
//    strides): a GEMM per tap, M = C_out, N = 4 C_in, K = the B L rows.
//    A persistent grid, one block of three warpgroups per SM, walks units
//    (split s, 128-row block of co, tap j, BN-wide block of n), skipping
//    the n blocks that hold only dead slots. A producer thread keeps a
//    ring of stages full with TMA: per 64-row K tile one box of gy for
//    each 64 co and one box of xv for each 64 n, the latter at row offset
//    j - 3 (each tap's tile loaded by its own TMA, L2 serving the repeats;
//    no shared-memory base is offset). A K tile is 64 rows of one batch
//    (L >= 64), or R rows of 64 / R batches, R the largest power of two
//    <= L: the boxes {64, R, 64 / R} keep the batches apart, and TMA's
//    zero fill outside rows 0..L-1 and past the batch is the SAME padding.
//    Both operands arrive MN-major (a row per K index, channels along the
//    row); two consumer warpgroups (64 co each) run wgmma m64nBNk16 with
//    both transpose flags into float32 accumulators and write them as the
//    unit's float32 partials [split, tap, C_out, 4 C_in].
//  - C_in = 1 (C_out even, at most 256): a CUDA-core kernel, one block of
//    16 warps an SM, a split each. A lane takes a pair of co and all 28
//    slots, a warp a run of consecutive rows: along the run the seven xv
//    rows a row reads sit in a ring of registers (one 8-byte load a row),
//    and the gy loads of 7 rows are in flight at once (gy is the 134 MB
//    of the call at batch 64). The block's runs are added in a fixed
//    order into the same partials.
//  - Split-K over the rows comes from the shape and the SM count: the
//    fewest splits that keep 85 % of the SMs busy over the last wave. A
//    last kernel adds the splits' partials in split order (no atomics, so
//    a replay is bit-reproducible), rounds to bf16 and writes dw in its
//    [C_out, C_in, 25] layout through shared memory.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// The fold, from the conv's kernel and stride (conv1d_wgrad.py derives
// the same numbers from its KERNEL and STRIDE): the SAME pad's left part
// (10), the rows before t that tap 0 reads (3), the slot 4 j + p of tap
// k = 0 (2), the row offsets of the folded conv (7) and the live p of its
// last one (3).
constexpr int kKernel = 25;
constexpr int kStride = 4;
constexpr int kLeft = (kKernel - kStride) / 2;
constexpr int kPast = (kLeft + kStride - 1) / kStride;
constexpr int kFirst = kStride * kPast - kLeft;
constexpr int kTaps = (kFirst + kKernel + kStride - 1) / kStride;
constexpr int kLastLive = kFirst + kKernel - kStride * (kTaps - 1);
constexpr int kSlots = kTaps * kStride;

constexpr int BM = 128;       // co of a unit: one 64-row block a consumer
constexpr int KR = 64;        // K rows of a stage
constexpr int MN = 64;        // channels of a 128-byte row
constexpr uint32_t kBox = KR * MN * 2;   // one TMA box, 8 KB
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr int kReleases = 8;             // arrivals that free a stage: 8 warps
constexpr int kMinBusy = 85;             // percent of SMs a split plan keeps busy

// the C_in = 1 kernel: one block an SM, a split each
constexpr int kNarrowThreads = 512;

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr uint32_t kStageBytes = (BM / MN + BN / MN) * kBox;
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
};

// The work of one call, from its shape and the SM count.
struct Plan {
  int batch, length, n4, c_out;
  int rows;       // R: rows of one batch in a K tile
  int group;      // 64 / R batches in a K tile
  int t_tiles;    // K tiles along a batch's rows
  int k_tiles;    // K tiles in all
  int m_blocks;   // 128-row blocks of co
  int bn;         // n a unit (256 or 128); 0 for the C_in = 1 kernel
  int n_lo[kTaps], n_count[kTaps];   // each tap's live n blocks
  int per_m;      // live (tap, n block) pairs: units a split and m block
  int units;      // units a split
  int splits;
};

int ceil_div(long a, long b) { return static_cast<int>((a + b - 1) / b); }

// Share of the SMs busy over a persistent grid's waves, in percent.
long busy(long units, int sms) {
  const long waves = (units + sms - 1) / sms;
  return 100 * units / (waves * sms);
}

bool make_plan(Plan& p, int batch, int length, int c_in, int c_out,
               int sms) {
  if (batch <= 0 || length <= 0 || c_in <= 0 || c_out <= 0 || sms <= 0 ||
      batch > 65535) {
    return false;
  }
  p = Plan{};
  p.batch = batch;
  p.length = length;
  p.n4 = kStride * c_in;
  p.c_out = c_out;
  if (c_in == 1) {   // the CUDA-core kernel: a split a block
    if (c_out > 256 || c_out % 2) return false;   // 4-byte gy pairs
    const long rows = static_cast<long>(batch) * length;
    p.splits = static_cast<int>(rows < static_cast<long>(kNarrowThreads) * sms
                                    ? ceil_div(rows, kNarrowThreads)
                                    : sms);
    return true;
  }
  if (c_in % 2 || c_out % 8) return false;   // 16-byte TMA strides
  p.rows = 64;
  while (p.rows > length) p.rows /= 2;
  p.group = 64 / p.rows;
  p.t_tiles = ceil_div(length, p.rows);
  p.k_tiles = ceil_div(batch, p.group) * p.t_tiles;
  p.m_blocks = ceil_div(c_out, BM);
  p.bn = p.n4 > 128 ? 256 : 128;
  for (int j = 0; j < kTaps; ++j) {
    // live columns: tap 0 has p = 2, 3; tap 6 has p = 0, 1, 2
    const long lo = j == 0 ? static_cast<long>(kFirst) * c_in : 0;
    const long hi = j == kTaps - 1 ? static_cast<long>(kLastLive) * c_in
                                   : p.n4;
    p.n_lo[j] = static_cast<int>(lo / p.bn);
    p.n_count[j] = ceil_div(hi, p.bn) - p.n_lo[j];
    p.per_m += p.n_count[j];
  }
  p.units = p.m_blocks * p.per_m;
  int best = 1;
  for (int s = 1; s <= p.k_tiles && s <= 32; ++s) {
    const long b = busy(static_cast<long>(p.units) * s, sms);
    if (b >= kMinBusy) {
      best = s;
      break;
    }
    if (b > busy(static_cast<long>(p.units) * best, sms)) best = s;
  }
  p.splits = best;
  return static_cast<long>(p.units) * p.splits < (1l << 31);
}

// ---- 4 C_in, C_out multiples of 8: TMA + wgmma ----

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv1d_wgrad_wgmma(const __grid_constant__ CUtensorMap gy_map,
                   const __grid_constant__ CUtensorMap x_map,
                   float* __restrict__ partials, const Plan plan) {
  using C = Cfg<BN>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // a stage: [2 gy boxes | BN / 64 xv boxes], each [64 rows][64 channels]
  unsigned char* stages = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + S * C::kStageBytes);
  uint64_t* empty = full + S;

  const int total = plan.units * plan.splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kReleases);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // unit u: split u / units, then co block, then (tap, n block)
  auto decode = [&](int u, int& split, int& m0, int& tap, int& n0, int& q0,
                    int& q1) {
    split = u / plan.units;
    int r = u % plan.units;
    m0 = (r / plan.per_m) * BM;
    r %= plan.per_m;
    tap = 0;
    while (r >= plan.n_count[tap]) r -= plan.n_count[tap++];
    n0 = (plan.n_lo[tap] + r) * BN;
    q0 = static_cast<int>(static_cast<long>(split) * plan.k_tiles /
                          plan.splits);
    q1 = static_cast<int>(static_cast<long>(split + 1) * plan.k_tiles /
                          plan.splits);
  };

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&gy_map);
      hopper::tma_prefetch(&x_map);
      int it = 0;   // stages filled, over all of this block's units
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        int split, m0, tap, n0, q0, q1;
        decode(u, split, m0, tap, n0, q0, q1);
        for (int q = q0; q < q1; ++q, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) - 1) & 1);
          const int b0 = (q / plan.t_tiles) * plan.group;
          const int t0 = (q % plan.t_tiles) * plan.rows;
          unsigned char* st = stages + s * C::kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
          for (int i = 0; i < BM / MN; ++i) {
            hopper::tma_load_3d(st + i * kBox, &gy_map, &full[s], m0 + MN * i,
                                t0, b0);
          }
#pragma unroll
          for (int i = 0; i < BN / MN; ++i) {
            hopper::tma_load_3d(st + (BM / MN + i) * kBox, &x_map, &full[s],
                                n0 + MN * i, t0 + tap - kPast, b0);
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;   // co rows m0 + 64 c .. m0 + 64 c + 63
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    int it = 0;   // stages consumed, over all of this block's units
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      int split, m0, tap, n0, q0, q1;
      decode(u, split, m0, tap, n0, q0, q1);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int q = q0; q < q1; ++q, ++it) {
        const int s = it % S;
        hopper::mbar_wait(&full[s], (it / S) & 1);
        unsigned char* st = stages + s * C::kStageBytes;
        const uint64_t da = hopper::sw128_desc_mn(st + c * kBox, kBox);
        const uint64_t db = hopper::sw128_desc_mn(st + (BM / MN) * kBox, kBox);
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KR / 16; ++kk) {
          if constexpr (BN == 256) {
            hopper::wgmma_ss_n256<1>(acc, da + 128 * kk, db + 128 * kk, 1);
          } else {
            hopper::wgmma_ss_n128<1>(acc, da + 128 * kk, db + 128 * kk, 1);
          }
        }
        hopper::wgmma_commit();
        // the previous K tile's MMAs are done: free its stage
        hopper::wgmma_wait<1>();
        hopper::fence_operands(acc);
        if (q > q0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);

      // accumulator i: co row 16 warp + lane / 4 (+ 8 for i % 4 >= 2),
      // n column 8 (i / 4) + 2 (lane % 4) + i % 2
      float* out = partials + (static_cast<size_t>(split) * kTaps + tap) *
                                  plan.c_out * plan.n4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = m0 + MN * c + 16 * warp + lane / 4 + 8 * h;
        if (co >= plan.c_out) continue;
        float* row = out + static_cast<size_t>(co) * plan.n4;
#pragma unroll
        for (int g = 0; g < BN / 8; ++g) {
          const int n = n0 + 8 * g + 2 * (lane % 4);
          if (n < plan.n4) {   // n4 % 8 == 0, so n + 1 < n4 too
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// ---- C_in = 1: CUDA cores ----


// xv row r of all the batches' rows (4 samples, zeros outside 0..rows-1)
// into ring slot `slot`.
__device__ __forceinline__ void load_row(float (&ring)[kSlots], int slot,
                                         const uint2* __restrict__ xv, long r,
                                         long rows) {
  uint2 v = make_uint2(0u, 0u);
  if (r >= 0 && r < rows) v = xv[r];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  ring[4 * slot + 0] = __low2float(lo);
  ring[4 * slot + 1] = __high2float(lo);
  ring[4 * slot + 2] = __low2float(hi);
  ring[4 * slot + 3] = __high2float(hi);
}

// Block s sums rows [s rows / S, (s + 1) rows / S) of the B L rows q = b L +
// t into partials[s][j][co][p]. Warp w takes co chunk w % chunks (64 co,
// a pair a lane, one 4-byte gy load) and the (w / chunks)-th run of the
// block's consecutive rows. Along a run the xv rows q - 3 .. q + 3 sit in
// a ring of 7 slots, row r at slot (r - a) mod 7 for the run's first row
// a, so a row loads one xv row and, unrolled by 7, every slot index is a
// constant; a tap whose row leaves the batch (t + j - 3 outside 0..L-1)
// adds nothing. The gy loads of 7 rows are in flight at once.
__global__ void __launch_bounds__(kNarrowThreads, 1)
conv1d_wgrad_narrow(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ gy,
                    float* __restrict__ partials, const Plan plan) {
  constexpr int kWarps = kNarrowThreads / 32;
  constexpr int kHalf = kSlots / 2;
  __shared__ float red[kHalf * kNarrowThreads];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (plan.c_out + 63) / 64;
  const int runs = kWarps / chunks;   // warps a co chunk
  const int chunk = warp % chunks;
  const int run = warp / chunks;
  const int co = 64 * chunk + 2 * lane;   // and co + 1 (C_out is even)
  const int length = plan.length;
  const long rows = static_cast<long>(plan.batch) * length;
  const long q0 = blockIdx.x * rows / gridDim.x;
  const long q1 = (blockIdx.x + 1) * rows / gridDim.x;
  const long per = (q1 - q0 + runs - 1) / runs;
  const long a = min(q1, q0 + run * per);
  const long e = min(q1, a + per);
  float acc0[kSlots], acc1[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc0[i] = acc1[i] = 0.0f;
  if (run < runs && co < plan.c_out && a < e) {
    const uint2* xv = reinterpret_cast<const uint2*>(x);
    float ring[kSlots];
#pragma unroll
    for (int j = 0; j < kTaps - 1; ++j) {
      load_row(ring, (j + kTaps - kPast) % kTaps, xv, a + j - kPast, rows);
    }
    int t = static_cast<int>(a % length);
    for (long q = a; q < e; q += kTaps) {
      uint32_t g2[kTaps];
#pragma unroll
      for (int u = 0; u < kTaps; ++u) {
        g2[u] = q + u < e ? *reinterpret_cast<const uint32_t*>(
                                gy + (q + u) * plan.c_out + co)
                          : 0u;
      }
#pragma unroll
      for (int u = 0; u < kTaps; ++u) {
        if (q + u >= e) break;
        load_row(ring, (u + kTaps - 1 - kPast) % kTaps, xv,
                 q + u + kTaps - 1 - kPast, rows);
        const __nv_bfloat162 g =
            *reinterpret_cast<const __nv_bfloat162*>(&g2[u]);
        const float g0 = __low2float(g);
        const float g1 = __high2float(g);
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          const bool in = t + j - kPast >= 0 && t + j - kPast < length;
          const float h0 = in ? g0 : 0.0f;
          const float h1 = in ? g1 : 0.0f;
          const int slot = (u + j + kTaps - kPast) % kTaps;
#pragma unroll
          for (int p = 0; p < kStride; ++p) {
            acc0[4 * j + p] = fmaf(h0, ring[4 * slot + p], acc0[4 * j + p]);
            acc1[4 * j + p] = fmaf(h1, ring[4 * slot + p], acc1[4 * j + p]);
          }
        }
        if (++t == length) t = 0;
      }
    }
  }
  // the runs' sums in run order, a quarter of the slots at a time:
  // pass h of co + (h / 2), slots (h % 2) 14 .. + 13
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      red[i * kNarrowThreads + threadIdx.x] =
          h < 2 ? acc0[(h % 2) * kHalf + i] : acc1[(h % 2) * kHalf + i];
    }
    __syncthreads();
    for (int v = threadIdx.x; v < chunks * 32 * kHalf; v += kNarrowThreads) {
      const int i = v % kHalf;
      const int l = (v / kHalf) % 32;
      const int c = v / (kHalf * 32);
      const int o = 64 * c + 2 * l + h / 2;
      if (o >= plan.c_out) continue;
      float total = 0.0f;
      for (int r = 0; r < runs; ++r) {
        total += red[i * kNarrowThreads + (r * chunks + c) * 32 + l];
      }
      const int slot = (h % 2) * kHalf + i;
      // partials[s][j][o][p] with 4 j + p = slot
      partials[((static_cast<size_t>(blockIdx.x) * kTaps + slot / kStride) *
                    plan.c_out + o) * kStride + slot % kStride] = total;
    }
  }
}

// ---- the splits' sum, in dw's layout ----

constexpr int kFinishCi = 32;   // C_in of a block
constexpr int kFinishThreads = 128;

// Block (ci block, co): dw[co, ci0 + c, k] = sum over splits of
// partials[s][j][co][p C_in + ci0 + c], 4 j + p = k + 2.
__global__ void __launch_bounds__(kFinishThreads)
conv1d_wgrad_finish(const float* __restrict__ partials,
                    __nv_bfloat16* __restrict__ dw, int splits, int c_in,
                    int c_out) {
  __shared__ float out[kFinishCi * kKernel];
  const int co = blockIdx.y;
  const int ci0 = blockIdx.x * kFinishCi;
  const int width = min(kFinishCi, c_in - ci0);
  const size_t n4 = static_cast<size_t>(kStride) * c_in;
  const size_t tap_stride = static_cast<size_t>(c_out) * n4;
  const size_t split_stride = kTaps * tap_stride;
  for (int v = threadIdx.x; v < kKernel * kFinishCi; v += kFinishThreads) {
    const int k = v / kFinishCi;
    const int c = v % kFinishCi;
    if (c >= width) continue;
    const int slot = k + kFirst;
    const float* src = partials + (slot / kStride) * tap_stride + co * n4 +
                       static_cast<size_t>(slot % kStride) * c_in + ci0 + c;
    float total = 0.0f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) total += src[s * split_stride];
    out[c * kKernel + k] = total;
  }
  __syncthreads();
  __nv_bfloat16* dst = dw + (static_cast<size_t>(co) * c_in + ci0) * kKernel;
  for (int e = threadIdx.x; e < width * kKernel; e += kFinishThreads) {
    dst[e] = __float2bfloat16_rn(out[e]);
  }
}

template <int BN>
int launch_wgmma(const Plan& plan, const void* x, const void* gy,
                 float* partials, int sms, cudaStream_t stream) {
  using C = Cfg<BN>;
  CUtensorMap gy_map, x_map;
  const cuuint32_t box[3] = {MN, static_cast<cuuint32_t>(plan.rows),
                             static_cast<cuuint32_t>(plan.group)};
  const cuuint64_t gy_dims[3] = {static_cast<cuuint64_t>(plan.c_out),
                                 static_cast<cuuint64_t>(plan.length),
                                 static_cast<cuuint64_t>(plan.batch)};
  const cuuint64_t gy_strides[2] = {2ull * plan.c_out,
                                    2ull * plan.c_out * plan.length};
  int err = hopper::encode_bf16_sw128(&gy_map, gy, 3, gy_dims, gy_strides,
                                      box);
  if (err != 0) return err;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(plan.n4),
                                static_cast<cuuint64_t>(plan.length),
                                static_cast<cuuint64_t>(plan.batch)};
  const cuuint64_t x_strides[2] = {2ull * plan.n4,
                                   2ull * plan.n4 * plan.length};
  err = hopper::encode_bf16_sw128(&x_map, x, 3, x_dims, x_strides, box);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      conv1d_wgrad_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = plan.units * plan.splits;
  conv1d_wgrad_wgmma<BN><<<total < sms ? total : sms, kThreads, C::kSmem,
                           stream>>>(gy_map, x_map, partials, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Float32 slabs [C_out, 4 C_in, 7] of partial sums that one call writes
// (its splits), or 0 for a shape it does not take.
int conv1d_wgrad_splits(int batch, int length, int c_in, int c_out) {
  Plan plan;
  return make_plan(plan, batch, length, c_in, c_out, hopper::sm_count())
             ? plan.splits
             : 0;
}

// x [batch, 4 length, c_in], gy [batch, length, c_out] bf16, contiguous and
// 16-byte aligned; partials float32 [splits, 7, c_out, 4 c_in] scratch
// (conv1d_wgrad_splits); dw [c_out, c_in, 25] bf16.
int conv1d_wgrad_bf16(const void* x, const void* gy, void* partials,
                      void* dw, int batch, int length, int c_in, int c_out,
                      void* stream) {
  const int sms = hopper::sm_count();
  Plan plan;
  if (!make_plan(plan, batch, length, c_in, c_out, sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  int err;
  if (c_in == 1) {
    conv1d_wgrad_narrow<<<plan.splits, kNarrowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gy), part, plan);
    err = static_cast<int>(cudaGetLastError());
  } else if (plan.bn == 256) {
    err = launch_wgmma<256>(plan, x, gy, part, sms, s);
  } else {
    err = launch_wgmma<128>(plan, x, gy, part, sms, s);
  }
  if (err != 0) return err;
  const dim3 grid((c_in + kFinishCi - 1) / kFinishCi, c_out);
  conv1d_wgrad_finish<<<grid, kFinishThreads, 0, s>>>(
      part, static_cast<__nv_bfloat16*>(dw), plan.splits, c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one wgmma block of BN n (256 or 128), in bytes.
int conv1d_wgrad_smem_bytes(int bn) {
  return bn == 256 ? Cfg<256>::kSmem : Cfg<128>::kSmem;
}

}  // extern "C"
