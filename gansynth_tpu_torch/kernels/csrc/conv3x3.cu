// K2: NHWC stride-1 SAME 3x3 convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel gansynth_tpu/kernels/pallas_conv.py:
// _conv3x3_pallas (and _conv3x3_pallas_paired, the same function for
// C_in = 64), behind conv3x3_same. It computes
//
//   y[b, h, w, o] = sum_{dy, dx, i} x[b, h + dy - 1, w + dx - 1, i] * k[dy, dx, o, i]
//
// with zero padding outside the image, f32 accumulation and the output in
// x's type (f32 or bf16). x [B, H, W, C_in] and y [B, H, W, C_out] are
// contiguous NHWC; k is [3, 3, C_out, C_in] (HWOI), contiguous, in x's type.
// f32 takes any H, W, C_in and C_out (the backward pass calls this kernel
// with the channel counts swapped; every tile edge is masked); bf16 takes
// any H and W and channel counts that are multiples of 8 (TMA's 16-byte
// strides), which every launch of the training step meets.
//
// What bounds it on an H100: at the flagship's critic shapes (C_in and C_out
// 128 or 256) the function does 18 * C_in * C_out operations per output
// pixel against 2 * (C_in + C_out) bytes of compulsory traffic in bf16, so
// operations bound it at the bf16 tensor-core rate (989 TFLOP/s) and, in
// f32, at the 67 TFLOP/s FMA rate. What bounds this design is the traffic
// from L2 into shared memory: each 128-pixel tile reads its input once per
// tap and the whole weight tensor once, 48 KB per 4.2 MFLOP at
// [8, 64, 512, 128] -> 256 (1.8 GB a call, ~6.3 TB/s at the measured
// 0.28 ms). The TPU layout (a flat padded row axis, a +8-row DMA overrun,
// pixel pairing) does not carry over.
//
// Design, an implicit GEMM: M = output pixels, N = output channels, K = 9
// taps x C_in in 64-channel chunks (one 128-byte row per pixel).
//  - bf16 (the training path), on Hopper's parts (hopper.cuh): a
//    persistent grid, one block of three warpgroups per SM, walks tiles of
//    2 x 64 output pixels x BN output channels (BN = 256 when C_out > 128,
//    else 128). A producer thread keeps a ring of 4 (BN = 256) or 6 stages
//    full with TMA: per (tap, chunk) one 4D box {64, 64, 2, 1} of x at
//    (c0, x0 + dx - 1, y0 + dy - 1, b) and one 3D box {64, BN, 1} of the
//    weights [9, C_out, C_in], both with the 128-byte swizzle. TMA fills
//    coordinates outside the tensor, negative ones included, with zeros:
//    that is the SAME padding and the ragged C_in, C_out and image edges,
//    with no masks and no staging through registers. Full and empty
//    mbarriers guard each stage. Two consumer warpgroups (one output row
//    each; setmaxnreg moves registers from the producer to them) run
//    wgmma m64nBNk16 with both operands in shared memory into f32
//    accumulators, keep one chunk's MMAs in flight while the next stage
//    arrives, and free a stage when its MMAs are done; the producer runs
//    on into the next tile while they round to bf16 and store (masked).
//  - f32 (the parity path): the same tiling idea on the FMA units. A
//    block of 128 threads owns 4 x 32 pixels and 64 channels, walks C_in
//    in chunks of 8 staged as f32 ([8][6][34] and [9][8][64]), and each
//    thread accumulates 8 pixels x 8 channels over the nine taps: 64 FMAs
//    per 10 shared-memory loads.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int TH = 4;        // output rows of a tile
constexpr int TW = 32;       // output columns of a tile
constexpr int TC = 64;       // output channels of a tile
constexpr int KC = 8;        // input channels of one shared-memory chunk
constexpr int PX = 8;        // pixels per thread (one row, stride 4)
constexpr int CX = 8;        // output channels per thread
constexpr int kThreads = 128;
constexpr int HH = TH + 2;   // tile rows with the halo
constexpr int HW = TW + 2;   // tile columns with the halo

static_assert((TH * TW / PX) * (TC / CX) == kThreads, "thread layout");

// ---- f32: FMA path ----

__global__ void __launch_bounds__(kThreads)
conv3x3_nhwc_f32_fma(const float* __restrict__ x, const float* __restrict__ k,
                     float* __restrict__ y, int height, int width, int c_in,
                     int c_out) {
  __shared__ float xs[KC][HH][HW];
  __shared__ __align__(16) float ws[9][KC][TC];

  const int tid = threadIdx.x;
  const int tiles_w = (width + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int b = blockIdx.z;

  // Thread layout: 8 output-channel groups x 16 pixel groups. Pixel group
  // pg holds row pg / 4 and columns pg % 4 + 4 * j, so the four pixel
  // groups of a warp read four neighbouring columns.
  const int cg = tid % (TC / CX);
  const int pg = tid / (TC / CX);
  const int row = pg / 4;
  const int col = pg % 4;

  float acc[PX][CX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
#pragma unroll
    for (int i = 0; i < CX; ++i) acc[j][i] = 0.0f;
  }

  const size_t image = static_cast<size_t>(b) * height * width;
  for (int ci0 = 0; ci0 < c_in; ci0 += KC) {
    // Input chunk with its halo; consecutive threads read consecutive
    // channels of a pixel.
    for (int e = tid; e < KC * HH * HW; e += kThreads) {
      const int kk = e % KC;
      const int pix = e / KC;
      const int r = pix / HW;
      const int c = pix % HW;
      const int gy = y0 + r - 1;
      const int gx = x0 + c - 1;
      const int ci = ci0 + kk;
      float v = 0.0f;
      if (gy >= 0 && gy < height && gx >= 0 && gx < width && ci < c_in) {
        v = x[(image + static_cast<size_t>(gy) * width + gx) * c_in + ci];
      }
      xs[kk][r][c] = v;
    }
    // Weights of the chunk for all nine taps.
    for (int e = tid; e < 9 * KC * TC; e += kThreads) {
      const int co = e % TC;
      const int kk = (e / TC) % KC;
      const int tap = e / (TC * KC);
      const int ci = ci0 + kk;
      float v = 0.0f;
      if (ci < c_in && co0 + co < c_out) {
        v = k[(static_cast<size_t>(tap) * c_out + co0 + co) * c_in + ci];
      }
      ws[tap][kk][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w_lo =
              *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][kk][cg * CX]);
          const float4 w_hi = *reinterpret_cast<const float4*>(
              &ws[dy * 3 + dx][kk][cg * CX + 4]);
          const float w[CX] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w,
                               w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float a = xs[kk][row + dy][col + 4 * j + dx];
#pragma unroll
            for (int i = 0; i < CX; ++i) acc[j][i] = fmaf(a, w[i], acc[j][i]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + row;
  if (gy >= height) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int gx = x0 + col + 4 * j;
    if (gx >= width) continue;
    float* out = y + (image + static_cast<size_t>(gy) * width + gx) * c_out;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int co = co0 + cg * CX + i;
      if (co < c_out) out[co] = acc[j][i];
    }
  }
}

// ---- bf16: TMA + wgmma path ----

constexpr int WG_TH = 2;          // output rows of a tile, one per consumer
constexpr int WG_TW = 64;         // output columns of a tile (one wgmma M)
constexpr int WG_KC = 64;         // input channels of a K chunk (128 bytes)
constexpr int WG_THREADS = 384;   // producer + two consumer warpgroups
constexpr uint32_t WG_A_BYTES = WG_TH * WG_TW * WG_KC * 2;   // 16 KB
constexpr int WG_RELEASES = 8;    // arrivals that free a stage: 8 warps

template <int BN>
struct WgConfig {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr uint32_t kBBytes = BN * WG_KC * 2;
  static constexpr uint32_t kStageBytes = WG_A_BYTES + kBBytes;
  // Stages, two barriers per stage, and slack to align the base to 1024.
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
};

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3x3_nhwc_bf16_wgmma(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map,
                        __nv_bfloat16* __restrict__ y, int batch, int height,
                        int width, int c_in, int c_out) {
  using Cfg = WgConfig<BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_tiles = hopper::align1024(smem_raw);   // [S][128][64]
  unsigned char* b_tiles = a_tiles + S * WG_A_BYTES;      // [S][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_tiles + S * Cfg::kBBytes);
  uint64_t* empty = full + S;

  // Output tiles, x-tile fastest (neighbouring blocks read neighbouring
  // pixels at the same time), walked by a persistent grid.
  const int tiles_w = (width + WG_TW - 1) / WG_TW;
  const int tiles_h = (height + WG_TH - 1) / WG_TH;
  const int tiles_n = (c_out + BN - 1) / BN;
  const int tiles = tiles_w * tiles_h * tiles_n * batch;
  const int chunks = (c_in + WG_KC - 1) / WG_KC;
  const int iters = 9 * chunks;   // (tap, chunk) pairs of a tile, tap-major
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WG_RELEASES);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full, running ahead into the
    // next tile while the consumers store this one. For tap (dy, dx) and
    // chunk c0 the A box starts at pixel (y0 + dy - 1, x0 + dx - 1); TMA
    // fills what lies outside the image (the SAME padding) and past C_in
    // with zeros.
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&x_map);
      hopper::tma_prefetch(&w_map);
      int it = 0;   // stages filled, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int r = tile;
        const int x0 = (r % tiles_w) * WG_TW;
        r /= tiles_w;
        const int y0 = (r % tiles_h) * WG_TH;
        r /= tiles_h;
        const int n0 = (r % tiles_n) * BN;
        const int b = r / tiles_n;
        for (int k = 0; k < iters; ++k, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], ((it / S) - 1) & 1);
          const int tap = k / chunks;
          const int c0 = (k % chunks) * WG_KC;
          hopper::mbar_arrive_expect_tx(&full[s], Cfg::kStageBytes);
          hopper::tma_load_4d(a_tiles + s * WG_A_BYTES, &x_map, &full[s], c0,
                              x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
          hopper::tma_load_3d(b_tiles + s * Cfg::kBBytes, &w_map, &full[s],
                              c0, n0, tap);
        }
      }
    }
  } else {
    // Consumer c owns output row y0 + c of a tile: A rows 64c .. 64c + 63.
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    int it = 0;   // stages consumed, over all of this block's tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int k = 0; k < iters; ++k, ++it) {
        const int s = it % S;
        hopper::mbar_wait(&full[s], (it / S) & 1);
        const uint64_t da =
            hopper::sw128_desc(a_tiles + s * WG_A_BYTES + c * (WG_TW * 128));
        const uint64_t db = hopper::sw128_desc(b_tiles + s * Cfg::kBBytes);
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_KC / 16; ++kk) {
          if constexpr (BN == 256) {
            hopper::wgmma_ss_n256(acc, da + 2 * kk, db + 2 * kk, 1);
          } else {
            hopper::wgmma_ss_n128(acc, da + 2 * kk, db + 2 * kk, 1);
          }
        }
        hopper::wgmma_commit();
        // The previous chunk's MMAs are done: free its stage.
        hopper::wgmma_wait<1>();
        hopper::fence_operands(acc);
        if (k > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);

      // Epilogue: accumulator i of this thread is row 16 warp + lane / 4
      // (+ 8 for i % 4 >= 2), channel 8 (i / 4) + 2 (lane % 4) + i % 2.
      int r = tile;
      const int x0 = (r % tiles_w) * WG_TW;
      r /= tiles_w;
      const int gy = (r % tiles_h) * WG_TH + c;
      r /= tiles_h;
      const int n0 = (r % tiles_n) * BN;
      const int b = r / tiles_n;
      if (gy >= height) continue;
      const size_t row = (static_cast<size_t>(b) * height + gy) * width;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = x0 + warp * 16 + lane / 4 + 8 * h;
        if (gx >= width) continue;
        __nv_bfloat16* out = y + (row + gx) * c_out;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = n0 + 8 * j + 2 * (lane % 4);
          if (co < c_out) {   // c_out % 8 == 0, so co + 1 < c_out too
            *reinterpret_cast<__nv_bfloat162*>(out + co) = __floats2bfloat162_rn(
                acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

template <int BN>
int launch_bf16(const void* x, const void* k, void* y, int batch, int height,
                int width, int c_in, int c_out, cudaStream_t stream) {
  using Cfg = WgConfig<BN>;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {
      static_cast<cuuint64_t>(c_in), static_cast<cuuint64_t>(width),
      static_cast<cuuint64_t>(height), static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[3] = {
      2ull * c_in, 2ull * c_in * width, 2ull * c_in * width * height};
  const cuuint32_t x_box[4] = {WG_KC, WG_TW, WG_TH, 1};
  int err = hopper::encode_bf16_sw128(&x_map, x, 4, x_dims, x_strides, x_box);
  if (err != 0) return err;
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(c_in),
                                static_cast<cuuint64_t>(c_out), 9};
  const cuuint64_t w_strides[2] = {2ull * c_in, 2ull * c_in * c_out};
  const cuuint32_t w_box[3] = {WG_KC, BN, 1};
  err = hopper::encode_bf16_sw128(&w_map, k, 3, w_dims, w_strides, w_box);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_nhwc_bf16_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long tiles = static_cast<long>((height + WG_TH - 1) / WG_TH) *
                     ((width + WG_TW - 1) / WG_TW) * ((c_out + BN - 1) / BN) *
                     batch;
  const int sms = hopper::sm_count();
  if (sms <= 0 || tiles > (1l << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  conv3x3_nhwc_bf16_wgmma<BN><<<grid, WG_THREADS, Cfg::kSmem, stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(y), batch, height, width,
      c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int batch, int height, int width, int c_in, int c_out) {
  return batch <= 0 || height <= 0 || width <= 0 || c_in <= 0 || c_out <= 0 ||
         batch > 65535;
}

}  // namespace

extern "C" {

// x [batch, height, width, c_in], k [3, 3, c_out, c_in], y [batch, height,
// width, c_out]; all contiguous, all f32 (or all bf16 for the _bf16 entry).
int conv3x3_nhwc_f32(const void* x, const void* k, void* y, int batch,
                     int height, int width, int c_in, int c_out,
                     void* stream) {
  if (bad_sizes(batch, height, width, c_in, c_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = ((height + TH - 1) / TH) * ((width + TW - 1) / TW);
  const dim3 grid(tiles, (c_out + TC - 1) / TC, batch);
  conv3x3_nhwc_f32_fma<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k),
      static_cast<float*>(y), height, width, c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}

int conv3x3_nhwc_bf16(const void* x, const void* k, void* y, int batch,
                      int height, int width, int c_in, int c_out,
                      void* stream) {
  // TMA needs 16-byte strides: C_in and C_out multiples of 8.
  if (bad_sizes(batch, height, width, c_in, c_out) || c_in % 8 || c_out % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c_out > 128
             ? launch_bf16<256>(x, k, y, batch, height, width, c_in, c_out, s)
             : launch_bf16<128>(x, k, y, batch, height, width, c_in, c_out, s);
}

// Dynamic shared memory of one bf16 block for this C_out, in bytes.
int conv3x3_nhwc_bf16_smem_bytes(int c_out) {
  return c_out > 128 ? WgConfig<256>::kSmem : WgConfig<128>::kSmem;
}

}  // extern "C"
