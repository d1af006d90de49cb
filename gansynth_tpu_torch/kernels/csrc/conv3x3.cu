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
// Any H, W, C_in and C_out: the backward pass calls this kernel with the
// channel counts swapped, and the edges of every tile are masked.
//
// What bounds it on an H100: at the flagship's critic shapes (C_in and C_out
// 128 or 256) the function does 18 * C_in * C_out operations per output
// pixel against 2 * (C_in + C_out) bytes of compulsory traffic in bf16, so
// operations bound it at the bf16 tensor-core rate (989 TFLOP/s) and, in
// f32, at the 67 TFLOP/s FMA rate. The TPU layout (a flat padded row axis,
// a +8-row DMA overrun, pixel pairing) does not carry over.
//
// Design (simple and right first), an implicit-GEMM direct convolution:
// M = output pixels, N = output channels, K = 9 taps x C_in.
//  - bf16 (the training path): tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate). A block of 256 threads (8 warps) owns
//    4 x 32 output pixels and 128 output channels. For each chunk of 32
//    input channels it stages the input tile with a one-pixel halo
//    ([6 * 34 pixels][32 channels]) and the chunk's weights for all nine
//    taps ([9][128][32]) in shared memory, each row padded by 8 bf16 so
//    the fragment loads of a warp fall in 32 distinct banks. Each warp
//    owns one row of 32 pixels (two m16 tiles) and 64 channels (eight n8
//    tiles): 64 f32 accumulators a thread, 16 mma per 16-deep step,
//    reading A and B fragments straight from shared memory. No cp.async
//    pipelining, ldmatrix, wgmma or TMA yet: loads and math alternate
//    between two barriers, so the kernel stays well short of the bound.
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

// ---- bf16: mma.sync tensor-core path ----

constexpr int MT_TH = 4;                 // output rows of a tile
constexpr int MT_TW = 32;                // output columns of a tile
constexpr int MT_BN = 128;               // output channels of a tile
constexpr int MT_KC = 32;                // input channels of one chunk
constexpr int MT_KP = MT_KC + 8;         // padded row, bf16 (20 words)
constexpr int MT_HH = MT_TH + 2;
constexpr int MT_HW = MT_TW + 2;
constexpr int MT_THREADS = 256;
constexpr int MT_XS = MT_HH * MT_HW * MT_KP;   // bf16 elements
constexpr int MT_WS = 9 * MT_BN * MT_KP;
constexpr int MT_SMEM = 2 * (MT_XS + MT_WS);   // 108,480 bytes
constexpr int MT_RW = MT_KP / 2;               // row stride in 32-bit words

static_assert(MT_THREADS / 32 == MT_TH * (MT_BN / 64),
              "8 warps: 4 pixel rows x 2 halves of the channels");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive channels of one row of `src` (channels ci.. of a row
// of length `len`), zero past the end; one 16-byte load when aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int ci,
                                       int len, bool vec) {
  if (vec && ci + 8 <= len) return *reinterpret_cast<const uint4*>(src + ci);
  __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    tmp[q] = ci + q < len ? src[ci + q] : __float2bfloat16_rn(0.0f);
  }
  return *reinterpret_cast<const uint4*>(tmp);
}

__global__ void __launch_bounds__(MT_THREADS)
conv3x3_nhwc_bf16_mma(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ k,
                      __nv_bfloat16* __restrict__ y, int height, int width,
                      int c_in, int c_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = xs + MT_XS;
  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // mma group: fragment row / column
  const int t = lane & 3;    // thread in group: fragment k pair
  const int wm = warp % MT_TH;   // the warp's pixel row
  const int wn = warp / MT_TH;   // the warp's half of the 128 channels
  const int tiles_w = (width + MT_TW - 1) / MT_TW;
  const int y0 = (blockIdx.x / tiles_w) * MT_TH;
  const int x0 = (blockIdx.x % tiles_w) * MT_TW;
  const int co0 = blockIdx.y * MT_BN;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * width;
  const bool vec = c_in % 8 == 0;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    }
  }

  for (int ci0 = 0; ci0 < c_in; ci0 += MT_KC) {
    __syncthreads();  // the previous chunk's fragments are read
    for (int e = tid; e < MT_HH * MT_HW * (MT_KC / 8); e += MT_THREADS) {
      const int pix = e / (MT_KC / 8);
      const int v = e % (MT_KC / 8);
      const int gy = y0 + pix / MT_HW - 1;
      const int gx = x0 + pix % MT_HW - 1;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
        val = load8(x + (image + static_cast<size_t>(gy) * width + gx) * c_in,
                    ci0 + v * 8, c_in, vec);
      }
      *reinterpret_cast<uint4*>(xs + pix * MT_KP + v * 8) = val;
    }
    for (int e = tid; e < 9 * MT_BN * (MT_KC / 8); e += MT_THREADS) {
      const int v = e % (MT_KC / 8);
      const int row = e / (MT_KC / 8);   // tap * MT_BN + n
      const int co = co0 + row % MT_BN;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (co < c_out) {
        val = load8(k + (static_cast<size_t>(row / MT_BN) * c_out + co) * c_in,
                    ci0 + v * 8, c_in, vec);
      }
      *reinterpret_cast<uint4*>(ws + row * MT_KP + v * 8) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < MT_KC / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pa = (wm + dy) * MT_HW + 16 * i + g + dx;
          const int base = pa * MT_RW + ks * 8 + t;
          a[i][0] = xs32[base];
          a[i][1] = xs32[base + 8 * MT_RW];
          a[i][2] = xs32[base + 4];
          a[i][3] = xs32[base + 8 * MT_RW + 4];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nb =
              (tap * MT_BN + wn * 64 + j * 8 + g) * MT_RW + ks * 8 + t;
          const uint32_t b0 = ws32[nb];
          const uint32_t b1 = ws32[nb + 4];
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }
  }

  const int gy = y0 + wm;
  if (gy >= height) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + 16 * i + g + 8 * half;
      if (gx >= width) continue;
      __nv_bfloat16* out =
          y + (image + static_cast<size_t>(gy) * width + gx) * c_out;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + wn * 64 + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * half];
        const float v1 = acc[i][j][2 * half + 1];
        if (co + 1 < c_out && c_out % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < c_out) out[co] = __float2bfloat16_rn(v0);
          if (co + 1 < c_out) out[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
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
  if (bad_sizes(batch, height, width, c_in, c_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_nhwc_bf16_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((height + MT_TH - 1) / MT_TH) *
                    ((width + MT_TW - 1) / MT_TW);
  const dim3 grid(tiles, (c_out + MT_BN - 1) / MT_BN, batch);
  conv3x3_nhwc_bf16_mma<<<grid, MT_THREADS, MT_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(y),
      height, width, c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
