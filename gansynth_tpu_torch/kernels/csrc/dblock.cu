// K3: the stage-6 critic block, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel gansynth_tpu/kernels/pallas_dblock.py:
// _dblock_pallas, behind fused_dblock. For x [B, H, W, 64] NHWC it computes
// the chain of pallas_dblock.py:_literal_chain,
//
//   a0 = lrelu(conv3x3_same(x, k0) + b0)          [B, H, W, 64]
//   a1 = lrelu(conv3x3_same(a0, k1) + b1)         [B, H, W, C1]
//   y  = 2x2 mean pool of a1                       [B, H/2, W/2, C1]
//
// with f32 accumulation inside and y in x's type (f32 or bf16); a0 is
// rounded to x's type, as the chain stores it. k0 [3, 3, 64, 64] and
// k1 [3, 3, C1, 64] are HWOI, b0 [64] and b1 [C1], all contiguous and in
// x's type. H and W are even.
//
// What bounds it on an H100: at the flagship shape ([8, 128, 1024, 64] ->
// 128, bf16) the two convs are 232 GFLOP against 134 MB of input and 67 MB
// of output, so operations bound it at the bf16 tensor-core rate (about
// 0.23 ms). The point of the fusion, as on the TPU, is that a0 (16.7 MiB
// per image in bf16) and conv1's pre-pool activation never go to device
// memory: the only traffic is x read once and y written once.
//
// Design (simple and right first). One block of 256 threads owns a tile of
// 4 x 8 pooled outputs (8 x 16 conv1 outputs). It stages the input tile
// with a two-pixel halo (12 x 20 pixels, zeros outside the image) in shared
// memory once, computes conv0 + b0 + lrelu for the tile plus a one-pixel
// halo (10 x 18 a0 pixels) into shared memory, and zeroes the a0 values
// that fall outside the image, because conv1's SAME padding must see zeros
// there. It then computes conv1 + b1 + lrelu in chunks of 64 output
// channels, pools 2 x 2 and writes only the pooled tile. conv0 is
// recomputed on the halo (180 a0 pixels per 128 conv1 pixels).
//  - bf16 (the training path): tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate), everything staged as bf16 in rows of 64
//    channels padded to 72 (so a warp's fragment loads fall in 32 distinct
//    banks): the input tile (34,560 bytes), a0 (180 pixels padded to 12
//    m16 tiles, 27,648 bytes) and the weights of one conv for all nine
//    taps and 64 output channels (82,944 bytes; k0 whole, then k1 one
//    64-channel chunk at a time). conv0: each warp owns 3 m16 tiles x 32
//    channels; conv1: each warp owns one conv1 row (one m16 tile) x 64
//    channels, then writes lrelu(conv1 + b1) as f32 into the input tile's
//    space, and the block pools from there. 145,152 bytes of dynamic
//    shared memory, one block per SM; no pipelining yet.
//  - f32 (the parity path): the same tiles on the FMA units, staged as
//    f32 ([64][12][20] input, [64][10][18] a0, weights streamed in chunks
//    of 8 input channels, [9][8][64]); each thread owns a0 pixels and
//    8 channels in conv0, and one pooled pixel (its four conv1 pixels)
//    and 8 channels in conv1, and pools in registers. 125,952 bytes.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CIN = 64;          // input channels = conv0 output channels
constexpr int PH = 4;            // pooled rows of a tile
constexpr int PW = 8;            // pooled columns of a tile
constexpr int OH = 2 * PH;       // conv1 rows of a tile
constexpr int OW = 2 * PW;       // conv1 columns of a tile
constexpr int AH = OH + 2;       // a0 rows (one-pixel halo)
constexpr int AW = OW + 2;       // a0 columns
constexpr int XH = OH + 4;       // input rows (two-pixel halo)
constexpr int XW = OW + 4;       // input columns
constexpr int KC = 8;            // input channels of one weight chunk
constexpr int TC = 64;           // output channels of one weight chunk
constexpr int CX = 8;            // output channels per thread
constexpr int kThreads = 256;
constexpr int kA0Pixels = AH * AW;                    // 180
constexpr int kPixelGroups = kThreads / (TC / CX);    // 32
constexpr int kA0PerThread =
    (kA0Pixels + kPixelGroups - 1) / kPixelGroups;    // 6
constexpr int kXsFloats = CIN * XH * XW;
constexpr int kA0Floats = CIN * AH * AW;
constexpr int kWsFloats = 9 * KC * TC;
constexpr int kSmemBytes = 4 * (kXsFloats + kA0Floats + kWsFloats);

static_assert(PH * PW == kPixelGroups, "one pooled pixel per pixel group");
static_assert((kXsFloats + kA0Floats) % 4 == 0, "ws must be 16-byte aligned");

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : slope * v;
}

// ---- f32: FMA path ----

// Weights w [9][c_out_total][CIN] (HWOI), input channels ci0..ci0+KC and
// output channels co0..co0+TC, into ws [9][KC][TC].
__device__ __forceinline__ void load_weights(float* ws, const float* w,
                                             int ci0, int co0,
                                             int c_out_total) {
  for (int e = threadIdx.x; e < kWsFloats; e += kThreads) {
    const int co = e % TC;
    const int kk = (e / TC) % KC;
    const int tap = e / (TC * KC);
    float v = 0.0f;
    if (co0 + co < c_out_total) {
      v = w[(static_cast<size_t>(tap) * c_out_total + co0 + co) * CIN + ci0 +
            kk];
    }
    ws[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
dblock_nhwc_f32_fma(const float* __restrict__ x, const float* __restrict__ k0,
                    const float* __restrict__ b0,
                    const float* __restrict__ k1,
                    const float* __restrict__ b1, float* __restrict__ y,
                    int height, int width, int c1, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [CIN][XH][XW]
  float* a0s = smem + kXsFloats;        // [CIN][AH][AW]
  float* ws = a0s + kA0Floats;          // [9][KC][TC]

  const int tid = threadIdx.x;
  const int cg = tid % (TC / CX);
  const int pg = tid / (TC / CX);
  const int oy0 = blockIdx.y * OH;      // conv1 rows of this tile
  const int ox0 = blockIdx.x * OW;
  const int b = blockIdx.z;
  const size_t image = static_cast<size_t>(b) * height * width;

  // Input tile with a two-pixel halo; consecutive threads read consecutive
  // channels of a pixel.
  for (int e = tid; e < kXsFloats; e += kThreads) {
    const int ci = e % CIN;
    const int pix = e / CIN;
    const int gy = oy0 - 2 + pix / XW;
    const int gx = ox0 - 2 + pix % XW;
    float v = 0.0f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      v = x[(image + static_cast<size_t>(gy) * width + gx) * CIN + ci];
    }
    xs[ci * (XH * XW) + pix] = v;
  }

  // ---- conv0 + b0 + lrelu on the a0 tile (conv1's tile plus a halo).
  // Pixel group pg holds a0 pixels pg + 32 * j.
  int off[kA0PerThread];
#pragma unroll
  for (int j = 0; j < kA0PerThread; ++j) {
    const int p = min(pg + kPixelGroups * j, kA0Pixels - 1);
    off[j] = (p / AW) * XW + p % AW;  // top-left tap of the pixel in xs
  }
  float acc0[kA0PerThread][CX];
#pragma unroll
  for (int j = 0; j < kA0PerThread; ++j) {
#pragma unroll
    for (int i = 0; i < CX; ++i) acc0[j][i] = 0.0f;
  }
  for (int ci0 = 0; ci0 < CIN; ci0 += KC) {
    __syncthreads();  // xs is complete; ws is free
    load_weights(ws, k0, ci0, 0, CIN);
    __syncthreads();
    for (int kk = 0; kk < KC; ++kk) {
      const float* xc = xs + (ci0 + kk) * (XH * XW);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = ws + ((dy * 3 + dx) * KC + kk) * TC + cg * CX;
          const float4 w_lo = *reinterpret_cast<const float4*>(wr);
          const float4 w_hi = *reinterpret_cast<const float4*>(wr + 4);
          const float w[CX] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w,
                               w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
          for (int j = 0; j < kA0PerThread; ++j) {
            const float a = xc[off[j] + dy * XW + dx];
#pragma unroll
            for (int i = 0; i < CX; ++i) acc0[j][i] = fmaf(a, w[i], acc0[j][i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kA0PerThread; ++j) {
    const int p = pg + kPixelGroups * j;
    if (p >= kA0Pixels) continue;
    const int gy = oy0 - 1 + p / AW;
    const int gx = ox0 - 1 + p % AW;
    const bool inside = gy >= 0 && gy < height && gx >= 0 && gx < width;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int co = cg * CX + i;
      // Zero outside the image: conv1's SAME padding.
      a0s[co * kA0Pixels + p] =
          inside ? lrelu(acc0[j][i] + b0[co], slope) : 0.0f;
    }
  }

  // ---- conv1 + b1 + lrelu + 2x2 mean pool. Pixel group pg owns pooled
  // pixel (pg / PW, pg % PW), i.e. conv1 pixels (2 pr + u, 2 pc + v).
  const int pr = pg / PW;
  const int pc = pg % PW;
  const int py = blockIdx.y * PH + pr;
  const int px = blockIdx.x * PW + pc;
  const bool store = py < height / 2 && px < width / 2;
  const int base = (2 * pr) * AW + 2 * pc;  // top-left tap in a0s
  for (int co0 = 0; co0 < c1; co0 += TC) {
    float acc1[4][CX];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int i = 0; i < CX; ++i) acc1[q][i] = 0.0f;
    }
    for (int ci0 = 0; ci0 < CIN; ci0 += KC) {
      __syncthreads();  // a0s is complete; ws is free
      load_weights(ws, k1, ci0, co0, c1);
      __syncthreads();
      for (int kk = 0; kk < KC; ++kk) {
        const float* ac = a0s + (ci0 + kk) * kA0Pixels + base;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wr = ws + ((dy * 3 + dx) * KC + kk) * TC + cg * CX;
            const float4 w_lo = *reinterpret_cast<const float4*>(wr);
            const float4 w_hi = *reinterpret_cast<const float4*>(wr + 4);
            const float w[CX] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w,
                                 w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float a = ac[((q >> 1) + dy) * AW + (q & 1) + dx];
#pragma unroll
              for (int i = 0; i < CX; ++i)
                acc1[q][i] = fmaf(a, w[i], acc1[q][i]);
            }
          }
        }
      }
    }
    if (store) {
      float* out = y + ((static_cast<size_t>(b) * (height / 2) + py) *
                            (width / 2) + px) * c1;
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const int co = co0 + cg * CX + i;
        if (co >= c1) continue;
        const float bias = b1[co];
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) s += lrelu(acc1[q][i] + bias, slope);
        out[co] = 0.25f * s;
      }
    }
  }
}

// ---- bf16: mma.sync tensor-core path ----

constexpr int MP = CIN + 8;               // padded row, bf16 (36 words)
constexpr int MW = MP / 2;                // row stride in 32-bit words
constexpr int M_XS = XH * XW * MP;        // bf16 elements
constexpr int M_A0_ROWS = 192;            // 180 a0 pixels in 12 m16 tiles
constexpr int M_A0 = M_A0_ROWS * MP;
constexpr int M_WS = 9 * TC * MP;
constexpr int M_SMEM = 2 * (M_XS + M_A0 + M_WS);   // 145,152 bytes

static_assert(OH * OW * TC * 4 <= 2 * M_XS, "conv1 tile fits in xs");
static_assert(OH == kThreads / 32 && OW == 16, "one m16 row per warp");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Weights w [9][c_out_total][CIN] (HWOI), output channels co0..co0+TC,
// into ws [9][TC][MP] as bf16 (zero past c_out_total).
__device__ __forceinline__ void load_weights_bf16(__nv_bfloat16* ws,
                                                  const __nv_bfloat16* w,
                                                  int co0, int c_out_total) {
  for (int e = threadIdx.x; e < 9 * TC * (CIN / 8); e += kThreads) {
    const int v = e % (CIN / 8);
    const int row = e / (CIN / 8);    // tap * TC + n
    const int co = co0 + row % TC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (co < c_out_total) {
      val = *reinterpret_cast<const uint4*>(
          w + (static_cast<size_t>(row / TC) * c_out_total + co) * CIN + v * 8);
    }
    *reinterpret_cast<uint4*>(ws + row * MP + v * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
dblock_nhwc_bf16_mma(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ k0,
                     const __nv_bfloat16* __restrict__ b0,
                     const __nv_bfloat16* __restrict__ k1,
                     const __nv_bfloat16* __restrict__ b1,
                     __nv_bfloat16* __restrict__ y, int height, int width,
                     int c1, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* a0s = xs + M_XS;
  __nv_bfloat16* ws = a0s + M_A0;
  float* c1s = reinterpret_cast<float*>(smem_raw);   // [OH * OW][TC], in xs
  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* a032 = reinterpret_cast<const uint32_t*>(a0s);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int oy0 = blockIdx.y * OH;
  const int ox0 = blockIdx.x * OW;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * width;

  for (int e = tid; e < XH * XW * (CIN / 8); e += kThreads) {
    const int v = e % (CIN / 8);
    const int pix = e / (CIN / 8);
    const int gy = oy0 - 2 + pix / XW;
    const int gx = ox0 - 2 + pix % XW;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      val = *reinterpret_cast<const uint4*>(
          x + (image + static_cast<size_t>(gy) * width + gx) * CIN + v * 8);
    }
    *reinterpret_cast<uint4*>(xs + pix * MP + v * 8) = val;
  }
  load_weights_bf16(ws, k0, 0, CIN);
  __syncthreads();

  // ---- conv0 on the a0 tile: warp owns m16 tiles mt0 + 4 q (q < 3) and
  // channels 32 * nh .. + 32.
  {
    const int mt0 = warp % 4;
    const int nh = warp / 4;
    int base[3][2];   // xs word offset of each fragment row's top-left tap
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min((mt0 + 4 * q) * 16 + g + 8 * h, kA0Pixels - 1);
        base[q][h] = ((p / AW) * XW + p % AW) * MW + t;
      }
    }
    float acc[3][4][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][j][r] = 0.0f;
      }
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * XW + tap % 3) * MW;
#pragma unroll
      for (int ks = 0; ks < CIN / 16; ++ks) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nb = (tap * TC + nh * 32 + j * 8 + g) * MW + ks * 8 + t;
          b[j][0] = ws32[nb];
          b[j][1] = ws32[nb + 4];
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const uint32_t a[4] = {
              xs32[base[q][0] + shift + ks * 8],
              xs32[base[q][1] + shift + ks * 8],
              xs32[base[q][0] + shift + ks * 8 + 4],
              xs32[base[q][1] + shift + ks * 8 + 4]};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[q][j], a, b[j][0], b[j][1]);
        }
      }
    }
    // + b0, lrelu, round to bf16 as the chain stores a0; zero outside the
    // image (conv1's SAME padding) and on the 12 padding rows.
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mt0 + 4 * q) * 16 + g + 8 * h;
        const int gy = oy0 - 1 + p / AW;
        const int gx = ox0 - 1 + p % AW;
        const bool inside = p < kA0Pixels && gy >= 0 && gy < height &&
                            gx >= 0 && gx < width;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nh * 32 + j * 8 + 2 * t;
          float v0 = 0.0f, v1 = 0.0f;
          if (inside) {
            v0 = lrelu(acc[q][j][2 * h] + __bfloat162float(b0[n]), slope);
            v1 = lrelu(acc[q][j][2 * h + 1] + __bfloat162float(b0[n + 1]),
                       slope);
          }
          *reinterpret_cast<__nv_bfloat162*>(a0s + p * MP + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // ---- conv1 in chunks of TC output channels: warp owns conv1 row
  // `warp` (one m16 tile) x TC channels; then pool from c1s.
  for (int co0 = 0; co0 < c1; co0 += TC) {
    __syncthreads();   // a0s is complete; ws and xs are free
    load_weights_bf16(ws, k1, co0, c1);
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int arow = ((warp + tap / 3) * AW + g + tap % 3) * MW + t;
#pragma unroll
      for (int ks = 0; ks < CIN / 16; ++ks) {
        const uint32_t a[4] = {
            a032[arow + ks * 8], a032[arow + 8 * MW + ks * 8],
            a032[arow + ks * 8 + 4], a032[arow + 8 * MW + ks * 8 + 4]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nb = (tap * TC + j * 8 + g) * MW + ks * 8 + t;
          mma_bf16(acc[j], a, ws32[nb], ws32[nb + 4]);
        }
      }
    }
    // + b1, lrelu, into c1s [pixel][channel] as f32.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j * 8 + 2 * t;
      const float bias0 =
          co0 + n < c1 ? __bfloat162float(b1[co0 + n]) : 0.0f;
      const float bias1 =
          co0 + n + 1 < c1 ? __bfloat162float(b1[co0 + n + 1]) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = c1s + (warp * OW + g + 8 * h) * TC + n;
        dst[0] = lrelu(acc[j][2 * h] + bias0, slope);
        dst[1] = lrelu(acc[j][2 * h + 1] + bias1, slope);
      }
    }
    __syncthreads();
    // 2 x 2 mean pool; consecutive threads write consecutive channels.
    for (int e = tid; e < PH * PW * TC; e += kThreads) {
      const int n = e % TC;
      const int pp = e / TC;
      const int pr = pp / PW;
      const int pc = pp % PW;
      const int py = blockIdx.y * PH + pr;
      const int px = blockIdx.x * PW + pc;
      if (co0 + n >= c1 || py >= height / 2 || px >= width / 2) continue;
      const float* src = c1s + ((2 * pr) * OW + 2 * pc) * TC + n;
      const float s = src[0] + src[TC] + src[OW * TC] + src[OW * TC + TC];
      y[((static_cast<size_t>(blockIdx.z) * (height / 2) + py) * (width / 2) +
         px) * c1 + co0 + n] = __float2bfloat16_rn(0.25f * s);
    }
  }
}

bool bad_sizes(int batch, int height, int width, int c1) {
  return batch <= 0 || batch > 65535 || height < 2 || width < 2 ||
         height % 2 || width % 2 || c1 <= 0;
}

}  // namespace

extern "C" {

// x [batch, height, width, 64], k0 [3, 3, 64, 64], b0 [64],
// k1 [3, 3, c1, 64] (both HWOI), b1 [c1], y [batch, height / 2, width / 2,
// c1]; all contiguous, all f32 (or all bf16 for the _bf16 entry).
int dblock_nhwc_f32(const void* x, const void* k0, const void* b0,
                    const void* k1, const void* b1, void* y, int batch,
                    int height, int width, int c1, float slope, void* stream) {
  if (bad_sizes(batch, height, width, c1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dblock_nhwc_f32_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width / 2 + PW - 1) / PW, (height / 2 + PH - 1) / PH,
                  batch);
  dblock_nhwc_f32_fma<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k0),
      static_cast<const float*>(b0), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<float*>(y), height, width,
      c1, slope);
  return static_cast<int>(cudaGetLastError());
}

int dblock_nhwc_bf16(const void* x, const void* k0, const void* b0,
                     const void* k1, const void* b1, void* y, int batch,
                     int height, int width, int c1, float slope,
                     void* stream) {
  if (bad_sizes(batch, height, width, c1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dblock_nhwc_bf16_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      M_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width / 2 + PW - 1) / PW, (height / 2 + PH - 1) / PH,
                  batch);
  dblock_nhwc_bf16_mma<<<grid, kThreads, M_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(k0),
      static_cast<const __nv_bfloat16*>(b0),
      static_cast<const __nv_bfloat16*>(k1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(y),
      height, width, c1, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
