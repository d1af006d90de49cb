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
// Every tile computes conv0 + b0 + lrelu for its conv1 tile plus a
// one-pixel halo, zeroes the a0 values that fall outside the image (conv1's
// SAME padding must see zeros there, not lrelu(conv0(0) + b0)), then conv1
// + b1 + lrelu, pools 2 x 2 and writes only the pooled tile.
//  - bf16 (the training path), on Hopper's parts (hopper.cuh): a
//    persistent grid, one block of three warpgroups per SM, walks tiles of
//    16 x 32 conv1 outputs (8 x 16 pooled), so conv0 is recomputed on
//    18 x 34 = 612 a0 pixels per 512 (1.2x; an 8 x 16 tile pays 1.41x)
//    and each tile's weight traffic is spread over 4x the pixels. One
//    producer thread brings in each tile's input with its two-pixel halo
//    as one TMA box {64, 36, 20, 1} (zeros outside the image), as soon as
//    conv0 of the previous tile has read its box; another streams the
//    weights one tap (64 x 64) per stage through a 4-stage mbarrier ring:
//    k0's nine taps twice (conv0 runs in two rounds), then k1's nine taps
//    for each 64-channel pass of conv1. All tiles carry the 128-byte
//    swizzle. Both convs run on wgmma m64n64k16 with B (the weights) from
//    shared memory and A in registers: a tap's window into the staged
//    input or a0 starts at any pixel row, which a shared-memory descriptor
//    cannot address (it wants 8-row-aligned swizzled tiles), while
//    ldmatrix takes one 16-byte-aligned row address per lane (with the
//    swizzle's XOR applied by hand). A is double-buffered, so a k16 step's
//    ldmatrix loads overlap the previous step's MMAs. Two consumer
//    warpgroups split the M rows: conv0's 640 (612 a0 pixels, padded) in
//    10 m64 groups, 5 each in rounds of 3 + 2 (160 accumulators and two
//    A buffers at once would exceed the registers and serialise the
//    MMAs); conv1's 512 in 8 groups of one pooled row each. The epilogues
//    run in registers: conv0's writes a0 as bf16 (the chain stores it so)
//    into its own swizzled tile; conv1's orders its rows so that a
//    thread's accumulators i and i + 2 are a vertical pair and lane ^ 4
//    holds the horizontal neighbour, adds b1, applies lrelu, pools with
//    one shuffle and stores y. 204,880 bytes of shared memory.
//    Measured on an H100 at 0.60 ms, ~40 % of the bound: one block per SM,
//    n64 MMAs issued in groups of 2-4 per warpgroup, each tap ending in a
//    full wait, and the a0 hand-off between the convs leave the tensor
//    cores idle part of the time.
//  - f32 (the parity path): 4 x 8 pooled outputs (8 x 16 conv1 outputs)
//    per block of 256 threads on the FMA units, staged as f32 ([64][12][20]
//    input, [64][10][18] a0, weights streamed in chunks of 8 input
//    channels, [9][8][64]); each thread owns a0 pixels and 8 channels in
//    conv0, and one pooled pixel (its four conv1 pixels) and 8 channels in
//    conv1, and pools in registers. 125,952 bytes.
//
// What the backward needs (csrc/dblock_grad.cu): given a0 and mask
// pointers, the kernel's second instance (template argument SAVE = 1; the
// forward without them is the first, unchanged) also writes
//  - a0 [B, H, W, 64] in x's type, each tile its interior pixels (conv1's
//    tile, without the halo): in bf16 copied 16 bytes a thread from the
//    swizzled a0 tile once both consumers have stored it, in f32 from
//    conv0's epilogue;
//  - the sign of z1 = conv1 + b1 (the value conv1's lrelu tests, f32), one
//    bit an element: mask [B, H, W, dblock_mask::pixel_bytes(C1)] bytes,
//    in the layout csrc/dblock_mask.cuh defines, the order of the wgmma
//    accumulators' lanes. In bf16 lane t of a quad holds the 16 channels
//    of its column's halfword t in both of its rows, so it stores its two
//    halfwords as they are, with no shuffle (a byte-per-8-channels order
//    needed eight shuffles a row pair and took 0.06 ms more a launch); the
//    f32 kernel ORs its 8 lanes' bits together with shuffles.
//  The mask of z0 is not written: with a slope above 0, a0 >= 0 exactly
//  where z0 >= 0. y is computed by the same arithmetic in both instances.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dblock_mask.cuh"
#include "hopper.cuh"

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

template <int SAVE>
__global__ void __launch_bounds__(kThreads)
dblock_nhwc_f32_fma(const float* __restrict__ x, const float* __restrict__ k0,
                    const float* __restrict__ b0,
                    const float* __restrict__ k1,
                    const float* __restrict__ b1, float* __restrict__ y,
                    float* __restrict__ a0_out, uint8_t* __restrict__ mask,
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
    float a[CX];
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int co = cg * CX + i;
      // Zero outside the image: conv1's SAME padding.
      a[i] = inside ? lrelu(acc0[j][i] + b0[co], slope) : 0.0f;
      a0s[co * kA0Pixels + p] = a[i];
    }
    if (SAVE && inside && p / AW >= 1 && p / AW <= OH && p % AW >= 1 &&
        p % AW <= OW) {
      float4* out = reinterpret_cast<float4*>(
          a0_out + (image + static_cast<size_t>(gy) * width + gx) * CIN +
          cg * CX);
      out[0] = make_float4(a[0], a[1], a[2], a[3]);
      out[1] = make_float4(a[4], a[5], a[6], a[7]);
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
    // z1 >= 0 bits of the four pixels in the mask's order (channel
    // 8 cg + i of the pass is dblock_mask::bit(cg, i / 2, i % 2), which
    // lies in the pass's 32-bit word i / 4), ORed over the pixel group's
    // 8 lanes (cg) and stored by lane cg = 0.
    uint32_t bits[4][2] = {};
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
        for (int q = 0; q < 4; ++q) {
          const float z = acc1[q][i] + bias;
          s += lrelu(z, slope);
          if (SAVE) {
            bits[q][i / 4] |= static_cast<uint32_t>(z >= 0.0f)
                              << (dblock_mask::bit(cg, i / 2, i % 2) % 32);
          }
        }
        out[co] = 0.25f * s;
      }
    }
    if (SAVE) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int o = 1; o < TC / CX; o <<= 1) {
            bits[q][k] |= __shfl_xor_sync(0xffffffffu, bits[q][k], o);
          }
        }
        if (store && cg == 0) {
          const size_t pixel =
              (static_cast<size_t>(b) * height + 2 * py + (q >> 1)) * width +
              2 * px + (q & 1);
          *reinterpret_cast<uint2*>(
              mask + pixel * dblock_mask::pixel_bytes(c1) +
              dblock_mask::halfword_byte(co0 / TC, 0)) =
              make_uint2(bits[q][0], bits[q][1]);
        }
      }
    }
  }
}

// ---- bf16: TMA + wgmma path ----

constexpr int W_OH = 16;                 // conv1 rows of a tile
constexpr int W_OW = 32;                 // conv1 columns of a tile
constexpr int W_AH = W_OH + 2;           // a0 rows (one-pixel halo)
constexpr int W_AW = W_OW + 2;
constexpr int W_XH = W_OH + 4;           // input rows (two-pixel halo)
constexpr int W_XW = W_OW + 4;
constexpr int W_A0_PIXELS = W_AH * W_AW;                        // 612
constexpr int W_A0_GROUPS = (W_A0_PIXELS + 63) / 64;            // 10 x m64
constexpr int W_THREADS = 384;           // producer + two consumer warpgroups
constexpr int W_STAGES = 4;              // weight ring
constexpr uint32_t W_X_BYTES = W_XH * W_XW * 128;               // 92,160
constexpr uint32_t W_A0_BYTES = ((W_A0_PIXELS * 128 + 1023) / 1024) * 1024;
constexpr uint32_t W_STAGE_BYTES = 64 * 64 * 2;                 // one tap, 64 x 64
constexpr int W_SMEM = W_X_BYTES + W_A0_BYTES + W_STAGES * W_STAGE_BYTES +
                       8 * (2 * W_STAGES + 2) + 1024;
constexpr int W_G0 = W_A0_GROUPS / 2;    // conv0 m64 groups per consumer (5)
constexpr int W_G0A = 3;                 // ... taken in two rounds, 3 + 2
constexpr int W_G0B = W_G0 - W_G0A;
constexpr int W_G1 = W_OH / 2 / 2;       // conv1 m64 groups per consumer (4)

static_assert(W_A0_GROUPS == 2 * W_G0, "conv0 groups split evenly");
static_assert(W_X_BYTES % 1024 == 0, "a0 starts 1024-aligned");
static_assert(W_OW == 32, "a conv1 m64 group is 2 rows x 32 columns");

// One conv of the tile on the tensor cores: nine taps, one weight stage
// each, K = 64 channels in four k16 steps. G m64 groups per consumer: lane
// row l of group q reads the staged activation at pixel rows[q] + the
// tap's shift (a 128-byte swizzled row). A comes from ldmatrix into
// registers, double-buffered, so the next k16 step's loads overlap this
// step's MMAs; one wgmma group stays in flight until a tap's last step.
template <int G>
__device__ __forceinline__ void conv_taps(float (&acc)[G][32],
                                          const int (&rows)[G], int pitch,
                                          uint32_t src, unsigned char* ws,
                                          uint64_t* full, uint64_t* empty,
                                          int& it, int lane) {
  const int khalf = lane >> 4;
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.0f;
  }
  for (int tap = 0; tap < 9; ++tap, ++it) {
    const int s = it % W_STAGES;
    const int shift = (tap / 3) * pitch + tap % 3;
    uint32_t a[2][G][4];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      hopper::ldmatrix_x4(a[0][q],
                          src + hopper::sw128_offset(rows[q] + shift, khalf));
    }
    hopper::mbar_wait(&full[s], (it / W_STAGES) & 1);
    const uint64_t db = hopper::sw128_desc(ws + s * W_STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < G; ++q) hopper::fence_operands(acc[q]);
      hopper::wgmma_fence();
#pragma unroll
      for (int q = 0; q < G; ++q) {
        hopper::wgmma_rs_n64(acc[q], a[kk & 1][q], db + 2 * kk, 1);
      }
      hopper::wgmma_commit();
      if (kk < 3) {
        // The step before this one is done: its A registers are free.
        hopper::wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < G; ++q) {
          hopper::ldmatrix_x4(
              a[(kk + 1) & 1][q],
              src + hopper::sw128_offset(rows[q] + shift, 2 * (kk + 1) + khalf));
        }
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < G; ++q) hopper::fence_operands(acc[q]);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
}

// conv0's epilogue for G m64 groups from group0 on: + b0, lrelu, round to
// bf16 as the chain stores a0, into the swizzled a0 tile. a0 outside the
// image is 0, since conv1's SAME padding sees zeros there, not
// lrelu(conv0(0) + b0).
template <int G>
__device__ __forceinline__ void store_a0(const float (&acc)[G][32], int group0,
                                         unsigned char* a0s,
                                         const __nv_bfloat16* __restrict__ b0,
                                         int oy0, int ox0, int height,
                                         int width, float slope, int warp,
                                         int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (group0 + q) * 64 + warp * 16 + g + 8 * h;
      if (p >= W_A0_PIXELS) continue;
      const int gy = oy0 - 1 + p / W_AW;
      const int gx = ox0 - 1 + p % W_AW;
      const bool inside = gy >= 0 && gy < height && gx >= 0 && gx < width;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 8 * j + 2 * t;
        float v0 = 0.0f, v1 = 0.0f;
        if (inside) {
          v0 = lrelu(acc[q][4 * j + 2 * h] + __bfloat162float(b0[ch]), slope);
          v1 = lrelu(acc[q][4 * j + 2 * h + 1] + __bfloat162float(b0[ch + 1]),
                     slope);
        }
        *reinterpret_cast<__nv_bfloat162*>(a0s + hopper::sw128_offset(p, j) +
                                           4 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The tile's interior a0 (conv1's 16 x 32 pixels, without the halo) from
// the swizzled a0 tile to a0_out [B, H, W, 64], 16 bytes a thread at a
// time: eight consecutive threads write one pixel's 128 bytes. `tid`
// counts the 256 consumer threads.
__device__ __forceinline__ void save_a0(const unsigned char* a0s,
                                        __nv_bfloat16* __restrict__ a0_out,
                                        int b, int oy0, int ox0, int height,
                                        int width, int tid) {
  for (int e = tid; e < W_OH * W_OW * 8; e += 256) {
    const int pix = e / 8;
    const int chunk = e % 8;
    const int gy = oy0 + pix / W_OW;
    const int gx = ox0 + pix % W_OW;
    if (gy < height && gx < width) {
      const int p = (pix / W_OW + 1) * W_AW + pix % W_OW + 1;
      *reinterpret_cast<uint4*>(
          a0_out + ((static_cast<size_t>(b) * height + gy) * width + gx) *
                       CIN + 8 * chunk) =
          *reinterpret_cast<const uint4*>(a0s + hopper::sw128_offset(p, chunk));
    }
  }
}

template <int SAVE>
__global__ void __launch_bounds__(W_THREADS, 1)
dblock_nhwc_bf16_wgmma(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap k0_map,
                       const __grid_constant__ CUtensorMap k1_map,
                       const __nv_bfloat16* __restrict__ b0,
                       const __nv_bfloat16* __restrict__ b1,
                       __nv_bfloat16* __restrict__ y,
                       __nv_bfloat16* __restrict__ a0_out,
                       uint8_t* __restrict__ mask, int batch, int height,
                       int width, int c1, float slope) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = hopper::align1024(smem_raw);   // [20 x 36][64], sw128
  unsigned char* a0s = xs + W_X_BYTES;               // [18 x 34][64], sw128
  unsigned char* ws = a0s + W_A0_BYTES;              // [W_STAGES][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + W_STAGES * W_STAGE_BYTES);
  uint64_t* empty = full + W_STAGES;
  uint64_t* x_full = empty + W_STAGES;
  uint64_t* x_empty = x_full + 1;

  // Tiles of 16 x 32 conv1 outputs, x-tile fastest, walked by a
  // persistent grid.
  const int tiles_x = (width + W_OW - 1) / W_OW;
  const int tiles_y = (height + W_OH - 1) / W_OH;
  const int tiles = tiles_x * tiles_y * batch;
  const int passes = (c1 + 63) / 64;   // conv1 in 64-channel passes
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::mbar_init(x_full, 1);
    hopper::mbar_init(x_empty, 8);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      // Weights: one tap per stage, k0's nine taps, then k1's nine taps for
      // each 64-channel pass (rows past C1 read as zeros), tile after tile.
      hopper::tma_prefetch(&k0_map);
      hopper::tma_prefetch(&k1_map);
      const int per_tile = 9 * (2 + passes);   // conv0 in two rounds
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int st = 0; st < per_tile; ++st, ++it) {
          const int s = it % W_STAGES;
          if (it >= W_STAGES) {
            hopper::mbar_wait(&empty[s], ((it / W_STAGES) - 1) & 1);
          }
          hopper::mbar_arrive_expect_tx(&full[s], W_STAGE_BYTES);
          if (st < 18) {
            hopper::tma_load_3d(ws + s * W_STAGE_BYTES, &k0_map, &full[s], 0,
                                0, st % 9);
          } else {
            hopper::tma_load_3d(ws + s * W_STAGE_BYTES, &k1_map, &full[s], 0,
                                64 * ((st - 18) / 9), (st - 18) % 9);
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      // Input tiles with their two-pixel halo, one box each (zeros outside
      // the image); the next tile's box comes in as soon as conv0 of this
      // one has read its tile, while conv1 runs.
      hopper::tma_prefetch(&x_map);
      int n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        if (n > 0) hopper::mbar_wait(x_empty, (n - 1) & 1);
        const int tx = tile % tiles_x;
        const int ty = (tile / tiles_x) % tiles_y;
        const int b = tile / (tiles_x * tiles_y);
        hopper::mbar_arrive_expect_tx(x_full, W_X_BYTES);
        hopper::tma_load_4d(xs, &x_map, x_full, 0, tx * W_OW - 2,
                            ty * W_OH - 2, b);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;                  // consumer 0 or 1
  const int g = lane / 4;
  const int t = lane % 4;
  const int lrow = lane & 15;            // the row this lane addresses
  const uint32_t xs_u = hopper::smem_u32(xs);
  const uint32_t a0_u = hopper::smem_u32(a0s);

  // conv0's M = 640 rows (612 a0 pixels, the rest repeat the last) in 10
  // m64 groups, this consumer's groups 5c .. 5c + 4: lane row -> x-tile
  // pixel at tap (0, 0).
  int xrow[W_G0];
#pragma unroll
  for (int q = 0; q < W_G0; ++q) {
    const int p = min((W_G0 * c + q) * 64 + warp * 16 + lrow,
                      W_A0_PIXELS - 1);
    xrow[q] = (p / W_AW) * W_XW + p % W_AW;
  }
  // conv1's m64 group q is pooled row 4c + q: warp w's 16 rows are conv1
  // rows (2 pr, 2 pr + 1) x columns 8w .. 8w + 7, row h * 8 + g holding
  // (2 pr + h, 8w + g). So a thread's accumulators i and i + 2 are a
  // vertical pair, and lane ^ 4 holds the horizontal neighbour.
  int arow[W_G1];
#pragma unroll
  for (int q = 0; q < W_G1; ++q) {
    const int pr = W_G1 * c + q;
    arow[q] = (2 * pr + (lrow >> 3)) * W_AW + warp * 8 + (lrow & 7);
  }

  int it = 0;   // weight stages consumed
  int n = 0;    // tiles done
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const int oy0 = ((tile / tiles_x) % tiles_y) * W_OH;
    const int ox0 = (tile % tiles_x) * W_OW;
    const int b = tile / (tiles_x * tiles_y);

    // ---- conv0 on the a0 tile (conv1's tile plus a one-pixel halo), in
    // two rounds of this consumer's groups (3 + 2), so that the
    // accumulators and two buffers of A fit the registers without
    // serialising the MMAs; round 2 streams k0 again.
    hopper::mbar_wait(x_full, n & 1);
    {
      float acc[W_G0A][32];
      const int rows[W_G0A] = {xrow[0], xrow[1], xrow[2]};
      conv_taps<W_G0A>(acc, rows, W_XW, xs_u, ws, full, empty, it, lane);
      // The other consumer is done with the previous tile's a0.
      hopper::named_barrier(1, 256);
      store_a0<W_G0A>(acc, W_G0 * c, a0s, b0, oy0, ox0, height, width,
                      slope, warp, lane);
    }
    {
      float acc[W_G0B][32];
      const int rows[W_G0B] = {xrow[3], xrow[4]};
      conv_taps<W_G0B>(acc, rows, W_XW, xs_u, ws, full, empty, it, lane);
      if (lane == 0) hopper::mbar_arrive(x_empty);   // x is read
      store_a0<W_G0B>(acc, W_G0 * c + W_G0A, a0s, b0, oy0, ox0, height,
                      width, slope, warp, lane);
    }
    hopper::named_barrier(1, 256);   // a0 is complete (both consumers)
    if (SAVE) {
      save_a0(a0s, a0_out, b, oy0, ox0, height, width, threadIdx.x - 128);
    }

    // ---- conv1 + b1 + lrelu + 2x2 pool, one 64-channel pass at a time
    for (int pass = 0; pass < passes; ++pass) {
      float acc[W_G1][32];
      conv_taps<W_G1>(acc, arow, W_AW, a0_u, ws, full, empty, it, lane);
#pragma unroll
      for (int q = 0; q < W_G1; ++q) {
        const int py = oy0 / 2 + W_G1 * c + q;
        const int px = ox0 / 2 + warp * 4 + g / 2;
        const bool store = (g & 1) == 0 && py < height / 2 && px < width / 2;
        __nv_bfloat16* out =
            y + ((static_cast<size_t>(b) * (height / 2) + py) * (width / 2) +
                 px) * c1;
        // z1 >= 0 bits of this lane's 16 channels 8 j + 2 t + e in rows
        // h = 0, 1: the mask's halfword t of the pass, channel 8 j + 2 t + e
        // at bit dblock_mask::bit(j, 0, e) of bits[h].
        uint32_t bits[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = 64 * pass + 8 * j + 2 * t;
          // Channels past C1 (zero weights) are never stored; the
          // negative bias leaves their bits 0.
          const float bias0 = co < c1 ? __bfloat162float(b1[co]) : -1.0f;
          const float bias1 =
              co + 1 < c1 ? __bfloat162float(b1[co + 1]) : -1.0f;
          const float z00 = acc[q][4 * j] + bias0;
          const float z01 = acc[q][4 * j + 1] + bias1;
          const float z10 = acc[q][4 * j + 2] + bias0;
          const float z11 = acc[q][4 * j + 3] + bias1;
          if (SAVE) {
            bits[0] |= (static_cast<uint32_t>(z00 >= 0.0f)
                        << dblock_mask::bit(j, 0, 0)) |
                       (static_cast<uint32_t>(z01 >= 0.0f)
                        << dblock_mask::bit(j, 0, 1));
            bits[1] |= (static_cast<uint32_t>(z10 >= 0.0f)
                        << dblock_mask::bit(j, 0, 0)) |
                       (static_cast<uint32_t>(z11 >= 0.0f)
                        << dblock_mask::bit(j, 0, 1));
          }
          float v0 = lrelu(z00, slope) + lrelu(z10, slope);
          float v1 = lrelu(z01, slope) + lrelu(z11, slope);
          v0 += __shfl_xor_sync(0xffffffffu, v0, 4);
          v1 += __shfl_xor_sync(0xffffffffu, v1, 4);
          if (store && co < c1) {
            if (co + 1 < c1) {
              *reinterpret_cast<__nv_bfloat162*>(out + co) =
                  __floats2bfloat162_rn(0.25f * v0, 0.25f * v1);
            } else {
              out[co] = __float2bfloat16_rn(0.25f * v0);
            }
          }
        }
        if (SAVE) {
          const int gx = ox0 + warp * 8 + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gy = oy0 + 2 * (W_G1 * c + q) + h;
            if (gy < height && gx < width) {
              *reinterpret_cast<uint16_t*>(
                  mask +
                  ((static_cast<size_t>(b) * height + gy) * width + gx) *
                      dblock_mask::pixel_bytes(c1) +
                  dblock_mask::halfword_byte(pass, t)) =
                  static_cast<uint16_t>(bits[h]);
            }
          }
        }
      }
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
// c1]; all contiguous, all f32 (or all bf16 for the _bf16 entry). a0
// [batch, height, width, 64] in x's type and mask [batch, height, width,
// 8 * ceil(c1 / 64)] bytes, both contiguous and 16-byte aligned, are
// written when both are given (what the backward needs); both null, the
// forward writes y alone.
int dblock_nhwc_f32(const void* x, const void* k0, const void* b0,
                    const void* k1, const void* b1, void* y, void* a0,
                    void* mask, int batch, int height, int width, int c1,
                    float slope, void* stream) {
  if (bad_sizes(batch, height, width, c1) ||
      (a0 == nullptr) != (mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel =
      a0 != nullptr ? dblock_nhwc_f32_fma<1> : dblock_nhwc_f32_fma<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width / 2 + PW - 1) / PW, (height / 2 + PH - 1) / PH,
                  batch);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k0),
      static_cast<const float*>(b0), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<float*>(y),
      static_cast<float*>(a0), static_cast<uint8_t*>(mask), height, width,
      c1, slope);
  return static_cast<int>(cudaGetLastError());
}

int dblock_nhwc_bf16(const void* x, const void* k0, const void* b0,
                     const void* k1, const void* b1, void* y, void* a0,
                     void* mask, int batch, int height, int width, int c1,
                     float slope, void* stream) {
  if (bad_sizes(batch, height, width, c1) ||
      (a0 == nullptr) != (mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap x_map, k0_map, k1_map;
  const cuuint64_t x_dims[4] = {CIN, static_cast<cuuint64_t>(width),
                                static_cast<cuuint64_t>(height),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[3] = {2ull * CIN, 2ull * CIN * width,
                                   2ull * CIN * width * height};
  const cuuint32_t x_box[4] = {CIN, W_XW, W_XH, 1};
  int err = hopper::encode_bf16_sw128(&x_map, x, 4, x_dims, x_strides, x_box);
  if (err != 0) return err;
  const cuuint32_t w_box[3] = {CIN, 64, 1};
  const cuuint64_t k0_dims[3] = {CIN, CIN, 9};
  const cuuint64_t k0_strides[2] = {2ull * CIN, 2ull * CIN * CIN};
  err = hopper::encode_bf16_sw128(&k0_map, k0, 3, k0_dims, k0_strides, w_box);
  if (err != 0) return err;
  const cuuint64_t k1_dims[3] = {CIN, static_cast<cuuint64_t>(c1), 9};
  const cuuint64_t k1_strides[2] = {2ull * CIN, 2ull * CIN * c1};
  err = hopper::encode_bf16_sw128(&k1_map, k1, 3, k1_dims, k1_strides, w_box);
  if (err != 0) return err;
  const auto kernel =
      a0 != nullptr ? dblock_nhwc_bf16_wgmma<1> : dblock_nhwc_bf16_wgmma<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long tiles = static_cast<long>((width + W_OW - 1) / W_OW) *
                     ((height + W_OH - 1) / W_OH) * batch;
  const int sms = hopper::sm_count();
  if (sms <= 0 || tiles > (1l << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, W_THREADS, W_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x_map, k0_map, k1_map, static_cast<const __nv_bfloat16*>(b0),
      static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(a0), static_cast<uint8_t*>(mask), batch,
      height, width, c1, slope);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one bf16 block, in bytes.
int dblock_nhwc_bf16_smem_bytes() { return W_SMEM; }

}  // extern "C"
