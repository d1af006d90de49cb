// K3's first-order backward, the passes between the library's convs, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's backward of fused_dblock
// (gansynth_tpu/kernels/pallas_dblock.py:286-296) recomputes the chain
// from x and lets XLA fuse the masks and the pool's spread into the
// convs around them. In PyTorch those are a dozen plain passes a call
// (kernels/dblock.py:dblock_backward_plain), and two convs rebuild z0 and
// z1. Here the forward has kept a0 and the sign of z1 (csrc/dblock.cu,
// its SAVE instance), and two kernels take the place of the passes. For
// the block's slope s (given in T, float32 or bf16) and the pooled
// gradient g [B, H/2, W/2, C1] in T:
//
//   spread:  g_z1 = mask1 ? round_T(g / 4) : round_T(s * round_T(g / 4))
//            [B, H, W, C1], mask1 the forward's bits (z1 >= 0;
//            layout: csrc/dblock_mask.cuh)
//   mask:    g_z0 = a0 >= 0 ? g_a0 : round_T(s * g_a0)      [B, H, W, 64]
//
// with g_a0 = conv_transpose(g_z1, k1) from the library between them,
// and each writes the bias gradient's float32 partial sums per block
// (db1 = sum of g_z1, db0 = sum of g_z0 over B, H, W); a third small
// launch adds a partial set in a fixed order and rounds to T, as the
// plain sum of a T tensor does. No atomics, so a CUDA graph's replay
// gives an eager run's bits. The mask of z0 comes from a0: with a slope
// above 0, a0 = lrelu(z0) >= 0 exactly where z0 >= 0.
//
// What bounds them on an H100: bytes, a few operations an element. At
// the flagship's shape ([8, 128, 1024, 64] -> 128, bf16) the spread reads
// 67 MB of g and 16.8 MB of mask and writes 268 MB; the mask kernel reads
// a0 and g_a0 (134 MB each) and writes 134 MB: 0.105 and 0.120 ms at
// 3.35 TB/s.
//
// Design: a unit is 8 channels of one pixel (8 bits of the mask; 16
// bytes of bf16, 32 of float32). A block of units x (256 / units) threads takes
// 256 / units rows (pooled pixels for the spread, pixels for the mask
// kernel) at a time, kUnroll such sets a thread with every load issued
// before the first store; a thread keeps one unit's channels, so its
// share of the bias gradient stays in registers over its rows. The grid
// has at most 528 blocks (four for each of the H100's 132 SMs) and
// strides over the rows; a block's threads add their shares in a fixed
// order through shared memory into one float32 row of partials. The
// spread reads one unit of g and writes its 2 x 2 window, so g is read
// once.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dblock_mask.cuh"

namespace {

constexpr int kThreads = 256;    // at most, a block
constexpr int kUnroll = 4;       // rows a thread has in flight
constexpr int kMaxBlocks = 528;  // 4 per SM of the H100's 132
constexpr int kSumThreads = 32;  // the bias sum's block: 32 x 32
constexpr int kUnit = 8;         // channels of a unit (8 bits of mask)

// A unit's 8 channels as 16-byte vectors, to and from float32; rounding.
struct F32 {
  static constexpr int kVecs = 2;
  __device__ __forceinline__ static void unpack(const uint4 (&r)[kVecs],
                                                float (&f)[kUnit]) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      f[4 * v] = __uint_as_float(r[v].x);
      f[4 * v + 1] = __uint_as_float(r[v].y);
      f[4 * v + 2] = __uint_as_float(r[v].z);
      f[4 * v + 3] = __uint_as_float(r[v].w);
    }
  }
  __device__ __forceinline__ static void pack(const float (&f)[kUnit],
                                              uint4 (&r)[kVecs]) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      r[v] = make_uint4(__float_as_uint(f[4 * v]), __float_as_uint(f[4 * v + 1]),
                        __float_as_uint(f[4 * v + 2]),
                        __float_as_uint(f[4 * v + 3]));
    }
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

struct Bf16 {
  static constexpr int kVecs = 1;
  __device__ __forceinline__ static void unpack(const uint4 (&r)[kVecs],
                                                float (&f)[kUnit]) {
    const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void pack(const float (&f)[kUnit],
                                              uint4 (&r)[kVecs]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
    }
    r[0] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Blocks of the grid for `rows` rows of `units` units.
int grid_blocks(long long rows, int units) {
  const long long chunk = static_cast<long long>(kThreads / units) * kUnroll;
  const long long blocks = (rows + chunk - 1) / chunk;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <class V>
__device__ __forceinline__ void load_unit(const uint4* __restrict__ p,
                                          long long unit,
                                          uint4 (&r)[V::kVecs]) {
#pragma unroll
  for (int v = 0; v < V::kVecs; ++v) r[v] = p[unit * V::kVecs + v];
}

template <class V>
__device__ __forceinline__ void store_unit(uint4* __restrict__ p,
                                           long long unit,
                                           const float (&f)[kUnit]) {
  uint4 r[V::kVecs];
  V::pack(f, r);
#pragma unroll
  for (int v = 0; v < V::kVecs; ++v) p[unit * V::kVecs + v] = r[v];
}

// The block's shares of the bias gradient (acc, this thread's unit u of
// row set ry) added over the row sets in order into partials[blockIdx.x].
__device__ __forceinline__ void block_partials(const float (&acc)[kUnit],
                                               int u, int ry, int units,
                                               float* __restrict__ partials) {
  __shared__ float sums[kThreads * kUnit];
  const int c = units * kUnit;
  const int sets = blockDim.x / units;
#pragma unroll
  for (int e = 0; e < kUnit; ++e) sums[ry * c + u * kUnit + e] = acc[e];
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < sets; ++k) t += sums[k * c + ch];
    partials[static_cast<long long>(blockIdx.x) * c + ch] = t;
  }
}

// g_z1 from the pooled g [rows = B * H/2 * W/2, C] and the mask [B * H *
// W, mask_bytes]: each thread takes unit u of a pooled pixel and writes
// the unit at its four pixels.
template <class V>
__device__ void spread(const uint4* __restrict__ g,
                       const uint8_t* __restrict__ mask,
                       uint4* __restrict__ gz, float* __restrict__ partials,
                       long long rows, int half_width, int units,
                       int mask_bytes, float slope) {
  const int u = threadIdx.x % units, ry = threadIdx.x / units;
  const int sets = blockDim.x / units;
  const long long chunk = static_cast<long long>(sets) * kUnroll;
  const long long width = 2ll * half_width;
  float acc[kUnit];
#pragma unroll
  for (int e = 0; e < kUnit; ++e) acc[e] = 0.f;
  for (long long start = blockIdx.x * chunk; start < rows;
       start += gridDim.x * chunk) {
    uint4 in[kUnroll][V::kVecs];
    uint32_t m[kUnroll][4];
    long long pix[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long r = start + ry + k * sets;
      // pixel (2 py, 2 px) of image b, with r / (W/2) = b * H/2 + py
      pix[k] = 2 * (r / half_width) * width + 2 * (r % half_width);
      if (r < rows) {
        load_unit<V>(g, r * units + u, in[k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m[k][q] = dblock_mask::unit_bits(
              mask + (pix[k] + (q >> 1) * width + (q & 1)) * mask_bytes, u);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (start + ry + k * sets >= rows) continue;
      float f[kUnit];
      V::unpack(in[k], f);
#pragma unroll
      for (int e = 0; e < kUnit; ++e) f[e] = V::round(0.25f * f[e]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float o[kUnit];
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          o[e] = (m[k][q] >> e) & 1u ? f[e] : V::round(slope * f[e]);
          acc[e] += o[e];
        }
        store_unit<V>(gz, (pix[k] + (q >> 1) * width + (q & 1)) * units + u,
                      o);
      }
    }
  }
  if (partials != nullptr) block_partials(acc, u, ry, units, partials);
}

// g_z0 from a0 and g_a0 [rows = B * H * W, C].
template <class V>
__device__ void mask_grad(const uint4* __restrict__ a0,
                          const uint4* __restrict__ ga0,
                          uint4* __restrict__ gz, float* __restrict__ partials,
                          long long rows, int units, float slope) {
  const int u = threadIdx.x % units, ry = threadIdx.x / units;
  const int sets = blockDim.x / units;
  const long long chunk = static_cast<long long>(sets) * kUnroll;
  float acc[kUnit];
#pragma unroll
  for (int e = 0; e < kUnit; ++e) acc[e] = 0.f;
  for (long long start = blockIdx.x * chunk; start < rows;
       start += gridDim.x * chunk) {
    uint4 ain[kUnroll][V::kVecs], gin[kUnroll][V::kVecs];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long r = start + ry + k * sets;
      if (r < rows) {
        load_unit<V>(a0, r * units + u, ain[k]);
        load_unit<V>(ga0, r * units + u, gin[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long r = start + ry + k * sets;
      if (r >= rows) continue;
      float a[kUnit], o[kUnit];
      V::unpack(ain[k], a);
      V::unpack(gin[k], o);
#pragma unroll
      for (int e = 0; e < kUnit; ++e) {
        if (!(a[e] >= 0.f)) o[e] = V::round(slope * o[e]);
        acc[e] += o[e];
      }
      store_unit<V>(gz, r * units + u, o);
    }
  }
  if (partials != nullptr) block_partials(acc, u, ry, units, partials);
}

// dbias[c] = round_T(sum over the blocks' partial rows), in a fixed order:
// thread (x, y) of a 32 x 32 block adds rows y, y + 32, ... of channel
// blockIdx.x * 32 + x, then thread (x, 0) adds the 32 sums in order.
template <class V>
__device__ void sum_partials(const float* __restrict__ partials, int blocks,
                             int c, float* __restrict__ dbias) {
  __shared__ float part[kSumThreads][kSumThreads + 1];
  const int ch = blockIdx.x * kSumThreads + threadIdx.x;
  float t = 0.f;
  if (ch < c) {
    for (int p = threadIdx.y; p < blocks; p += kSumThreads) {
      t += partials[static_cast<long long>(p) * c + ch];
    }
  }
  part[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.f;
    for (int k = 0; k < kSumThreads; ++k) s += part[k][threadIdx.x];
    dbias[ch] = V::round(s);
  }
}

// The device functions under their own names (a profiler's trace finds
// them by the prefix dblock_grad_, apart from K3's forward, dblock_nhwc_).
__global__ void __launch_bounds__(kThreads)
    dblock_grad_spread_bf16(const uint4* g, const uint8_t* mask, uint4* gz,
                            float* partials, long long rows, int half_width,
                            int units, int mask_bytes, float slope) {
  spread<Bf16>(g, mask, gz, partials, rows, half_width, units, mask_bytes,
               slope);
}

__global__ void __launch_bounds__(kThreads)
    dblock_grad_spread_f32(const uint4* g, const uint8_t* mask, uint4* gz,
                           float* partials, long long rows, int half_width,
                           int units, int mask_bytes, float slope) {
  spread<F32>(g, mask, gz, partials, rows, half_width, units, mask_bytes,
              slope);
}

__global__ void __launch_bounds__(kThreads)
    dblock_grad_mask_bf16(const uint4* a0, const uint4* ga0, uint4* gz,
                          float* partials, long long rows, int units,
                          float slope) {
  mask_grad<Bf16>(a0, ga0, gz, partials, rows, units, slope);
}

__global__ void __launch_bounds__(kThreads)
    dblock_grad_mask_f32(const uint4* a0, const uint4* ga0, uint4* gz,
                         float* partials, long long rows, int units,
                         float slope) {
  mask_grad<F32>(a0, ga0, gz, partials, rows, units, slope);
}

__global__ void __launch_bounds__(kSumThreads * kSumThreads)
    dblock_grad_bias_sum_bf16(const float* partials, int blocks, int c,
                              float* dbias) {
  sum_partials<Bf16>(partials, blocks, c, dbias);
}

__global__ void __launch_bounds__(kSumThreads * kSumThreads)
    dblock_grad_bias_sum_f32(const float* partials, int blocks, int c,
                             float* dbias) {
  sum_partials<F32>(partials, blocks, c, dbias);
}

bool bad_width(int c) {
  return c <= 0 || c % kUnit || c / kUnit > kThreads;
}

// Launches of the device function of V's type.
template <class... A>
void launch_spread(Bf16, int blocks, int threads, cudaStream_t s, A... a) {
  dblock_grad_spread_bf16<<<blocks, threads, 0, s>>>(a...);
}
template <class... A>
void launch_spread(F32, int blocks, int threads, cudaStream_t s, A... a) {
  dblock_grad_spread_f32<<<blocks, threads, 0, s>>>(a...);
}
template <class... A>
void launch_mask(Bf16, int blocks, int threads, cudaStream_t s, A... a) {
  dblock_grad_mask_bf16<<<blocks, threads, 0, s>>>(a...);
}
template <class... A>
void launch_mask(F32, int blocks, int threads, cudaStream_t s, A... a) {
  dblock_grad_mask_f32<<<blocks, threads, 0, s>>>(a...);
}
template <class... A>
void launch_sum(Bf16, int grid, cudaStream_t s, A... a) {
  dblock_grad_bias_sum_bf16<<<grid, dim3(kSumThreads, kSumThreads), 0, s>>>(
      a...);
}
template <class... A>
void launch_sum(F32, int grid, cudaStream_t s, A... a) {
  dblock_grad_bias_sum_f32<<<grid, dim3(kSumThreads, kSumThreads), 0, s>>>(
      a...);
}

// A kernel's launch over `rows` rows of c channels (`launch(blocks,
// threads)`), then the bias sum of its partials when dbias is given.
template <class V, class Fn>
int with_bias_sum(long long rows, int c, void* partials, void* dbias,
                  cudaStream_t s, Fn launch) {
  const int units = c / kUnit;
  const int blocks = grid_blocks(rows, units);
  if (blocks > 0) launch(blocks, units * (kThreads / units));
  if (dbias != nullptr) {
    launch_sum(V(), (c + kSumThreads - 1) / kSumThreads, s,
               static_cast<const float*>(partials), blocks, c,
               static_cast<float*>(dbias));
  }
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int spread_entry(const void* g, const void* mask, void* gz, void* partials,
                 void* dbias, long long rows, int half_width, int c,
                 int mask_bytes, float slope, void* stream) {
  if (rows < 0 || half_width <= 0 || bad_width(c) ||
      mask_bytes < dblock_mask::pixel_bytes(c) ||
      mask_bytes % dblock_mask::kPassBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return with_bias_sum<V>(rows, c, partials, dbias, s,
                          [&](int blocks, int threads) {
    launch_spread(V(), blocks, threads, s, static_cast<const uint4*>(g),
                  static_cast<const uint8_t*>(mask), static_cast<uint4*>(gz),
                  dbias == nullptr ? nullptr : static_cast<float*>(partials),
                  rows, half_width, c / kUnit, mask_bytes, slope);
  });
}

template <class V>
int mask_entry(const void* a0, const void* ga0, void* gz, void* partials,
               void* dbias, long long rows, int c, float slope,
               void* stream) {
  if (rows < 0 || bad_width(c)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_bias_sum<V>(rows, c, partials, dbias, s,
                          [&](int blocks, int threads) {
    launch_mask(V(), blocks, threads, s, static_cast<const uint4*>(a0),
                static_cast<const uint4*>(ga0), static_cast<uint4*>(gz),
                dbias == nullptr ? nullptr : static_cast<float*>(partials),
                rows, c / kUnit, slope);
  });
}

}  // namespace

extern "C" {

// The blocks of a launch over `rows` rows of `c` channels: the rows of
// float32 partial sums its `partials` needs. -1 for a width the kernels
// do not take (c a multiple of 8, at most 2048).
int dblock_backward_blocks(long long rows, int c) {
  if (rows < 0 || bad_width(c)) return -1;
  return grid_blocks(rows, c / kUnit);
}

// g [rows, c] the pooled gradient (rows = batch * height/2 * width/2),
// mask [batch * height * width, mask_bytes] the forward's bits, gz
// [batch, height, width, c]; all contiguous and 16-byte aligned, in
// float32 (or bf16 for the _bf16 entry). partials
// [dblock_backward_blocks(rows, c), c] float32 scratch and dbias [c]
// float32, or both null for no bias gradient. slope in the tensors' type.
int dblock_backward_spread_bf16(const void* g, const void* mask, void* gz,
                                void* partials, void* dbias, long long rows,
                                int half_width, int c, int mask_bytes,
                                float slope, void* stream) {
  return spread_entry<Bf16>(g, mask, gz, partials, dbias, rows, half_width,
                            c, mask_bytes, slope, stream);
}

int dblock_backward_spread_f32(const void* g, const void* mask, void* gz,
                               void* partials, void* dbias, long long rows,
                               int half_width, int c, int mask_bytes,
                               float slope, void* stream) {
  return spread_entry<F32>(g, mask, gz, partials, dbias, rows, half_width, c,
                           mask_bytes, slope, stream);
}

// a0, ga0, gz [rows, c] as above (rows = batch * height * width).
int dblock_backward_mask_bf16(const void* a0, const void* ga0, void* gz,
                              void* partials, void* dbias, long long rows,
                              int c, float slope, void* stream) {
  return mask_entry<Bf16>(a0, ga0, gz, partials, dbias, rows, c, slope,
                          stream);
}

int dblock_backward_mask_f32(const void* a0, const void* ga0, void* gz,
                             void* partials, void* dbias, long long rows,
                             int c, float slope, void* stream) {
  return mask_entry<F32>(a0, ga0, gz, partials, dbias, rows, c, slope,
                         stream);
}

}  // extern "C"
