// K4: the generator's per-conv epilogue, bias -> LeakyReLU -> pixel norm,
// and its first-order backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the epilogue of its
// generator blocks (gansynth_tpu/models/generator.py) to XLA, which fuses
// it into the passes around the conv. Written out in PyTorch
// (models/layers.py: pixel_norm(leaky_relu(z + bias))) it is some twenty
// passes a conv through device memory, pixel norm's float32
// intermediates at full resolution among them. For z [rows, C] (NHWC,
// rows = B * H * W, contiguous) in T (float32 or bf16) and bias [C]
// float32 this file computes, with that chain's roundings,
//
//   v = round_T(z + round_T(bias))            the bias add, in T
//   a = v > 0 ? v : round_T(v * slope)        LeakyReLU, slope given in T
//   s = rsqrt(sum_c(a * a) / C + eps)         float32
//   y = round_T(a * s)
//
// and, for the gradient g of y,
//
//   dx = round_T(s * g - a * s^3 * sum_c(g * a) / C)   float32, then T
//   dz = v > 0 ? dx : round_T(dx * slope)
//   dbias = round_T(sum over the rows of dz)            float32 sums
//
// (dbias is returned in float32, the value rounded to T as the chain's
// bias.to(T) rounds its gradient).
//
// What bounds it on an H100: bytes. The forward reads z and writes y, 4
// bytes an element in bf16; the backward reads z and g and writes dz, 6
// bytes; a few operations an element. The stage-6 step's 14 epilogues,
// 245.9 M elements a forward, need 0.30 ms a forward and 0.44 ms a
// backward at 3.35 TB/s.
//
// Design: a group of LANES threads takes one row, each thread NV 16-byte
// vectors of it (LANES = C / 8 in bf16 and C / 4 in float32, at most 32,
// so that every load and store is 16 bytes and a warp's are contiguous);
// a row's two sums run through warp shuffles inside its group. A block of
// 256 threads takes 256 / LANES rows at a time and four such sets a
// thread at once, every load of the four issued before the first sum, so
// that enough bytes are in flight to cover HBM's latency. The grid has at
// most 528 blocks (four for each of the H100's 132 SMs) and strides over
// the rows; each block visits a fixed set of rows. The backward keeps a
// thread's share of the bias gradient in registers over its rows, adds
// the block's threads in a fixed order through shared memory into one
// float32 row of partial sums per block, and a second launch adds those
// rows per channel in a fixed order. There are no atomics, so a CUDA
// graph's replay gives an eager run's bits. The launch shape follows from
// C alone.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // threads a block
constexpr int kUnroll = 4;       // rows a thread has in flight
constexpr int kMaxBlocks = 528;  // 4 per SM of the H100's 132
constexpr int kSumThreads = 32;  // the bias sum's block: 32 x 32

// The element types: 16-byte vectors to and from float32, and rounding.
struct F32 {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

struct Bf16 {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// The sum of x over each aligned group of LANES lanes of the warp; every
// lane of the warp takes part.
template <int LANES>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// Blocks of the grid for `rows` rows at `lanes` threads a row.
int grid_blocks(long long rows, int lanes) {
  const long long chunk = static_cast<long long>(kThreads / lanes) * kUnroll;
  const long long blocks = (rows + chunk - 1) / chunk;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <class V, int LANES, int NV>
struct Rows {
  static constexpr int kVecs = LANES * NV;       // 16-byte vectors a row
  static constexpr int kC = kVecs * V::kN;       // channels
  static constexpr int kRows = kThreads / LANES; // rows a block at once
  static constexpr long long kChunk = static_cast<long long>(kRows) * kUnroll;

  // The rows of a block's chunk: start + grp + u * kRows, u < kUnroll, so
  // that a warp's loads at each u are contiguous.
  __device__ __forceinline__ static void load(const uint4* __restrict__ p,
                                              long long start, int grp,
                                              int lane, long long rows,
                                              uint4 (&in)[kUnroll][NV]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = start + grp + u * kRows;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        in[u][j] = r < rows ? p[r * kVecs + j * LANES + lane]
                            : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // The bias rounded to T, for this lane's channels.
  __device__ __forceinline__ static void bias_of(const float* __restrict__ bias,
                                                 int lane,
                                                 float (&b)[NV][V::kN]) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < V::kN; ++e) {
        b[j][e] = V::round(bias[(j * LANES + lane) * V::kN + e]);
      }
    }
  }

  __device__ static void forward(const uint4* __restrict__ z,
                                 const float* __restrict__ bias,
                                 uint4* __restrict__ y, long long rows,
                                 float slope, float eps) {
    const int lane = threadIdx.x % LANES, grp = threadIdx.x / LANES;
    float b[NV][V::kN];
    bias_of(bias, lane, b);
    for (long long start = blockIdx.x * kChunk; start < rows;
         start += gridDim.x * kChunk) {
      uint4 in[kUnroll][NV];
      load(z, start, grp, lane, rows, in);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float a[NV][V::kN];
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float zf[V::kN];
          V::unpack(in[u][j], zf);
#pragma unroll
          for (int e = 0; e < V::kN; ++e) {
            const float v = V::round(zf[e] + b[j][e]);
            a[j][e] = v > 0.f ? v : V::round(v * slope);
            ss += a[j][e] * a[j][e];
          }
        }
        ss = group_sum<LANES>(ss);
        const float s = rsqrtf(ss * (1.f / kC) + eps);
        const long long r = start + grp + u * kRows;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            float o[V::kN];
#pragma unroll
            for (int e = 0; e < V::kN; ++e) o[e] = a[j][e] * s;
            y[r * kVecs + j * LANES + lane] = V::pack(o);
          }
        }
      }
    }
  }

  __device__ static void backward(const uint4* __restrict__ z,
                                  const float* __restrict__ bias,
                                  const uint4* __restrict__ g,
                                  uint4* __restrict__ dz,
                                  float* __restrict__ partials,
                                  long long rows, float slope, float eps) {
    __shared__ float sums[kRows * kC];
    const int lane = threadIdx.x % LANES, grp = threadIdx.x / LANES;
    float b[NV][V::kN], acc[NV][V::kN];
    bias_of(bias, lane, b);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < V::kN; ++e) acc[j][e] = 0.f;
    }
    for (long long start = blockIdx.x * kChunk; start < rows;
         start += gridDim.x * kChunk) {
      uint4 zin[kUnroll][NV], gin[kUnroll][NV];
      load(z, start, grp, lane, rows, zin);
      load(g, start, grp, lane, rows, gin);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[NV][V::kN], a[NV][V::kN], gf[NV][V::kN];
        float ss = 0.f, ga = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float zf[V::kN];
          V::unpack(zin[u][j], zf);
          V::unpack(gin[u][j], gf[j]);
#pragma unroll
          for (int e = 0; e < V::kN; ++e) {
            v[j][e] = V::round(zf[e] + b[j][e]);
            a[j][e] = v[j][e] > 0.f ? v[j][e] : V::round(v[j][e] * slope);
            ss += a[j][e] * a[j][e];
            ga += gf[j][e] * a[j][e];
          }
        }
        ss = group_sum<LANES>(ss);
        ga = group_sum<LANES>(ga);
        const float s = rsqrtf(ss * (1.f / kC) + eps);
        const float coef = s * s * s * (ga * (1.f / kC));
        const long long r = start + grp + u * kRows;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            float o[V::kN];
#pragma unroll
            for (int e = 0; e < V::kN; ++e) {
              const float d = V::round(s * gf[j][e] - a[j][e] * coef);
              o[e] = v[j][e] > 0.f ? d : V::round(d * slope);
              acc[j][e] += o[e];
            }
            dz[r * kVecs + j * LANES + lane] = V::pack(o);
          }
        }
      }
    }
    if (partials == nullptr) return;   // uniform over the grid
    // sums[grp][c]: each thread's share, then the groups in order.
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < V::kN; ++e) {
        sums[grp * kC + (j * LANES + lane) * V::kN + e] = acc[j][e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kC; c += kThreads) {
      float t = 0.f;
      for (int k = 0; k < kRows; ++k) t += sums[k * kC + c];
      partials[static_cast<long long>(blockIdx.x) * kC + c] = t;
    }
  }
};

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
// K4 by the prefix gen_epilogue_ and its float32 kernels by _f32).
template <int LANES, int NV>
__global__ void __launch_bounds__(kThreads)
    gen_epilogue_fwd_bf16(const uint4* z, const float* bias, uint4* y,
                          long long rows, float slope, float eps) {
  Rows<Bf16, LANES, NV>::forward(z, bias, y, rows, slope, eps);
}

template <int LANES, int NV>
__global__ void __launch_bounds__(kThreads)
    gen_epilogue_fwd_f32(const uint4* z, const float* bias, uint4* y,
                         long long rows, float slope, float eps) {
  Rows<F32, LANES, NV>::forward(z, bias, y, rows, slope, eps);
}

template <int LANES, int NV>
__global__ void __launch_bounds__(kThreads)
    gen_epilogue_bwd_bf16(const uint4* z, const float* bias, const uint4* g,
                          uint4* dz, float* partials, long long rows,
                          float slope, float eps) {
  Rows<Bf16, LANES, NV>::backward(z, bias, g, dz, partials, rows, slope, eps);
}

template <int LANES, int NV>
__global__ void __launch_bounds__(kThreads)
    gen_epilogue_bwd_f32(const uint4* z, const float* bias, const uint4* g,
                         uint4* dz, float* partials, long long rows,
                         float slope, float eps) {
  Rows<F32, LANES, NV>::backward(z, bias, g, dz, partials, rows, slope, eps);
}

__global__ void __launch_bounds__(kSumThreads * kSumThreads)
    gen_epilogue_bias_sum_bf16(const float* partials, int blocks, int c,
                               float* dbias) {
  sum_partials<Bf16>(partials, blocks, c, dbias);
}

__global__ void __launch_bounds__(kSumThreads * kSumThreads)
    gen_epilogue_bias_sum_f32(const float* partials, int blocks, int c,
                              float* dbias) {
  sum_partials<F32>(partials, blocks, c, dbias);
}

template <int L, int N>
struct Shape {
  static constexpr int kLanes = L, kNv = N;
};

// Calls fn(Shape<LANES, NV>()) for a row of c elements of V; false for a
// width it does not take (c not a multiple of the vector, or more than
// two vectors a lane).
template <class V, class Fn>
bool by_width(int c, Fn fn) {
  if (c <= 0 || c % V::kN) return false;
  switch (c / V::kN) {
    case 1: fn(Shape<1, 1>()); return true;
    case 2: fn(Shape<2, 1>()); return true;
    case 4: fn(Shape<4, 1>()); return true;
    case 8: fn(Shape<8, 1>()); return true;
    case 16: fn(Shape<16, 1>()); return true;
    case 32: fn(Shape<32, 1>()); return true;
    case 64: fn(Shape<32, 2>()); return true;
    default: return false;
  }
}

// Launches of the device function of V's type.
template <int L, int N, class... A>
void launch_fwd(Bf16, int blocks, cudaStream_t s, A... a) {
  gen_epilogue_fwd_bf16<L, N><<<blocks, kThreads, 0, s>>>(a...);
}
template <int L, int N, class... A>
void launch_fwd(F32, int blocks, cudaStream_t s, A... a) {
  gen_epilogue_fwd_f32<L, N><<<blocks, kThreads, 0, s>>>(a...);
}
template <int L, int N, class... A>
void launch_bwd(Bf16, int blocks, cudaStream_t s, A... a) {
  gen_epilogue_bwd_bf16<L, N><<<blocks, kThreads, 0, s>>>(a...);
}
template <int L, int N, class... A>
void launch_bwd(F32, int blocks, cudaStream_t s, A... a) {
  gen_epilogue_bwd_f32<L, N><<<blocks, kThreads, 0, s>>>(a...);
}
template <class... A>
void launch_sum(Bf16, int grid, cudaStream_t s, A... a) {
  gen_epilogue_bias_sum_bf16<<<grid, dim3(kSumThreads, kSumThreads), 0, s>>>(
      a...);
}
template <class... A>
void launch_sum(F32, int grid, cudaStream_t s, A... a) {
  gen_epilogue_bias_sum_f32<<<grid, dim3(kSumThreads, kSumThreads), 0, s>>>(
      a...);
}

template <class V>
int blocks_of(long long rows, int c) {
  int blocks = -1;
  by_width<V>(c, [&](auto shape) {
    blocks = grid_blocks(rows, decltype(shape)::kLanes);
  });
  return blocks;
}

template <class V>
int forward(const void* z, const void* bias, void* y, long long rows, int c,
            float slope, float eps, void* stream) {
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool ok = by_width<V>(c, [&](auto shape) {
    constexpr int L = decltype(shape)::kLanes, N = decltype(shape)::kNv;
    const int blocks = grid_blocks(rows, L);
    if (blocks > 0) {
      launch_fwd<L, N>(V(), blocks, s, static_cast<const uint4*>(z),
                       static_cast<const float*>(bias),
                       static_cast<uint4*>(y), rows, slope, eps);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int backward(const void* z, const void* bias, const void* g, void* dz,
             void* partials, void* dbias, long long rows, int c, float slope,
             float eps, void* stream) {
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  const bool ok = by_width<V>(c, [&](auto shape) {
    constexpr int L = decltype(shape)::kLanes, N = decltype(shape)::kNv;
    blocks = grid_blocks(rows, L);
    if (blocks > 0) {
      launch_bwd<L, N>(V(), blocks, s, static_cast<const uint4*>(z),
                       static_cast<const float*>(bias),
                       static_cast<const uint4*>(g), static_cast<uint4*>(dz),
                       dbias == nullptr ? nullptr
                                        : static_cast<float*>(partials),
                       rows, slope, eps);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (dbias != nullptr) {
    launch_sum(V(), (c + kSumThreads - 1) / kSumThreads, s,
               static_cast<const float*>(partials), blocks, c,
               static_cast<float*>(dbias));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The backward's blocks for `rows` rows of `c` elements of `elem_bytes`
// bytes (4 float32, 2 bf16): the rows of float32 partial sums that its
// `partials` needs. -1 for a width the kernels do not take.
int gen_epilogue_blocks(long long rows, int c, int elem_bytes) {
  if (rows < 0) return -1;
  return elem_bytes == 2 ? blocks_of<Bf16>(rows, c) : blocks_of<F32>(rows, c);
}

// z, y [rows, c] contiguous and 16-byte aligned, in float32 (or bf16 for
// the _bf16 entry); bias [c] float32. c a multiple of 4 (float32) or 8
// (bf16), at most 64 vectors of 16 bytes, and a power of two times the
// vector.
int gen_epilogue_forward_f32(const void* z, const void* bias, void* y,
                             long long rows, int c, float slope, float eps,
                             void* stream) {
  return forward<F32>(z, bias, y, rows, c, slope, eps, stream);
}

int gen_epilogue_forward_bf16(const void* z, const void* bias, void* y,
                              long long rows, int c, float slope, float eps,
                              void* stream) {
  return forward<Bf16>(z, bias, y, rows, c, slope, eps, stream);
}

// z, g, dz [rows, c] as above; partials [gen_epilogue_blocks(rows, c), c]
// float32 scratch and dbias [c] float32, or both null for no bias
// gradient.
int gen_epilogue_backward_f32(const void* z, const void* bias, const void* g,
                              void* dz, void* partials, void* dbias,
                              long long rows, int c, float slope, float eps,
                              void* stream) {
  return backward<F32>(z, bias, g, dz, partials, dbias, rows, c, slope, eps,
                       stream);
}

int gen_epilogue_backward_bf16(const void* z, const void* bias, const void* g,
                               void* dz, void* partials, void* dbias,
                               long long rows, int c, float slope, float eps,
                               void* stream) {
  return backward<Bf16>(z, bias, g, dz, partials, dbias, rows, c, slope, eps,
                        stream);
}

}  // extern "C"
