// K5: the critic's fromRGB, a 1x1 conv of fan-in <= 4 -> bias -> LeakyReLU,
// and the two kernels its derivatives are made of, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the fromRGB as a broadcast
// multiply-add (gansynth_tpu/models/layers.py) and XLA fuses it. Written out
// in PyTorch it is six passes through device memory a forward, and its
// backward, differentiated again by WGAN-GP's penalty, many more. For x
// [rows, cin] (NHWC pixels, cin <= 4), w [cout, cin], b [cout], all in T
// (float32 or bf16), this file computes, with the chain's roundings
// (models/layers.py: sum(x[..., c:c+1] * w[:, c]) + b, then LeakyReLU),
//
//   z = round_T(...round_T(round_T(0 + p_0) + p_1)... + b),
//       p_c = round_T(x_c * w_c)
//   y = z > 0 ? z : round_T(z * slope)                     (forward)
//
// and, with the mask m = (z > 0 ? 1 : slope) of z recomputed from x, w, b,
// the two linear maps the derivatives of y are made of:
//
//   contract(g; X1, W1):  gz = z > 0 ? g : round_T(g * slope)
//     A[p, c] = round_T(sum_o gz[p, o] W1[o, c])            [rows, cin]
//     B[o, c] = round_T(sum_p gz[p, o] X1[p, c])            [cout, cin]
//     C[o]    = round_T(sum_p gz[p, o])                     [cout]
//   expand(u, v, d):  t = round_T(d[o] + sum_j u[p, j] v[o, j])
//     out[p, o] = z > 0 ? t : round_T(t * slope)            [rows, cout]
//
// (sums in float32; expand's u, v are [dX | X1] and [W1 | dW], k <= 2 cin
// columns, so that it is m (d + dX W1^T + X1 dW^T)). The backward of y for
// g is contract(g; x, w); the derivative of contract with respect to g is
// expand, with respect to X1 and W1 contract(g; dA, dB); expand's are
// contract(g; X1, W1) and contract(g; dX, dW): the pair is closed under
// differentiation, and the penalty's double backward runs through it
// (kernels/from_rgb.py).
//
// What bounds it on an H100: bytes. The forward reads x (2 cin bytes a
// pixel in bf16) and writes y (2 cout); contract reads g and x and writes
// A; expand reads x and u and writes out. At the stage-6 critic's input,
// [8, 128, 1024, 2] -> 64 in bf16, each moves ~138 MB: 41 us at 3.35 TB/s.
// Next to the bytes the work is light but not nothing: z is recomputed for
// every element, and contract adds 2 cin + 1 float32 products or sums an
// element; so the arithmetic runs on packed vectors where it can.
//
// Design: K4's (csrc/gen_epilogue.cu). A group of `lanes` threads takes a
// pixel, each thread NV 16-byte vectors of its channels (lanes * NV * the
// vector's elements = cout, lanes a power of two up to 32, so that a
// warp's loads and stores of g, y and out are contiguous); a block of 256
// threads takes 256 / lanes pixels at a time and four such sets a thread
// at once, every load issued first (in contract and expand the next set's
// loads are issued before this set's arithmetic). The grid has at most
// 264 blocks, two for each of the H100's 132 SMs, so that it runs in one
// wave (contract is held to 128 registers a thread for it), and strides
// over the pixels; each block visits a fixed set of them. A thread holds its
// channels' weights and bias in registers, packed as T for z's
// arithmetic, which runs on 16-byte vectors (bf16x2 instructions in bf16:
// one rounding each, as the chain's float32 operation rounded to bf16
// gives), and as float32 for the sums. A pixel's values of x are splatted
// into vectors from their bits. A's sums over the channels, a thread's
// four pixels at once, are scattered between the lanes of their group
// (scatter_sum: 7 shuffles for 8 values over 8 lanes, each lane storing
// one sum). B and C: a thread keeps its share
// in registers over its pixels, the groups of a warp add theirs through
// shuffles, the warps of a block theirs in order through shared memory,
// into one float32 row of partial sums a block; a second launch adds the
// rows in a fixed order. There are no atomics, so a CUDA graph's replay
// gives an eager run's bits. The launch shape follows from cout alone;
// whether a contract has A and an X1 of its own, and how many columns an
// expand's u has, pick the instance.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // pixels a thread has in flight
constexpr int kMaxBlocks = 264;  // 2 per SM of the H100's 132: one wave
constexpr int kMaxCin = 4;
constexpr int kMaxCout = 256;
constexpr int kSumThreads = 32;  // the partials' sum: 32 x 32 threads

__device__ __forceinline__ uint4 select(const uint4& m, const uint4& a,
                                        const uint4& b) {
  return make_uint4((m.x & a.x) | (~m.x & b.x), (m.y & a.y) | (~m.y & b.y),
                    (m.z & a.z) | (~m.z & b.z), (m.w & a.w) | (~m.w & b.w));
}

// The element types: an element's bits, 16-byte vectors to and from
// float32, and a vector's arithmetic, each operation rounded to the type
// once (the _rn intrinsics: nothing may contract a product and a sum into
// one FMA).
struct F32 {
  using E = float;
  using Bits = uint32_t;
  static constexpr int kN = 4;
  __device__ __forceinline__ static float get(const E* p, long long i) {
    return p[i];
  }
  __device__ __forceinline__ static E put(float v) { return v; }
  __device__ __forceinline__ static uint32_t bits(float v) {
    return __float_as_uint(v);
  }
  __device__ __forceinline__ static float real(uint32_t bits) {
    return __uint_as_float(bits);
  }
  __device__ __forceinline__ static uint4 splat(uint32_t bits) {
    return make_uint4(bits, bits, bits, bits);
  }
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
  __device__ __forceinline__ static uint32_t mul1(uint32_t a, uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ __forceinline__ static uint32_t add1(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ __forceinline__ static uint32_t positive1(uint32_t z) {
    return __uint_as_float(z) > 0.f ? 0xffffffffu : 0u;
  }
};

struct Bf16 {
  using E = uint16_t;
  using Bits = uint16_t;
  static constexpr int kN = 8;
  __device__ __forceinline__ static float get(const E* p, long long i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
  }
  __device__ __forceinline__ static E put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static uint32_t bits(float v) { return put(v); }
  __device__ __forceinline__ static float real(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  __device__ __forceinline__ static uint4 splat(uint32_t bits) {
    const uint32_t u = bits | (bits << 16);
    return make_uint4(u, u, u, u);
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = static_cast<uint32_t>(put(f[2 * k]))
             | (static_cast<uint32_t>(put(f[2 * k + 1])) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static __nv_bfloat162 b2(uint32_t u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  }
  __device__ __forceinline__ static uint32_t u32(__nv_bfloat162 h) {
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint32_t mul1(uint32_t a, uint32_t b) {
    return u32(__hmul2_rn(b2(a), b2(b)));
  }
  __device__ __forceinline__ static uint32_t add1(uint32_t a, uint32_t b) {
    return u32(__hadd2_rn(b2(a), b2(b)));
  }
  __device__ __forceinline__ static uint32_t positive1(uint32_t z) {
    return __hgt2_mask(b2(z), b2(0u));
  }
};

template <class V>
__device__ __forceinline__ uint4 vmul(const uint4& a, const uint4& b) {
  return make_uint4(V::mul1(a.x, b.x), V::mul1(a.y, b.y), V::mul1(a.z, b.z),
                    V::mul1(a.w, b.w));
}

template <class V>
__device__ __forceinline__ uint4 vadd(const uint4& a, const uint4& b) {
  return make_uint4(V::add1(a.x, b.x), V::add1(a.y, b.y), V::add1(a.z, b.z),
                    V::add1(a.w, b.w));
}

// All ones where z > 0, zeros elsewhere (NaN included), element by element.
template <class V>
__device__ __forceinline__ uint4 positive(const uint4& z) {
  return make_uint4(V::positive1(z.x), V::positive1(z.y), V::positive1(z.z),
                    V::positive1(z.w));
}

// Sums of N values over each aligned group of `lanes` lanes of the warp
// (a power of two up to 32), scattered between the group's lanes: at each
// shuffle level a lane keeps half of its values and sends the other half
// to its partner, so that N values take N - 1 shuffles (not N log2 lanes)
// and each lane ends with N / lanes of the sums (or, with more lanes than
// values, the lanes of a sum share it). Level K of the reduction, the
// values v[0, N >> K); `first` gathers the index of v[0] among the N.
// Every lane of the warp takes part; the order of the sums is fixed.
template <int N, int K = 0>
__device__ __forceinline__ void scatter_sum(float (&v)[N], int lanes,
                                            int lane, int& first) {
  if constexpr (K < 5) {
    const int o = lanes >> (K + 1);
    if (o == 0) return;
    constexpr int n = N >> K;
    if constexpr (n >= 2) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? v[i] : v[i + n / 2];
        const float keep = up ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      if (up) first += n / 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
    scatter_sum<N, K + 1>(v, lanes, lane, first);
  }
}

int grid_blocks(long long rows, int lanes) {
  const long long chunk = static_cast<long long>(kThreads / lanes) * kUnroll;
  const long long blocks = (rows + chunk - 1) / chunk;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <class V, int NV, int MAXC>
struct Pixels {
  using E = typename V::E;
  using Bits = typename V::Bits;
  static constexpr int kN = V::kN;

  int lanes, log2_lanes, lane, grp, rows_blk;
  long long chunk, stride;

  __device__ explicit Pixels(int lanes_)
      : lanes(lanes_),
        log2_lanes(0),
        lane(threadIdx.x % lanes_),
        grp(threadIdx.x / lanes_),
        rows_blk(kThreads / lanes_),
        chunk(static_cast<long long>(kThreads / lanes_) * kUnroll),
        stride(static_cast<long long>(gridDim.x) * (kThreads / lanes_)
               * kUnroll) {
    while ((1 << log2_lanes) < lanes) ++log2_lanes;
  }

  // First channel of this thread's vector j.
  __device__ __forceinline__ int channel(int j) const {
    return (j * lanes + lane) * kN;
  }
  __device__ __forceinline__ long long row(long long start, int u) const {
    return start + grp + static_cast<long long>(u) * rows_blk;
  }
  // Index of this thread's vector j of pixel r in a [rows, cout] tensor.
  __device__ __forceinline__ long long vec(long long r, int j) const {
    return r * (lanes * NV) + j * lanes + lane;
  }

  // m [cout, cols] of this thread's channels: packed, a vector per column
  // (zeros past cols), and as float32 (zeros for a null m).
  __device__ void weights(const E* m, int cols, uint4 (&out)[NV][MAXC]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        float f[kN];
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          f[e] = c < cols ? V::get(m, static_cast<long long>(channel(j) + e)
                                          * cols + c)
                          : 0.f;
        }
        out[j][c] = V::pack(f);
      }
    }
  }
  template <int K>
  __device__ void weights(const E* m, int cols,
                          float (&out)[NV][kN][K]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          out[j][e][c] = m != nullptr && c < cols
              ? V::get(m, static_cast<long long>(channel(j) + e) * cols + c)
              : 0.f;
        }
      }
    }
  }
  __device__ void bias(const E* b, uint4 (&out)[NV]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) f[e] = V::get(b, channel(j) + e);
      out[j] = V::pack(f);
    }
  }
  __device__ void bias(const E* b, float (&out)[NV][kN]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        out[j][e] = b != nullptr ? V::get(b, channel(j) + e) : 0.f;
      }
    }
  }
  // The bits of the `cols` values of pixel r of p [rows, cols] (zeros past
  // the rows or past cols).
  template <int K>
  __device__ __forceinline__ void pixel(const E* p, long long r,
                                        long long rows, int cols,
                                        uint32_t (&out)[K]) const {
    const Bits* q = reinterpret_cast<const Bits*>(p);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      out[c] = r < rows && c < cols ? static_cast<uint32_t>(q[r * cols + c])
                                    : 0u;
    }
  }

  // z of vector j of a pixel whose x bits are xb: the chain's order (the
  // Python sum starts at 0).
  __device__ __forceinline__ static uint4 preact(const uint32_t (&xb)[MAXC],
                                                 const uint4 (&w)[MAXC],
                                                 const uint4& b, int cin) {
    uint4 s = vadd<V>(make_uint4(0u, 0u, 0u, 0u),
                      vmul<V>(V::splat(xb[0]), w[0]));
#pragma unroll
    for (int c = 1; c < MAXC; ++c) {
      if (c < cin) s = vadd<V>(s, vmul<V>(V::splat(xb[c]), w[c]));
    }
    return vadd<V>(s, b);
  }

  __device__ void forward(const E* __restrict__ x, const E* __restrict__ w,
                          const E* __restrict__ b, uint4* __restrict__ y,
                          long long rows, int cin, float slope) const {
    uint4 wv[NV][MAXC], bv[NV];
    weights(w, cin, wv);
    bias(b, bv);
    const uint4 sl = V::splat(V::bits(slope));
    for (long long start = blockIdx.x * chunk; start < rows;
         start += stride) {
      uint32_t xb[kUnroll][MAXC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) pixel(x, row(start, u), rows, cin, xb[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = row(start, u);
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const uint4 z = preact(xb[u], wv[j], bv[j], cin);
          y[vec(r, j)] = select(positive<V>(z), z, vmul<V>(z, sl));
        }
      }
    }
  }

  // A chunk's loads for contract: g's vectors and the bits of x (and of
  // an X1 of its own).
  template <bool OWN_X1>
  struct In {
    uint4 g[kUnroll][NV];
    uint32_t xb[kUnroll][MAXC];
    uint32_t x1b[OWN_X1 ? kUnroll : 1][MAXC];
  };
  template <bool OWN_X1>
  __device__ __forceinline__ void load(In<OWN_X1>& in, const uint4* g,
                                       const E* x1, const E* x,
                                       long long start, long long rows,
                                       int cin) const {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = row(start, u);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        in.g[u][j] = r < rows ? g[vec(r, j)] : make_uint4(0u, 0u, 0u, 0u);
      }
      pixel(x, r, rows, cin, in.xb[u]);
      if constexpr (OWN_X1) pixel(x1, r, rows, cin, in.x1b[u]);
    }
  }

  // HAS_A: A is asked for; OWN_X1: B's X1 is not x. A null `partials`:
  // neither B nor C.
  template <bool HAS_A, bool OWN_X1>
  __device__ void contract(const uint4* __restrict__ g,
                           const E* __restrict__ x1, const E* __restrict__ w1,
                           const E* __restrict__ x, const E* __restrict__ w,
                           const E* __restrict__ b, E* __restrict__ a,
                           float* __restrict__ partials, long long rows,
                           int cin, float slope) const {
    __shared__ float sums[kWarps * kMaxCout * (MAXC + 1)];
    uint4 wv[NV][MAXC], bv[NV];
    weights(w, cin, wv);
    bias(b, bv);
    float w1f[HAS_A ? NV : 1][kN][MAXC];
    if constexpr (HAS_A) weights(w1, cin, w1f);
    float accb[NV][kN][MAXC], accc[NV][kN];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        accc[j][e] = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) accb[j][e][c] = 0.f;
      }
    }
    const uint4 sl = V::splat(V::bits(slope));
    const bool sum_on = partials != nullptr;
    long long start = blockIdx.x * chunk;
    In<OWN_X1> cur;
    if (start < rows) load(cur, g, x1, x, start, rows, cin);
    for (; start < rows; start += stride) {
      In<OWN_X1> next;
      if (start + stride < rows) {   // uniform over the block
        load(next, g, x1, x, start + stride, rows, cin);
      }
      // A's terms of this thread, pixel u's input channel c at u MAXC + c
      float part[kUnroll * MAXC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float xf[MAXC];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if constexpr (OWN_X1) {
            xf[c] = V::real(cur.x1b[u][c]);
          } else {
            xf[c] = V::real(cur.xb[u][c]);
          }
          part[u * MAXC + c] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const uint4 z = preact(cur.xb[u], wv[j], bv[j], cin);
          float gz[kN];
          V::unpack(select(positive<V>(z), cur.g[u][j],
                           vmul<V>(cur.g[u][j], sl)), gz);
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            if (sum_on) {   // uniform over the grid
              accc[j][e] += gz[e];
#pragma unroll
              for (int c = 0; c < MAXC; ++c) {
                accb[j][e][c] = fmaf(gz[e], xf[c], accb[j][e][c]);
              }
            }
            if constexpr (HAS_A) {
#pragma unroll
              for (int c = 0; c < MAXC; ++c) {
                part[u * MAXC + c] = fmaf(gz[e], w1f[j][e][c],
                                          part[u * MAXC + c]);
              }
            }
          }
        }
      }
      if constexpr (HAS_A) {
        constexpr int kVals = kUnroll * MAXC;
        int first = 0;
        scatter_sum(part, lanes, lane, first);
        auto store = [&](int i, float v) {   // value i: pixel i / MAXC
          const long long r = row(start, i / MAXC);
          if (i % MAXC < cin && r < rows) {
            a[r * cin + i % MAXC] = V::put(v);
          }
        };
        if (lanes >= kVals) {   // one sum a lane; past kVals lanes, shared
          if ((lane & ((lanes / kVals) - 1)) == 0) store(first, part[0]);
        } else {
#pragma unroll
          for (int i = 0; i < kVals; ++i) {
            if (i < (kVals >> log2_lanes)) store(first + i, part[i]);
          }
        }
      }
      cur = next;
    }
    if (!sum_on) return;   // uniform over the grid
    // The groups of a warp hold the same channels: add them (fixed order).
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          accc[j][e] += __shfl_xor_sync(0xffffffffu, accc[j][e], o);
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            accb[j][e][c] += __shfl_xor_sync(0xffffffffu, accb[j][e][c], o);
          }
        }
      }
    }
    // sums[warp][entry]: B's entries o * cin + c, then C's cout * cin + o.
    const int cout = lanes * NV * kN, entries = cout * (cin + 1);
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 < lanes) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const int o = channel(j) + e;
          sums[warp * entries + cout * cin + o] = accc[j][e];
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            if (c < cin) sums[warp * entries + o * cin + c] = accb[j][e][c];
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < entries; i += kThreads) {
      float t = 0.f;
      for (int k = 0; k < kWarps; ++k) t += sums[k * entries + i];
      partials[static_cast<long long>(blockIdx.x) * entries + i] = t;
    }
  }

  // expand with u [rows, k] and v [cout, k], k <= K.
  template <int K>
  __device__ void expand(const E* __restrict__ u, const E* __restrict__ v,
                         const E* __restrict__ d, const E* __restrict__ x,
                         const E* __restrict__ w, const E* __restrict__ b,
                         uint4* __restrict__ out, long long rows, int cin,
                         int k, float slope) const {
    uint4 wv[NV][MAXC], bv[NV];
    weights(w, cin, wv);
    bias(b, bv);
    float vf[NV][kN][K], df[NV][kN];
    weights(v, k, vf);
    bias(d, df);
    const uint4 sl = V::splat(V::bits(slope));
    long long start = blockIdx.x * chunk;
    uint32_t xb[kUnroll][MAXC], ub[kUnroll][K];
    if (start < rows) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        pixel(x, row(start, q), rows, cin, xb[q]);
        pixel(u, row(start, q), rows, k, ub[q]);
      }
    }
    for (; start < rows; start += stride) {
      uint32_t xn[kUnroll][MAXC], un[kUnroll][K];
      if (start + stride < rows) {   // uniform over the block
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          pixel(x, row(start + stride, q), rows, cin, xn[q]);
          pixel(u, row(start + stride, q), rows, k, un[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const long long r = row(start, q);
        float uf[K];
#pragma unroll
        for (int c = 0; c < K; ++c) uf[c] = V::real(ub[q][c]);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const uint4 z = preact(xb[q], wv[j], bv[j], cin);
          float t[kN];
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            t[e] = df[j][e];
#pragma unroll
            for (int c = 0; c < K; ++c) t[e] = fmaf(uf[c], vf[j][e][c], t[e]);
          }
          const uint4 tv = V::pack(t);
          if (r < rows) {
            out[vec(r, j)] = select(positive<V>(z), tv, vmul<V>(tv, sl));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
#pragma unroll
        for (int c = 0; c < MAXC; ++c) xb[q][c] = xn[q][c];
#pragma unroll
        for (int c = 0; c < K; ++c) ub[q][c] = un[q][c];
      }
    }
  }
};

// The partial rows added per entry in a fixed order: thread (x, y) of a
// 32 x 32 block adds rows y, y + 32, ... of entry blockIdx.x * 32 + x, then
// thread (x, 0) adds the 32 sums in order and rounds to T: entries below
// `split` go to gw, the rest to gb (either may be null).
template <class V>
__device__ void sum_partials(const float* __restrict__ partials, int blocks,
                             int entries, int split, typename V::E* gw,
                             typename V::E* gb) {
  __shared__ float part[kSumThreads][kSumThreads + 1];
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  float t = 0.f;
  if (i < entries) {
    for (int p = threadIdx.y; p < blocks; p += kSumThreads) {
      t += partials[static_cast<long long>(p) * entries + i];
    }
  }
  part[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && i < entries) {
    float s = 0.f;
    for (int k = 0; k < kSumThreads; ++k) s += part[k][threadIdx.x];
    if (i < split) {
      if (gw != nullptr) gw[i] = V::put(s);
    } else if (gb != nullptr) {
      gb[i - split] = V::put(s);
    }
  }
}

// The device functions under their own names (a profiler's trace finds
// K5 by the prefix from_rgb_ and its float32 kernels by _f32).
template <int NV, int MAXC>
__global__ void __launch_bounds__(kThreads)
    from_rgb_fwd_bf16(const uint16_t* x, const uint16_t* w, const uint16_t* b,
                      uint4* y, long long rows, int cin, int lanes,
                      float slope) {
  Pixels<Bf16, NV, MAXC>(lanes).forward(x, w, b, y, rows, cin, slope);
}

template <int NV, int MAXC>
__global__ void __launch_bounds__(kThreads)
    from_rgb_fwd_f32(const float* x, const float* w, const float* b,
                     uint4* y, long long rows, int cin, int lanes,
                     float slope) {
  Pixels<F32, NV, MAXC>(lanes).forward(x, w, b, y, rows, cin, slope);
}

template <int NV, int MAXC, bool HAS_A, bool OWN_X1>
__global__ void __launch_bounds__(kThreads, 2)
    from_rgb_contract_bf16(const uint4* g, const uint16_t* x1,
                           const uint16_t* w1, const uint16_t* x,
                           const uint16_t* w, const uint16_t* b, uint16_t* a,
                           float* partials, long long rows, int cin,
                           int lanes, float slope) {
  Pixels<Bf16, NV, MAXC>(lanes).template contract<HAS_A, OWN_X1>(
      g, x1, w1, x, w, b, a, partials, rows, cin, slope);
}

template <int NV, int MAXC, bool HAS_A, bool OWN_X1>
__global__ void __launch_bounds__(kThreads, 2)
    from_rgb_contract_f32(const uint4* g, const float* x1, const float* w1,
                          const float* x, const float* w, const float* b,
                          float* a, float* partials, long long rows, int cin,
                          int lanes, float slope) {
  Pixels<F32, NV, MAXC>(lanes).template contract<HAS_A, OWN_X1>(
      g, x1, w1, x, w, b, a, partials, rows, cin, slope);
}

template <int NV, int MAXC, int K>
__global__ void __launch_bounds__(kThreads)
    from_rgb_expand_bf16(const uint16_t* u, const uint16_t* v,
                         const uint16_t* d, const uint16_t* x,
                         const uint16_t* w, const uint16_t* b, uint4* out,
                         long long rows, int cin, int k, int lanes,
                         float slope) {
  Pixels<Bf16, NV, MAXC>(lanes).template expand<K>(u, v, d, x, w, b, out,
                                                   rows, cin, k, slope);
}

template <int NV, int MAXC, int K>
__global__ void __launch_bounds__(kThreads)
    from_rgb_expand_f32(const float* u, const float* v, const float* d,
                        const float* x, const float* w, const float* b,
                        uint4* out, long long rows, int cin, int k, int lanes,
                        float slope) {
  Pixels<F32, NV, MAXC>(lanes).template expand<K>(u, v, d, x, w, b, out,
                                                  rows, cin, k, slope);
}

__global__ void __launch_bounds__(kSumThreads * kSumThreads)
    from_rgb_sum_bf16(const float* partials, int blocks, int entries,
                      int split, uint16_t* gw, uint16_t* gb) {
  sum_partials<Bf16>(partials, blocks, entries, split, gw, gb);
}

__global__ void __launch_bounds__(kSumThreads * kSumThreads)
    from_rgb_sum_f32(const float* partials, int blocks, int entries,
                     int split, float* gw, float* gb) {
  sum_partials<F32>(partials, blocks, entries, split, gw, gb);
}

// Launches of the device functions of V's type.
template <int NV, int MAXC, class... A>
void launch_fwd(Bf16, int blocks, cudaStream_t s, A... a) {
  from_rgb_fwd_bf16<NV, MAXC><<<blocks, kThreads, 0, s>>>(a...);
}
template <int NV, int MAXC, class... A>
void launch_fwd(F32, int blocks, cudaStream_t s, A... a) {
  from_rgb_fwd_f32<NV, MAXC><<<blocks, kThreads, 0, s>>>(a...);
}
template <int NV, int MAXC, bool HAS_A, bool OWN_X1, class... A>
void launch_contract(Bf16, int blocks, cudaStream_t s, A... a) {
  from_rgb_contract_bf16<NV, MAXC, HAS_A, OWN_X1>
      <<<blocks, kThreads, 0, s>>>(a...);
}
template <int NV, int MAXC, bool HAS_A, bool OWN_X1, class... A>
void launch_contract(F32, int blocks, cudaStream_t s, A... a) {
  from_rgb_contract_f32<NV, MAXC, HAS_A, OWN_X1>
      <<<blocks, kThreads, 0, s>>>(a...);
}
template <int NV, int MAXC, int K, class... A>
void launch_expand(Bf16, int blocks, cudaStream_t s, A... a) {
  from_rgb_expand_bf16<NV, MAXC, K><<<blocks, kThreads, 0, s>>>(a...);
}
template <int NV, int MAXC, int K, class... A>
void launch_expand(F32, int blocks, cudaStream_t s, A... a) {
  from_rgb_expand_f32<NV, MAXC, K><<<blocks, kThreads, 0, s>>>(a...);
}
template <class... A>
void launch_sum(Bf16, int grid, cudaStream_t s, A... a) {
  from_rgb_sum_bf16<<<grid, dim3(kSumThreads, kSumThreads), 0, s>>>(a...);
}
template <class... A>
void launch_sum(F32, int grid, cudaStream_t s, A... a) {
  from_rgb_sum_f32<<<grid, dim3(kSumThreads, kSumThreads), 0, s>>>(a...);
}

// lanes and vectors a lane for cout channels of V: cout a power of two
// times the 16-byte vector, at most 8 channels a thread and 32 lanes.
template <class V>
bool geometry(int cout, int* lanes, int* nv) {
  if (cout <= 0 || cout > kMaxCout || cout % V::kN) return false;
  const int vecs = cout / V::kN;
  if (vecs & (vecs - 1)) return false;
  *nv = vecs > 32 ? vecs / 32 : 1;
  *lanes = vecs / *nv;
  return *nv * V::kN <= 8;
}

template <int N, int M>
struct Inst {
  static constexpr int kNv = N, kMaxc = M;
};

// Calls fn(Inst<NV, MAXC>()) for V's vectors a lane and cin input channels
// (MAXC 2 for cin <= 2, else 4); false for a shape the kernels lack.
template <class V, class Fn>
bool dispatch(int nv, int cin, Fn fn) {
  if (cin < 1 || cin > kMaxCin) return false;
  if (nv == 1) {
    if (cin <= 2) fn(Inst<1, 2>()); else fn(Inst<1, 4>());
    return true;
  }
  if constexpr (V::kN == 4) {
    if (nv == 2) {
      if (cin <= 2) fn(Inst<2, 2>()); else fn(Inst<2, 4>());
      return true;
    }
  }
  return false;
}

template <bool B>
struct Flag {
  static constexpr bool kOn = B;
};

// Calls fn(Flag<a>(), Flag<b>()).
template <class Fn>
void flags(bool a, bool b, Fn fn) {
  if (a) {
    if (b) fn(Flag<true>(), Flag<true>()); else fn(Flag<true>(), Flag<false>());
  } else {
    if (b) fn(Flag<false>(), Flag<true>()); else fn(Flag<false>(), Flag<false>());
  }
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

template <class V>
int forward(const void* x, const void* w, const void* b, void* y,
            long long rows, int cin, int cout, float slope, void* stream) {
  using E = typename V::E;
  int lanes = 0, nv = 0;
  if (rows < 0 || !geometry<V>(cout, &lanes, &nv)) return kBad;
  if (x == nullptr || w == nullptr || b == nullptr || y == nullptr) {
    return kBad;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_blocks(rows, lanes);
  const bool ok = dispatch<V>(nv, cin, [&](auto inst) {
    using I = decltype(inst);
    if (blocks > 0) {
      launch_fwd<I::kNv, I::kMaxc>(V(), blocks, s, static_cast<const E*>(x),
                                   static_cast<const E*>(w),
                                   static_cast<const E*>(b),
                                   static_cast<uint4*>(y), rows, cin, lanes,
                                   slope);
    }
  });
  if (!ok) return kBad;
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int contract(const void* g, const void* x1, const void* w1, const void* x,
             const void* w, const void* b, void* a, void* partials, void* gw,
             void* gb, long long rows, int cin, int cout, float slope,
             void* stream) {
  using E = typename V::E;
  int lanes = 0, nv = 0;
  if (rows < 0 || !geometry<V>(cout, &lanes, &nv)) return kBad;
  const bool sums = gw != nullptr || gb != nullptr;
  if (g == nullptr || x == nullptr || w == nullptr || b == nullptr
      || (a != nullptr && w1 == nullptr) || (gw != nullptr && x1 == nullptr)
      || (sums && partials == nullptr)) {
    return kBad;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_blocks(rows, lanes);
  // B's X1: x itself (whose bits a thread loads once) or a tensor of its
  // own; without B, C's instance takes x's bits and leaves B unread.
  const bool own_x1 = gw != nullptr && x1 != x;
  const bool ok = dispatch<V>(nv, cin, [&](auto inst) {
    using I = decltype(inst);
    flags(a != nullptr, own_x1, [&](auto has_a, auto own) {
      if (blocks > 0) {
        launch_contract<I::kNv, I::kMaxc, decltype(has_a)::kOn,
                        decltype(own)::kOn>(
            V(), blocks, s, static_cast<const uint4*>(g),
            static_cast<const E*>(own_x1 ? x1 : nullptr),
            static_cast<const E*>(w1), static_cast<const E*>(x),
            static_cast<const E*>(w), static_cast<const E*>(b),
            static_cast<E*>(a),
            sums ? static_cast<float*>(partials) : nullptr, rows, cin, lanes,
            slope);
      }
    });
  });
  if (!ok) return kBad;
  if (sums && blocks > 0) {
    const int entries = cout * (cin + 1);
    launch_sum(V(), (entries + kSumThreads - 1) / kSumThreads, s,
               static_cast<const float*>(partials), blocks, entries,
               cout * cin, static_cast<E*>(gw), static_cast<E*>(gb));
  }
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int expand(const void* u, const void* v, const void* d, const void* x,
           const void* w, const void* b, void* out, long long rows, int cin,
           int k, int cout, float slope, void* stream) {
  using E = typename V::E;
  int lanes = 0, nv = 0;
  if (rows < 0 || !geometry<V>(cout, &lanes, &nv)) return kBad;
  if (x == nullptr || w == nullptr || b == nullptr || out == nullptr
      || k < 0 || k > 2 * cin || (k > 0 && (u == nullptr || v == nullptr))) {
    return kBad;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_blocks(rows, lanes);
  const bool ok = dispatch<V>(nv, cin, [&](auto inst) {
    using I = decltype(inst);
    auto go = [&](auto both) {   // u's columns: up to MAXC, or 2 MAXC
      constexpr int K = decltype(both)::kOn ? 2 * I::kMaxc : I::kMaxc;
      launch_expand<I::kNv, I::kMaxc, K>(
          V(), blocks, s, static_cast<const E*>(u), static_cast<const E*>(v),
          static_cast<const E*>(d), static_cast<const E*>(x),
          static_cast<const E*>(w), static_cast<const E*>(b),
          static_cast<uint4*>(out), rows, cin, k, lanes, slope);
    };
    if (blocks <= 0) return;
    if (k <= I::kMaxc) go(Flag<false>()); else go(Flag<true>());
  });
  if (!ok) return kBad;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// contract's blocks for `rows` pixels of `cout` channels of `elem_bytes`
// bytes (4 float32, 2 bf16): the rows of float32 partial sums, each of
// cout * (cin + 1) entries, that its `partials` needs. -1 for a width the
// kernels do not take.
int from_rgb_blocks(long long rows, int cout, int elem_bytes) {
  int lanes = 0, nv = 0;
  const bool ok = elem_bytes == 2 ? geometry<Bf16>(cout, &lanes, &nv)
                                  : geometry<F32>(cout, &lanes, &nv);
  if (rows < 0 || !ok) return -1;
  return grid_blocks(rows, lanes);
}

// x [rows, cin], w [cout, cin], b [cout], y [rows, cout], contiguous, in
// float32 (or bf16 for the _bf16 entries); y 16-byte aligned. cin 1 to 4;
// cout a power of two times the 16-byte vector, 8 to 256.
int from_rgb_forward_f32(const void* x, const void* w, const void* b, void* y,
                         long long rows, int cin, int cout, float slope,
                         void* stream) {
  return forward<F32>(x, w, b, y, rows, cin, cout, slope, stream);
}

int from_rgb_forward_bf16(const void* x, const void* w, const void* b,
                          void* y, long long rows, int cin, int cout,
                          float slope, void* stream) {
  return forward<Bf16>(x, w, b, y, rows, cin, cout, slope, stream);
}

// g [rows, cout] 16-byte aligned; x1, a [rows, cin]; w1, gw [cout, cin];
// gb [cout]; x, w, b as for the forward. a (needs w1), gw (needs x1) and
// gb may each be null; partials [from_rgb_blocks(rows, cout), cout * (cin
// + 1)] float32 scratch where gw or gb is asked for.
int from_rgb_contract_f32(const void* g, const void* x1, const void* w1,
                          const void* x, const void* w, const void* b,
                          void* a, void* partials, void* gw, void* gb,
                          long long rows, int cin, int cout, float slope,
                          void* stream) {
  return contract<F32>(g, x1, w1, x, w, b, a, partials, gw, gb, rows, cin,
                       cout, slope, stream);
}

int from_rgb_contract_bf16(const void* g, const void* x1, const void* w1,
                           const void* x, const void* w, const void* b,
                           void* a, void* partials, void* gw, void* gb,
                           long long rows, int cin, int cout, float slope,
                           void* stream) {
  return contract<Bf16>(g, x1, w1, x, w, b, a, partials, gw, gb, rows, cin,
                        cout, slope, stream);
}

// u [rows, k], v [cout, k] (k 0 to 2 cin; both may be null for k = 0),
// d [cout] or null, out [rows, cout] 16-byte aligned; x, w, b as for the
// forward.
int from_rgb_expand_f32(const void* u, const void* v, const void* d,
                        const void* x, const void* w, const void* b,
                        void* out, long long rows, int cin, int k, int cout,
                        float slope, void* stream) {
  return expand<F32>(u, v, d, x, w, b, out, rows, cin, k, cout, slope,
                     stream);
}

int from_rgb_expand_bf16(const void* u, const void* v, const void* d,
                         const void* x, const void* w, const void* b,
                         void* out, long long rows, int cin, int k, int cout,
                         float slope, void* stream) {
  return expand<Bf16>(u, v, d, x, w, b, out, rows, cin, k, cout, slope,
                      stream);
}

}  // extern "C"
