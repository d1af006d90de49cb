// K1: mel-IF image -> complex synthesis spectrum, for Hopper (sm_90a).
//
// Replaces the TPU kernel gansynth_tpu/kernels/pallas_synthesis.py:
// synthesis_spectrum_pallas (body _make_kernel). It computes, for an image
// [B, T, M, 2] f32 (channel 0 the scaled log-mel-magnitude, channel 1 the
// mel-IF) and the mel pseudo-inverse m2l [M, F] f32:
//
//   E   = exp(ch0 * a + b)                           [B*T, M]
//   P   = cumsum over t of (mif * pi)                [B*T, M]
//   mag = sqrt(max(E @ m2l, 0) + eps)                [B*T, F]
//   phi = P @ m2l                                    [B*T, F]
//   re  = mag * cos(phi),  im = mag * sin(phi)
//
// What bounds it on an H100: bytes. m2l is banded: linear bin f has at most
// two nonzeros, in two neighbouring mel rows (2042 of its 1M entries), so
// each product is a gather of <= 2 taps per output. The function reads the
// image once and writes Re and Im once, ~34 MB at B=16, T=128, M=F=1024:
// about 10 us at 3.35 TB/s, against 17 MFLOP of products.
//
// Design: one launch, no scratch in device memory. One block per (batch
// element, strip of kStrip linear bins); the batch element varies fastest
// in the grid, so the strips with the widest mel spans (the low end) are
// dispatched first and the short ones fill the tail. The wrapper hands over the tap
// table (for each f, its <= 2 mel indices in ascending order and their
// weights; index -1 pads a column with fewer taps) and, for each strip, the
// span of mel columns its taps touch [m_lo, m_lo + span), m_lo and span
// even, so that the span is a whole number of 16-byte (x0, y0, x1, y1)
// pairs. The block walks the T frames in chunks of kChunk, two buffers
// deep; for each chunk it
//  1. has the next chunk's copies in flight (cp.async, 16 bytes a thread,
//     neighbouring threads on neighbouring addresses) while it works on
//     this one;
//  2. turns each (x, y) into (E, mif * pi) in place, all threads at once;
//  3. runs the time cumsum: one thread per mel column of the span walks the
//     chunk's frames in order with the running sum in a register, carried
//     to the next chunk, the product and the sum rounded separately, as a
//     plain cumsum does;
//  4. gives each thread a linear bin and every (kThreads / kStrip)-th frame:
//     it gathers its <= 2 taps of (E, P) from shared memory, ascending in
//     mel as a dense dot over ascending k takes them, and writes Re and Im,
//     neighbouring threads on neighbouring bins.
// A strip at the low end spans up to 62 mel columns (the mel bands are
// narrower than a linear bin there), at the high end 6: the block's
// dynamic shared memory is 2 * kChunk * span_max * 8 bytes (31 KB), so up
// to seven blocks of 256 threads share an SM and their loads, exps, sums
// and stores overlap. With kStrip = 16, B=1 already launches 64 blocks.
//
// Accuracy: magnitudes reach ~1e3 and phases ~128 pi, so this file is built
// without --use_fast_math and uses the accurate expf/sincosf/sqrtf, whose
// error does not grow with the argument. For each output the sums are
// fmaf(E1, w1, E0 * w0), the very roundings of a dense FMA dot over
// ascending k, since the zero weights add exact zeros.
//
// Plain C interface for ctypes: raw pointers, sizes, the cudaStream_t as
// void*, and the cudaError_t of the launch as the return value. The caller
// allocates the outputs.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr int kStrip = 16;                    // linear bins per block
constexpr int kThreads = 256;
constexpr int kFrameStep = kThreads / kStrip;  // frames between a thread's outputs
constexpr int kChunk = 32;                    // frames staged at a time

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Starts the copies of frames [t0, t0 + count) of the strip's mel span into
// `buf` ([count][span] (x, y) pairs) and commits them as one group.
__device__ __forceinline__ void load_chunk(float4* buf, const float4* src,
                                           int row_pairs, int pairs, int t0,
                                           int count) {
  const int n = count * pairs;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = i / pairs;
    cp_async16(&buf[i],
               src + static_cast<size_t>(t0 + t) * row_pairs + (i - t * pairs));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
synthesis_spectrum_gather(const float4* __restrict__ image,
                          const int2* __restrict__ tap_index,
                          const float2* __restrict__ tap_weight,
                          const int2* __restrict__ strips,
                          float* __restrict__ re, float* __restrict__ im,
                          int frames, int mel_bins, int freq_bins,
                          int span_max, float a, float b, float eps) {
  // Two buffers of [kChunk][span] (x, y) pairs, turned into (E, P) in place.
  extern __shared__ float4 smem4[];

  const int tid = threadIdx.x;
  const int strip = blockIdx.y;
  const int batch = blockIdx.x;
  const int2 st = strips[strip];   // (m_lo, span), both even
  const int m_lo = st.x;
  const int span = st.y;
  const int pairs = span / 2;
  const int row_pairs = mel_bins / 2;
  const int buf_pairs = kChunk * span_max / 2;
  const float4* src = image + static_cast<size_t>(batch) * frames * row_pairs
                      + m_lo / 2;

  // This thread's linear bin, its taps as columns of the span, and its
  // outputs' rows.
  const int f = strip * kStrip + tid % kStrip;
  const int2 idx = tap_index[f];
  const float2 w = tap_weight[f];
  const int i0 = idx.x - m_lo;
  const int i1 = idx.y - m_lo;
  float* re_out = re + static_cast<size_t>(batch) * frames * freq_bins + f;
  float* im_out = im + static_cast<size_t>(batch) * frames * freq_bins + f;

  float phase = 0.0f;   // the running phase sum of column tid (tid < span)
  load_chunk(smem4, src, row_pairs, pairs, 0, min(kChunk, frames));
  for (int t0 = 0, k = 0; t0 < frames; t0 += kChunk, k ^= 1) {
    const int count = min(kChunk, frames - t0);
    float4* buf4 = smem4 + k * buf_pairs;
    float2* buf = reinterpret_cast<float2*>(buf4);
    // 1. the next chunk's copies go out; wait for this chunk's
    if (t0 + kChunk < frames) {
      load_chunk(smem4 + (k ^ 1) * buf_pairs, src, row_pairs, pairs,
                 t0 + kChunk, min(kChunk, frames - t0 - kChunk));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    // 2. (x, y) -> (exp(x * a + b), y * pi)
    for (int i = tid; i < count * pairs; i += kThreads) {
      float4 v = buf4[i];
      v.x = expf(__fmaf_rn(v.x, a, b));
      v.y = __fmul_rn(v.y, kPi);
      v.z = expf(__fmaf_rn(v.z, a, b));
      v.w = __fmul_rn(v.w, kPi);
      buf4[i] = v;
    }
    __syncthreads();

    // 3. the time cumsum of each mel column, in frame order, carried from
    //    chunk to chunk in a register (the loads of 8 frames go out before
    //    the 8 dependent adds)
    if (tid < span) {
      for (int t = 0; t < count; t += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = t + j < count ? buf[(t + j) * span + tid].y : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (t + j < count) {
            phase = __fadd_rn(phase, v[j]);
            buf[(t + j) * span + tid].y = phase;
          }
        }
      }
    }
    __syncthreads();

    // 4. gather <= 2 taps per (frame, linear bin), polar -> rect
    for (int t = tid / kStrip; t < count; t += kFrameStep) {
      float mag2 = 0.0f;
      float phi = 0.0f;
      if (idx.x >= 0) {
        const float2 e = buf[t * span + i0];
        mag2 = __fmul_rn(e.x, w.x);
        phi = __fmul_rn(e.y, w.x);
      }
      if (idx.y >= 0) {
        const float2 e = buf[t * span + i1];
        mag2 = __fmaf_rn(e.x, w.y, mag2);
        phi = __fmaf_rn(e.y, w.y, phi);
      }
      const float mag = sqrtf(fmaxf(mag2, 0.0f) + eps);
      float s, c;
      sincosf(phi, &s, &c);
      const size_t o = static_cast<size_t>(t0 + t) * freq_bins;
      re_out[o] = mag * c;
      im_out[o] = mag * s;
    }
    __syncthreads();   // the buffer is refilled two chunks on
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a widest strip span of `span_max`
// mel columns: two chunks of kChunk frames.
int synthesis_spectrum_smem_bytes(int span_max) {
  return 2 * kChunk * span_max * static_cast<int>(sizeof(float2));
}

// image [batch, frames, mel_bins, 2] f32, 16-byte aligned; tap_index
// [freq_bins, 2] int32 (ascending mel per bin, -1 pads); tap_weight
// [freq_bins, 2] f32; strips [num_strips, 2] int32 (m_lo, span), both even,
// span <= span_max, one row per kStrip = 16 linear bins (num_strips * 16 ==
// freq_bins); re, im [batch, frames, freq_bins] f32. All contiguous. Needs
// mel_bins even, and span_max small enough that the block's shared memory
// fits the default 48 KB without an opt-in (span_max <= 96).
int synthesis_spectrum_f32(const void* image, const void* tap_index,
                           const void* tap_weight, const void* strips,
                           int num_strips, int span_max, void* re, void* im,
                           int batch, int frames, int mel_bins, int freq_bins,
                           float a, float b, float eps, void* stream) {
  const int smem = synthesis_spectrum_smem_bytes(span_max);
  if (batch <= 0 || frames <= 0 || mel_bins <= 0 || mel_bins % 2 != 0 ||
      num_strips <= 0 || num_strips * kStrip != freq_bins || span_max <= 0 ||
      span_max % 2 != 0 || span_max > mel_bins || span_max > kThreads ||
      smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(batch, num_strips);
  synthesis_spectrum_gather<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(image), static_cast<const int2*>(tap_index),
      static_cast<const float2*>(tap_weight), static_cast<const int2*>(strips),
      static_cast<float*>(re), static_cast<float*>(im), frames, mel_bins,
      freq_bins, span_max, a, b, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
