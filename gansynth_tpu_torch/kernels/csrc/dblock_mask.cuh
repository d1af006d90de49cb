// The layout of K3's z1 mask, the one place it is defined: the saving
// forward writes it (csrc/dblock.cu, both instances SAVE = 1), the
// backward's spread kernel reads it (csrc/dblock_grad.cu), and
// kernels/dblock.py:pack_mask / unpack_mask are its plain versions.
//
// The mask holds the sign of z1 = conv1 + b1, one bit an element, set
// where z1 >= 0. A pixel has kPassBytes bytes for each 64-channel pass of
// conv1: four little-endian 16-bit halfwords. Channel c = 8 j + 2 t + e of
// a pass (j < 8, t < 4, e < 2) is bit 2 j + e of halfword t, which is bit
// bit(j, t, e) = 16 t + 2 j + e of the pass's 64. That is the order of the
// bf16 wgmma accumulators: lane t of a quad holds exactly channels
// 8 j + 2 t + e of its columns, so it stores its halfword as it is, with
// no shuffle. Channels past C1 read 0.

#pragma once

#include <cstdint>

namespace dblock_mask {

constexpr int kPassBytes = 8;   // a pixel's bytes for one 64-channel pass

// Bytes a pixel of the mask for C1 channels.
__host__ __device__ constexpr int pixel_bytes(int c1) {
  return kPassBytes * ((c1 + 63) / 64);
}

// The bit of channel 8 j + 2 t + e of a pass, among the pass's 64.
__host__ __device__ constexpr int bit(int j, int t, int e) {
  return 16 * t + 2 * j + e;
}

// The byte of the halfword t of pass p, within a pixel's mask.
__host__ __device__ constexpr int halfword_byte(int p, int t) {
  return kPassBytes * p + 2 * t;
}

// The bits of a pixel's unit u (channels 8 u .. 8 u + 7) as bits 0..7:
// unit u is j = u % 8 of pass u / 8, bits 2 j and 2 j + 1 of each of the
// pass's four halfwords.
__device__ __forceinline__ uint32_t unit_bits(const uint8_t* pixel, int u) {
  const uint2 w =
      *reinterpret_cast<const uint2*>(pixel + kPassBytes * (u / 8));
  const int sh = bit(u % 8, 0, 0);
  const uint32_t lo = w.x >> sh, hi = w.y >> sh;
  return (lo & 3u) | ((lo >> 14) & 0xcu) | ((hi & 3u) << 4) |
         ((hi >> 10) & 0xc0u);
}

}  // namespace dblock_mask
