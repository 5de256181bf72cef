// Threefry-2x32 (20 rounds), bit for bit as jax.random draws it with the
// threefry2x32 implementation (jax._src.prng.threefry2x32_p).
//
// threefry::bits(k0, k1, c_hi, c_lo) is jax.random.bits' uint32 word at
// counter (c_hi, c_lo) under key (k0, k1): out0 ^ out1 of the cipher.  The
// counter of element i (flat row-major) of a draw is (i >> 32, i & ~0u).
// The rotations are funnel shifts, one instruction each.

#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 13);
  mix(x0, x1, 15);
  mix(x0, x1, 26);
  mix(x0, x1, 6);
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 17);
  mix(x0, x1, 29);
  mix(x0, x1, 16);
  mix(x0, x1, 24);
}

// 73 integer operations per word (60 in the rounds, counting a funnel
// shift as one; 12 key injections; the output xor), plus a few per key
// (the third key word, the k + i sums) that a caller drawing many words
// from one key can hoist.
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t c_hi, uint32_t c_lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c_hi + k0;
  uint32_t x1 = c_lo + k1;
  rounds_a(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds_b(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds_a(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds_b(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds_a(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

}  // namespace threefry
