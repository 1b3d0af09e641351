// Philox4x32-10 (Salmon et al. 2011), the port's random stream.
//
// The same rounds, key schedule and stream layout as the plain-torch
// version in ops/philox.py; a kernel and its plain version draw identical
// words for identical counters.  Written by hand rather than taken from
// curand_kernel.h so that the plain version needs to reproduce nothing
// but these ten rounds.
//
// Counter: (walker_index, split, offset_lo, offset_hi).  Key: the 64-bit
// seed.  Word 0: stretch z uniform.  Word 1: accept uniform.  Word 2:
// random-pair partner uniform.  Words 0 and 2 in a DE proposal: the
// walker's Box-Muller normal.  Split word PAIR_BLOCK | split: the DE and
// snooker random-pair picks (words 0-2) and snooker role permutation
// (word 3).  walker_index = ROLL_LANE: the split's roll draws (one Philox
// block), made once per block, by one lane, in K1, K5a and K5b.
//
// The offset is a device word plus an increment: a kernel recorded into a
// CUDA graph reads the chain's proposal counter from device memory
// (offset_dev, advanced by the graph itself) and adds the proposal's place
// in the graph (offset), so every replay draws fresh numbers.  A null
// offset_dev means the offset is the increment alone.
#pragma once

#include <cstdint>

#define EMCEE_ROLL_LANE 0xFFFFFFFFu
#define EMCEE_PAIR_BLOCK 0x80000000u

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The ten rounds' keys of a seed, for a thread that draws many blocks:
// computed once, they take the key schedule's adds out of every block.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    k.k1[r] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  return k;
}

// philox4x32_10 with the keys of philox_keys: the same words.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const PhiloxKeys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.k0[r], lo1, hi0 ^ c.w ^ k.k1[r], lo0);
  }
  return c;
}

// The proposal offset: *offset_dev + inc, or inc when offset_dev is null.
__device__ __forceinline__ uint64_t philox_offset(
    const long long* __restrict__ offset_dev, unsigned long long inc) {
  return (offset_dev != nullptr ? static_cast<uint64_t>(*offset_dev) : 0ull) +
         inc;
}

// The four Philox words at counter (lane, split, offset).
__device__ __forceinline__ uint4 philox_at(uint32_t lane, uint32_t split,
                                           uint64_t offset, uint32_t k0,
                                           uint32_t k1) {
  return philox4x32_10(make_uint4(lane, split, static_cast<uint32_t>(offset),
                                  static_cast<uint32_t>(offset >> 32)),
                       k0, k1);
}

// 24 random bits as a float32 in [0, 1), exact (as jax.random.uniform).
__device__ __forceinline__ float philox_uniform(uint32_t w) {
  return static_cast<float>(w >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// A standard normal by Box-Muller: sqrt(-2 log(1 - u0)) cos(2 pi u2), each
// operation rounded once, as ops/philox.py box_muller computes it; logf and
// cosf are the accurate libdevice functions (no --use_fast_math).
__device__ __forceinline__ float philox_normal(uint32_t w0, uint32_t w2) {
  const float r = __fsqrt_rn(
      __fmul_rn(-2.0f, logf(__fsub_rn(1.0f, philox_uniform(w0)))));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318548202514648f,
                                     philox_uniform(w2))));
}
