// The port's counter-based generator: Philox4x32-10 (Salmon et al., SC'11,
// "Parallel random numbers: as easy as 1, 2, 3"), for the in-kernel draws
// of K4 (hmc_traj.cu).
//
// Keyed by (seed, chain); the counter runs over (site, link direction,
// draw kind, 0): kind 0 is a link's momentum, kind 1 (at site 0,
// direction 0) the chain's accept draw. Stateless, so a draw is recomputed
// wherever it is needed instead of stored. Bit for bit the same stream as
// the plain twin fthmc_tpu_torch/ops/rng.py.
//
// Uniforms: 24 bits of a word, (0, 1] as the JAX package's
// _uniform_from_bits (fthmc_tpu/ops/pallas_lattice.py:243-249), so
// log(u) is finite. Normals: one Box-Muller branch, r cos(2 pi u2), as its
// _gaussians (pallas_lattice.py:252-257).
#pragma once

#include <stdint.h>

#include "common.cuh"

struct Philox4 {
  uint32_t w[4];
};

__host__ __device__ inline Philox4 philox4x32_10(Philox4 c, uint32_t k0,
                                                 uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c.w[0];
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c.w[2];
    Philox4 n;
    n.w[0] = static_cast<uint32_t>(p1 >> 32) ^ c.w[1] ^ k0;
    n.w[1] = static_cast<uint32_t>(p1);
    n.w[2] = static_cast<uint32_t>(p0 >> 32) ^ c.w[3] ^ k1;
    n.w[3] = static_cast<uint32_t>(p0);
    c = n;
  }
  return c;
}

// (m + 1) 2^-24 for the top 24 of the low 31 bits: exact in fp32.
__device__ __forceinline__ float uniform24(uint32_t w) {
  const float m = static_cast<float>((w & 0x7FFFFFFFu) >> 7);
  return __fadd_rn(__fmul_rn(m, 5.9604644775390625e-08f),
                   5.9604644775390625e-08f);
}

// Momentum of link (d, s) of chain b: sqrt(-2 log u1) cos(2 pi u2).
__device__ __forceinline__ float momentum_draw(uint32_t seed, int b, int d,
                                               int s) {
  Philox4 c = {{static_cast<uint32_t>(s), static_cast<uint32_t>(d), 0u, 0u}};
  c = philox4x32_10(c, seed, static_cast<uint32_t>(b));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(uniform24(c.w[0]))));
  return __fmul_rn(r, cosf(__fmul_rn(FT_TWO_PI, uniform24(c.w[1]))));
}

// The accept draw of chain b.
__device__ __forceinline__ float accept_draw(uint32_t seed, int b) {
  Philox4 c = {{0u, 0u, 1u, 0u}};
  c = philox4x32_10(c, seed, static_cast<uint32_t>(b));
  return uniform24(c.w[0]);
}
