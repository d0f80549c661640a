// K4 and K5: one fused HMC trajectory of a batch of chains in one launch:
// the leapfrog trajectory, the delta-form energy difference, the Metropolis
// accept and the wrap, chains-first (B, 2, L, L).
//
// K4 replaces fthmc_tpu/ops/pallas_lattice.py::_hmc_traj_kernel
// (pallas_hmc_traj): the momenta and the accept draw come from the
// in-kernel Philox4x32-10 stream (philox.cuh) keyed by (seed, chain), the
// seed read from device memory so the caller never syncs. The drawn
// momenta are kept in shared memory for the kinetic term at the end.
// K5 replaces _hmc_traj_hostrng_kernel (pallas_hmc_traj_hostrng): the same
// with the caller's momenta v0 and accept draws u.
// Both run the band body of traj_common.cuh (a cluster of C row bands a
// chain, each thread's S sites in registers), where the design and what
// bounds it (operations: ~35 a site a step, sinf the most of them) are
// described. Bound and time: PERF.md.
#include "philox.cuh"
#include "traj_common.cuh"

template <int S, bool FULL, bool HOSTRNG>
__global__ void __launch_bounds__(traj_max_threads(S))
    hmc_band_kernel(const float* __restrict__ x,
                    const float* __restrict__ v0,
                    const float* __restrict__ u,
                    const int* __restrict__ seed, float* __restrict__ xo,
                    float* __restrict__ dh_out, float* __restrict__ acc_out,
                    TrajArgs a, Bands bands) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int L = a.L, LL = L * L;
  const BandSmem m =
      band_smem(L, a.rows, blockDim.x, HOSTRNG ? TRAJ_HMC_HOSTRNG : TRAJ_HMC);
  const BandGeo g = band_geo<S>(bands, L, sm, m);
  const size_t off = static_cast<size_t>(g.b) * 2 * LL;
  const float* xb = x + off;
  const int RL = a.rows * L, base = g.g0 * L + g.j;
  float* c0s = sm + m.c0s;
  float* v0s = sm + m.v0s;
  const uint32_t sd = HOSTRNG ? 0u : static_cast<uint32_t>(*seed);

  float x0[S], x1[S], p0[S], p1[S], P[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x0[k] = x1[k] = p0[k] = p1[k] = 0.f;
    if (FULL || k < g.nv) {
      const int s = band_site(g, k);
      x0[k] = xb[s];
      x1[k] = xb[LL + s];
      if constexpr (HOSTRNG) {
        p0[k] = v0[off + s];
        p1[k] = v0[off + LL + s];
      } else {
        p0[k] = momentum_draw(sd, g.b, 0, s);
        p1[k] = momentum_draw(sd, g.b, 1, s);
        v0s[base + k * L] = p0[k];
        v0s[RL + base + k * L] = p1[k];
      }
    }
  }
  // cos P0 of the starting links, kept for the delta-form action
  band_plaq<S, FULL>(P, x0, x1, g, sm + m.xs0, sm + m.x1f);
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (FULL || k < g.nv) c0s[base + k * L] = cosf(P[k]);
  band_sync(g.C);   // the links are published again below

  band_leapfrog<S, FULL>(x0, x1, p0, p1, g, sm, m, a);

  // dH = -beta sum(cos P1 - cos P0) + 1/2 sum (v1 - v0)(v1 + v0), never a
  // difference of totals
  band_plaq<S, FULL>(P, x0, x1, g, sm + m.xs0, sm + m.x1f);
  float dsw = 0.f, dk = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < g.nv) {
      const int s = band_site(g, k), q = base + k * L;
      dsw += __fsub_rn(cosf(P[k]), c0s[q]);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float v1 = d == 0 ? p0[k] : p1[k];
        const float vi = HOSTRNG ? v0[off + d * LL + s] : v0s[d * RL + q];
        dk += __fmul_rn(__fsub_rn(v1, vi), __fadd_rn(v1, vi));
      }
    }
  }
  band_sum2(dsw, dk, g, sm, m);
  const float dh = __fadd_rn(__fmul_rn(-a.beta, dsw), __fmul_rn(0.5f, dk));
  const float ua = HOSTRNG ? u[g.b] : accept_draw(sd, g.b);
  const bool acc = ua < expf(-dh);
  if (g.rank == 0 && threadIdx.x == 0) {
    dh_out[g.b] = dh;
    acc_out[g.b] = acc ? 1.f : 0.f;
  }
  float* xob = xo + off;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < g.nv) {
      const int s = band_site(g, k);
      xob[s] = acc ? wrap_pi(x0[k]) : xb[s];
      xob[LL + s] = acc ? wrap_pi(x1[k]) : xb[LL + s];
    }
  }
  if (g.C > 1) cg::this_cluster().sync();   // peers read our sums
}

template <bool HOSTRNG>
struct HmcLaunch {
  int bytes, threads;
  TrajArgs a;
  Bands bands;
  void* stream;
  const float *x, *v0, *u;
  const int* seed;
  float *xo, *dh, *acc;

  template <int S, bool FULL>
  int run() const {
    static int set_bytes[64];
    return launch_band(&hmc_band_kernel<S, FULL, HOSTRNG>, set_bytes, bytes,
                       a.B, bands.C, threads, stream, x, v0, u, seed, xo, dh,
                       acc, a, bands);
  }
};

template <bool HOSTRNG>
int hmc_entry(const float* x, const float* v0, const float* u,
              const int* seed, float* xo, float* dh, float* acc, int B,
              int L, float beta, float dt, float hdt, int nstep, int C,
              const int* row0, int threads, int sites, void* stream) {
  HmcLaunch<HOSTRNG> k{0,  threads, traj_args(B, L, beta, dt, hdt, nstep),
                       Bands(), stream, x, v0, u, seed, xo, dh, acc};
  bool full = false;
  k.bytes = band_plan(HOSTRNG ? TRAJ_HMC_HOSTRNG : TRAJ_HMC, C, row0,
                      threads, sites, &k.a, &k.bands, &full);
  if (k.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return band_dispatch(sites, full, k);
}

// x, xo: (B, 2, L, L); dh, acc: (B,); seed: one int32; fp32 contiguous.
// (C, row0[C + 1], threads, sites): the band plan (traj_common.cuh).
extern "C" int k4_hmc_traj(const float* x, const int* seed, float* xo,
                           float* dh, float* acc, int B, int L, float beta,
                           float dt, float hdt, int nstep, int C,
                           const int* row0, int threads, int sites,
                           void* stream) {
  return hmc_entry<false>(x, nullptr, nullptr, seed, xo, dh, acc, B, L, beta,
                          dt, hdt, nstep, C, row0, threads, sites, stream);
}

// x, v0, xo: (B, 2, L, L); u, dh, acc: (B,); fp32 contiguous; the plan as
// k4_hmc_traj's.
extern "C" int k5_hmc_traj_hostrng(const float* x, const float* v0,
                                   const float* u, float* xo, float* dh,
                                   float* acc, int B, int L, float beta,
                                   float dt, float hdt, int nstep, int C,
                                   const int* row0, int threads, int sites,
                                   void* stream) {
  return hmc_entry<true>(x, v0, u, nullptr, xo, dh, acc, B, L, beta, dt, hdt,
                         nstep, C, row0, threads, sites, stream);
}
