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
// K12 (below) ends the plain step after a trajectory of K2, K3 or the K1
// loop.
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

// ---------------------------------------------------------------------------
// K12: the plain step's epilogue
// ---------------------------------------------------------------------------
//
// After a trajectory of K2, K3 or the K1 loop, one pass over the fields does
// what hmc._hmc_step did in ~55 torch launches: wrap the trajectory's end
// x1, the delta-form dH (per-site cos P1 - cos P0, never a difference of
// totals, and (v1 - v0)(v1 + v0)), the Metropolis accept on the caller's
// uniforms u, the chosen field x_new, and its plaquette and charge with the
// charge's change from q_old. It replaces no TPU kernel: on the TPU, XLA
// fuses this epilogue (fthmc_tpu/hmc.py:195-212, the ops K12 follows).
// Bounded by bytes: four fields read (x, x1, v1, v0) and one written, ~80
// operations a site. Each thread loads its S sites of all four fields before
// any arithmetic (8 S independent loads in flight), takes P of both fields
// through band_plaq (K2's band geometry: every field K2 and K3 take runs
// under a traj_plan, up to L = 256), and keeps cos P0 and both fields in
// registers until the chain's decision; the six sums (band_sum_n) come back
// to every CTA of the chain, so the write of x_new needs no second pass.
// Above 256, where only the K1 loop runs, epilogue_wide_kernel (at the end)
// does the same a thread a column. Its four wraps a site (two links, two
// plaquettes) are wrap_floor's, not fmodf's.

// Floor-mod wrap to [-pi, pi): v - 2 pi floor((v + pi) / 2 pi) by a
// multiply, a floor and an fma, put back inside where the quotient's
// rounding leaves it an ulp out. It agrees with wrap_pi (and
// torch.remainder) to an ulp of the angle at a fraction of fmodf's
// instructions: at 64^2 x 1024 on an H100, K12 took 0.107 ms with wrap_pi
// (its fastest plan) and 0.077 with this, in one run (PERF.md).
__device__ __forceinline__ float wrap_floor(float v) {
  const float k =
      floorf(__fmul_rn(__fadd_rn(v, FT_PI), 0.159154943091895336f));
  float r = __fmaf_rn(-k, FT_TWO_PI, v);
  if (r >= FT_PI) r = __fsub_rn(r, FT_TWO_PI);
  if (r < -FT_PI) r = __fadd_rn(r, FT_TWO_PI);
  return r;
}

constexpr int EPI_SUMS = 6;   // cos P1 - cos P0, kinetic, cos P0, cos P1,
                              // wrap P0, wrap P1

// K12's shared memory, in floats: x0 of the band's rows (band_plaq's cells),
// x1 of each run's first row, the warps' sums and the CTA's. sin P is never
// published: band_geo's pointer to it (sps) aliases the x0 cells and is
// never read.
__host__ __device__ inline BandSmem epilogue_smem(int L, int R, int T) {
  BandSmem m;
  m.xs0 = m.sps = 0;
  m.x1f = R * L;
  m.red = m.x1f + T;
  m.part = m.red + 32 * EPI_SUMS;
  m.c0s = m.v0s = m.floats = m.part + EPI_SUMS;
  return m;
}

// The chain's decision from its six sums (every thread of the chain holds
// them) on its uniform u[b], and, where `write` (one thread of the chain),
// its six rows of out: dh, exp(-dh), acc, plaquette, charge, |q - q_old|.
__device__ inline bool epilogue_decide(const float (&s)[EPI_SUMS], float beta,
                                       const float* u, const float* q_old,
                                       int b, int B, int LL, bool write,
                                       float* out) {
  const float dh = __fadd_rn(__fmul_rn(-beta, s[0]), __fmul_rn(0.5f, s[1]));
  const float exp_mdh = expf(-dh);
  const bool acc = u[b] < exp_mdh;
  if (write) {
    const float q = __fdiv_rn(acc ? s[5] : s[4], FT_TWO_PI);
    out[b] = dh;
    out[B + b] = exp_mdh;
    out[2 * B + b] = acc ? 1.f : 0.f;
    out[3 * B + b] = __fdiv_rn(acc ? s[3] : s[2], static_cast<float>(LL));
    out[4 * B + b] = q;
    out[5 * B + b] = fabsf(__fsub_rn(q, q_old[b]));
  }
  return acc;
}

template <int S, bool FULL>
__global__ void __launch_bounds__(traj_max_threads(S))
    epilogue_band_kernel(const float* __restrict__ x,
                         const float* __restrict__ x1,
                         const float* __restrict__ v1,
                         const float* __restrict__ v0,
                         const float* __restrict__ u,
                         const float* __restrict__ q_old,
                         float* __restrict__ xo, float* __restrict__ out,
                         TrajArgs a, Bands bands) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int L = a.L, LL = L * L, B = a.B;
  const BandSmem m = epilogue_smem(L, a.rows, blockDim.x);
  const BandGeo g = band_geo<S>(bands, L, sm, m);
  const size_t off = static_cast<size_t>(g.b) * 2 * LL;
  // the start's links (a0, a1) and the trajectory's end, wrapped (b0, b1),
  // by direction
  float a0[S], a1[S], b0[S], b1[S], P[S], c0[S];
  float s[EPI_SUMS] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < S; ++k) {
    a0[k] = a1[k] = b0[k] = b1[k] = P[k] = c0[k] = 0.f;
    if (FULL || k < g.nv) {
      const size_t i = off + band_site(g, k);
      a0[k] = x[i];
      a1[k] = x[i + LL];
      b0[k] = wrap_floor(x1[i]);
      b1[k] = wrap_floor(x1[i + LL]);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float w1 = v1[i + d * LL], w0 = v0[i + d * LL];
        s[1] += __fmul_rn(__fsub_rn(w1, w0), __fadd_rn(w1, w0));
      }
    }
  }
  band_plaq<S, FULL>(P, a0, a1, g, sm + m.xs0, sm + m.x1f);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < g.nv) {
      c0[k] = cosf(P[k]);
      s[2] += c0[k];
      s[4] += wrap_floor(P[k]);
    }
  }
  band_sync(g.C);   // the trajectory's links are published in the same cells
  band_plaq<S, FULL>(P, b0, b1, g, sm + m.xs0, sm + m.x1f);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < g.nv) {
      const float c1 = cosf(P[k]);
      s[0] += __fsub_rn(c1, c0[k]);
      s[3] += c1;
      s[5] += wrap_floor(P[k]);
    }
  }
  band_sum_n<EPI_SUMS>(s, g.C, sm + m.red, sm + m.part);
  const bool acc = epilogue_decide(s, a.beta, u, q_old, g.b, B, LL,
                                   g.rank == 0 && threadIdx.x == 0, out);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < g.nv) {
      const size_t i = off + band_site(g, k);
      xo[i] = acc ? b0[k] : a0[k];
      xo[i + LL] = acc ? b1[k] : a1[k];
    }
  }
  if (g.C > 1) cg::this_cluster().sync();   // peers read our sums
}

struct EpilogueLaunch {
  int bytes, threads;
  TrajArgs a;
  Bands bands;
  void* stream;
  const float *x, *x1, *v1, *v0, *u, *q_old;
  float *xo, *out;

  template <int S, bool FULL>
  int run() const {
    static int set_bytes[64];
    return launch_band(&epilogue_band_kernel<S, FULL>, set_bytes, bytes, a.B,
                       bands.C, threads, stream, x, x1, v1, v0, u, q_old, xo,
                       out, a, bands);
  }
};

// Bytes of dynamic shared memory a K12 CTA takes under a band plan (the
// plans of K2: traj_band_smem_bytes' kind 0), -1 for what it does not take.
extern "C" int epilogue_smem_bytes(int L, int rows, int threads, int sites) {
  if (traj_band_smem_bytes(L, rows, threads, sites, TRAJ_LEAPFROG, 1) < 0)
    return -1;
  return static_cast<int>(sizeof(float)) *
         epilogue_smem(L, rows, threads).floats;
}

// x, x1, v1, v0, xo: (B, 2, L, L); u, q_old: (B,); out: (6, B), its rows
// dh, exp(-dh), acc, plaq, q, |q - q_old|; fp32 contiguous. (C, row0[C + 1],
// threads, sites): the band plan.
extern "C" int k12_hmc_epilogue(const float* x, const float* x1,
                                const float* v1, const float* v0,
                                const float* u, const float* q_old, float* xo,
                                float* out, int B, int L, float beta, int C,
                                const int* row0, int threads, int sites,
                                void* stream) {
  EpilogueLaunch k{0,      threads, traj_args(B, L, beta, 0.f, 0.f, 0),
                   Bands(), stream, x, x1, v1, v0, u, q_old, xo, out};
  bool full = false;
  if (band_plan(TRAJ_LEAPFROG, C, row0, threads, sites, &k.a, &k.bands,
                &full) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  k.bytes = epilogue_smem_bytes(L, k.a.rows, threads, sites);
  return band_dispatch(sites, full, k);
}

// K12 above the band plans' reach (256 < L <= 1024: the fields the K1 loop
// takes there): a CTA of L threads is a band of rows of one chain, a thread
// a column, C bands a chain in a cluster (the plan: row0). Nothing is kept
// across the chain's decision: the sums' pass reads each plaquette's
// neighbour link in the row through L1 (the next thread loads it) and
// carries the link of the row below down its column; each thread's six sums
// run along its rows (up to 128, two links each) Kahan-compensated, so the
// sum's error stays that of a few roundings, as the band kernel's 16-site
// runs; after the decision a second pass reads the chosen field again and
// writes x_new. Six fields of traffic against the band kernel's five.
struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = __fsub_rn(v, c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
};

constexpr int EPI_WIDE_MAX_L = 1024;   // a thread a column

__global__ void __launch_bounds__(EPI_WIDE_MAX_L)
    epilogue_wide_kernel(const float* __restrict__ x,
                         const float* __restrict__ x1,
                         const float* __restrict__ v1,
                         const float* __restrict__ v0,
                         const float* __restrict__ u,
                         const float* __restrict__ q_old,
                         float* __restrict__ xo, float* __restrict__ out,
                         int B, int L, float beta, Bands bands) {
  __shared__ float red[32 * EPI_SUMS], part[EPI_SUMS];
  const int C = bands.C, LL = L * L;
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                         : 0;
  const int b = blockIdx.x / C, j = threadIdx.x;
  const int jp = j + 1 == L ? 0 : j + 1;
  const int r0 = bands.row0[rank], r1 = bands.row0[rank + 1];
  const size_t off = static_cast<size_t>(b) * 2 * LL;
  const float *xa = x + off, *xb = x1 + off, *wa = v0 + off, *wb = v1 + off;
  Kahan k[EPI_SUMS];
  // the direction-1 links of the start (a) and of the wrapped end (b) in
  // the thread's column, row i + 1, carried down to row i
  float a1n = xa[LL + r0 * L + j], b1n = wrap_floor(xb[LL + r0 * L + j]);
  for (int i = r0; i < r1; ++i) {
    const int ip = i + 1 == L ? 0 : i + 1;
    const int s0 = i * L + j, sp = i * L + jp, s1 = LL + ip * L + j;
    const float a1 = a1n, b1 = b1n;
    a1n = xa[s1];
    b1n = wrap_floor(xb[s1]);
    // P = x0(i,j) + x1(i+1,j) - x0(i,j+1) - x1(i,j), as plaq_at
    const float pa =
        __fsub_rn(__fsub_rn(__fadd_rn(xa[s0], a1n), xa[sp]), a1);
    const float pb = __fsub_rn(
        __fsub_rn(__fadd_rn(wrap_floor(xb[s0]), b1n), wrap_floor(xb[sp])),
        b1);
    const float c0 = cosf(pa), c1 = cosf(pb);
    k[0].add(__fsub_rn(c1, c0));
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float w1 = wb[d * LL + s0], w0 = wa[d * LL + s0];
      k[1].add(__fmul_rn(__fsub_rn(w1, w0), __fadd_rn(w1, w0)));
    }
    k[2].add(c0);
    k[3].add(c1);
    k[4].add(wrap_floor(pa));
    k[5].add(wrap_floor(pb));
  }
  float s[EPI_SUMS];
#pragma unroll
  for (int n = 0; n < EPI_SUMS; ++n) s[n] = k[n].s;
  band_sum_n<EPI_SUMS>(s, C, red, part);
  const bool acc = epilogue_decide(s, beta, u, q_old, b, B, LL,
                                   rank == 0 && j == 0, out);
  for (int i = r0; i < r1; ++i) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const size_t e = off + d * LL + i * L + j;
      xo[e] = acc ? wrap_floor(x1[e]) : x[e];
    }
  }
  if (C > 1) cg::this_cluster().sync();   // peers read our sums
}

// K12 of (B, 2, L, L) fields, 2 <= L <= EPI_WIDE_MAX_L, L threads a CTA
// and C bands of row0 a chain (the wrapper takes it above the band plans'
// reach); the arguments as k12_hmc_epilogue's.
extern "C" int k12_hmc_epilogue_wide(const float* x, const float* x1,
                                     const float* v1, const float* v0,
                                     const float* u, const float* q_old,
                                     float* xo, float* out, int B, int L,
                                     float beta, int C, const int* row0,
                                     void* stream) {
  Bands bands;
  int R = 0;
  if (B < 1 || L < 2 || L > EPI_WIDE_MAX_L ||
      !bands_from(C, row0, L, &R, &bands))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(&epilogue_wide_kernel, B, C, L, 0,
                                          stream, x, x1, v1, v0, u, q_old,
                                          xo, out, B, L, beta, bands));
}
