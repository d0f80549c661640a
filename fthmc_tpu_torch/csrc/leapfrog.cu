// K2 and K3: the whole leapfrog trajectory of a batch of chains in one
// launch.
//
// K2 replaces fthmc_tpu/ops/pallas_lattice.py::_leapfrog_kernel
// (pallas_leapfrog), chains-first (B, 2, L, L): the band body of
// traj_common.cuh, a cluster of C row bands a chain, each thread keeping
// its S sites' links and momenta in registers for the whole trajectory.
// K3 replaces _leapfrog_cl_kernel (pallas_leapfrog_cl), chains-last
// (2, L, L, B) with the transposes at the tensor boundary (the wrapper):
// the shared-memory body of traj_common.cuh, one block holding CL_CHAINS
// consecutive chains, which neighbouring threads read as 16-byte runs.
// Both are bounded by operations (~35 a site a step, sinf the most of
// them); see traj_common.cuh for the designs. Bound and time: PERF.md.
#include "traj_common.cuh"

template <int S, bool FULL>
__global__ void __launch_bounds__(traj_max_threads(S))
    leapfrog_band_kernel(const float* __restrict__ x,
                         const float* __restrict__ v,
                         float* __restrict__ xo, float* __restrict__ vo,
                         TrajArgs a, Bands bands) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int L = a.L, LL = L * L;
  const BandSmem m = band_smem(L, a.rows, blockDim.x, TRAJ_LEAPFROG);
  const BandGeo g = band_geo<S>(bands, L, sm, m);
  const size_t off = static_cast<size_t>(g.b) * 2 * LL;
  float x0[S], x1[S], p0[S], p1[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x0[k] = x1[k] = p0[k] = p1[k] = 0.f;
    if (FULL || k < g.nv) {
      const size_t s = off + band_site(g, k);
      x0[k] = x[s];
      x1[k] = x[s + LL];
      p0[k] = v[s];
      p1[k] = v[s + LL];
    }
  }
  band_leapfrog<S, FULL>(x0, x1, p0, p1, g, sm, m, a);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < g.nv) {
      const size_t s = off + band_site(g, k);
      xo[s] = x0[k];
      xo[s + LL] = x1[k];
      vo[s] = p0[k];
      vo[s + LL] = p1[k];
    }
  }
  if (g.C > 1) cg::this_cluster().sync();   // peers read our sin P rows
}

struct K2Launch {
  int bytes, threads;
  TrajArgs a;
  Bands bands;
  void* stream;
  const float *x, *v;
  float *xo, *vo;

  template <int S, bool FULL>
  int run() const {
    static int set_bytes[64];
    return launch_band(&leapfrog_band_kernel<S, FULL>, set_bytes, bytes,
                       a.B, bands.C, threads, stream, x, v, xo, vo, a,
                       bands);
  }
};

template <int TB, bool CHAINS_LAST>
__global__ void leapfrog_kernel(const float* __restrict__ x,
                                const float* __restrict__ v,
                                float* __restrict__ xo,
                                float* __restrict__ vo, TrajArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int LL = a.L * a.L, n = LL * TB;
  float* vs = xs + 2 * n;
  float* sp = vs + 2 * n;
  const int b0 = blockIdx.x * TB;
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    const size_t g = field_index<TB, CHAINS_LAST>(e, b0, a.B, LL);
    xs[e] = x[g];
    vs[e] = v[g];
  }
  __syncthreads();
  leapfrog_smem<TB>(xs, vs, sp, a);
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    const size_t g = field_index<TB, CHAINS_LAST>(e, b0, a.B, LL);
    xo[g] = xs[e];
    vo[g] = vs[e];
  }
}

// x, v, xo, vo: (B, 2, L, L) fp32 contiguous. (C, row0[C + 1], threads,
// sites): the band plan (traj_common.cuh).
extern "C" int k2_leapfrog(const float* x, const float* v, float* xo,
                           float* vo, int B, int L, float beta, float dt,
                           float hdt, int nstep, int C, const int* row0,
                           int threads, int sites, void* stream) {
  K2Launch k{0, threads, traj_args(B, L, beta, dt, hdt, nstep), Bands(),
             stream, x, v, xo, vo};
  bool full = false;
  k.bytes = band_plan(TRAJ_LEAPFROG, C, row0, threads, sites, &k.a,
                      &k.bands, &full);
  if (k.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return band_dispatch(sites, full, k);
}

// x, v, xo, vo: (2, L, L, B) fp32 contiguous, B a multiple of CL_CHAINS.
extern "C" int k3_leapfrog_cl(const float* x, const float* v, float* xo,
                              float* vo, int B, int L, float beta, float dt,
                              float hdt, int nstep, void* stream) {
  if (B % CL_CHAINS != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_traj(leapfrog_kernel<CL_CHAINS, true>, B / CL_CHAINS,
                     CL_CHAINS, traj_args(B, L, beta, dt, hdt, nstep),
                     stream, x, v, xo, vo);
}

extern "C" int k3_chains_per_block() { return CL_CHAINS; }
