// K2 and K3: the whole leapfrog trajectory of a batch of chains in one
// launch, on the band body of traj_common.cuh (each thread keeping its S
// sites' links and momenta in registers for the whole trajectory).
//
// K2 replaces fthmc_tpu/ops/pallas_lattice.py::_leapfrog_kernel
// (pallas_leapfrog): a cluster of C row bands a chain.
// K3 replaces _leapfrog_cl_kernel (pallas_leapfrog_cl): the same body with
// a tile of TC chains a group, the chain the fastest index of the thread
// layout and of the shared cells (chains last inside, as the TPU kernel
// puts the chain block on the lane axis), so a small lattice's group is a
// CTA of a few warps at one band; the tile's last chains past B are
// masked. It reads and writes the chains-first (B, 2, L, L) tensors
// itself: chains-last planes, transposed around the launch, measured 2-3x
// slower through the wrapper on an H100 (PERF.md section 6).
// Both are bounded by operations (~35 a site a step, sinf the most of
// them); see traj_common.cuh for the design. Bound and time: PERF.md.
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
  const BandSmem m =
      band_smem(L, a.rows, blockDim.x, TRAJ_LEAPFROG, a.tile);
  const BandGeo g = band_geo<S>(bands, L, sm, m, a.tile);
  const bool live = g.b < a.B;   // a tile's last chains may lie past B
  const size_t off = static_cast<size_t>(g.b) * 2 * LL;
  float x0[S], x1[S], p0[S], p1[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x0[k] = x1[k] = p0[k] = p1[k] = 0.f;
    if (live && (FULL || k < g.nv)) {
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
    if (live && (FULL || k < g.nv)) {
      const size_t s = off + band_site(g, k);
      xo[s] = x0[k];
      xo[s + LL] = x1[k];
      vo[s] = p0[k];
      vo[s + LL] = p1[k];
    }
  }
  if (g.C > 1) cg::this_cluster().sync();   // peers read our sin P rows
}

struct LeapfrogLaunch {
  int bytes, threads;
  TrajArgs a;
  Bands bands;
  void* stream;
  const float *x, *v;
  float *xo, *vo;

  template <int S, bool FULL>
  int run() const {
    static int set_bytes[64];
    const int groups = (a.B + a.tile - 1) / a.tile;
    return launch_band(&leapfrog_band_kernel<S, FULL>, set_bytes, bytes,
                       groups, bands.C, threads, stream, x, v, xo, vo, a,
                       bands);
  }
};

// x, v, xo, vo: (B, 2, L, L) fp32 contiguous. (C, row0[C + 1], threads,
// sites): the band plan (traj_common.cuh); tiles of `tile` chains.
static int leapfrog_entry(const float* x, const float* v, float* xo,
                          float* vo, TrajArgs a, int C, const int* row0,
                          int threads, int sites, void* stream) {
  LeapfrogLaunch k{0, threads, a, Bands(), stream, x, v, xo, vo};
  bool full = false;
  k.bytes = band_plan(TRAJ_LEAPFROG, C, row0, threads, sites, &k.a,
                      &k.bands, &full);
  if (k.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  return band_dispatch(sites, full, k);
}

extern "C" int k2_leapfrog(const float* x, const float* v, float* xo,
                           float* vo, int B, int L, float beta, float dt,
                           float hdt, int nstep, int C, const int* row0,
                           int threads, int sites, void* stream) {
  return leapfrog_entry(x, v, xo, vo, traj_args(B, L, beta, dt, hdt, nstep),
                        C, row0, threads, sites, stream);
}

extern "C" int k3_leapfrog_cl(const float* x, const float* v, float* xo,
                              float* vo, int B, int L, float beta, float dt,
                              float hdt, int nstep, int C, const int* row0,
                              int threads, int sites, int tile,
                              void* stream) {
  TrajArgs a = traj_args(B, L, beta, dt, hdt, nstep);
  a.tile = tile;
  return leapfrog_entry(x, v, xo, vo, a, C, row0, threads, sites, stream);
}
