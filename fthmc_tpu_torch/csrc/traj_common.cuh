// The device body of the trajectory kernels, the band body: K2 and K3
// (leapfrog.cu), K4 and K5 (hmc_traj.cu); K12 (hmc_traj.cu) takes its band
// geometry, plaquette and sums.
//
// Replaces the bodies of the TPU kernels _leapfrog_kernel,
// _leapfrog_cl_kernel and _hmc_traj_body (fthmc_tpu/ops/pallas_lattice.py).
// Bounded by operations (an accurate sinf a site a step, about 35 fp32
// operations a site a step in all), not bytes: device memory sees one read
// of the fields and one write of the result a trajectory.
//
// Arithmetic follows the plain twins op for op (explicit _rn intrinsics, so
// nvcc contracts nothing into an FMA the twins do not have), and sinf/cosf
// are the accurate ones: fp32 differences would grow along 25 steps.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

struct TrajArgs {
  int B, L, nstep;
  int rows;              // rows of the largest band
  int tile;              // chains a CTA (K3; 1 for K2, K4, K5)
  float beta, dt, hdt;   // hdt = dt / 2
};

inline TrajArgs traj_args(int B, int L, float beta, float dt, float hdt,
                          int nstep) {
  TrajArgs a;
  a.B = B;
  a.L = L;
  a.nstep = nstep;
  a.rows = L;
  a.tile = 1;
  a.beta = beta;
  a.dt = dt;
  a.hdt = hdt;
  return a;
}

// ---------------------------------------------------------------------------
// The band body: fields in registers, a cluster of row bands
// ---------------------------------------------------------------------------
//
// A group of work, one chain (K2, K4, K5) or a tile of TC chains (K3), is
// one thread-block cluster of C CTAs (C <= MAX_BANDS), CTA rank r owning
// rows [row0[r], row0[r + 1]) (Bands, common.cuh; the plan is chosen in
// Python, ops/lattice_kernels.traj_plan). Thread t of a CTA owns chain
// c = t % TC of the tile, column j = (t / TC) % L and a run of S
// consecutive rows of its band, from local row (t / (TC L)) S:
// T = G TC L threads, G runs a column, G S >= the band's rows (rows past
// the band's end are idle). A tile's chain is the fastest index, so
// neighbouring threads hold the same site of neighbouring chains: a
// shared-memory cell is [row][column][chain], free of bank conflicts,
// and a tile's last chains past B are masked (their threads compute on
// zeros and store nothing). The thread keeps the links x0, x1 and momenta
// p0, p1 of its S sites in registers for the whole trajectory, so a step
// moves through shared memory only what crosses threads:
//   1. publish x0 of the run and x1 of its first row; barrier;
//   2. P = x0 + x1(i+1) - x0(j+1) - x1, x1(i+1) from a register inside the
//      run, from the next run's first row, or, for the band's last row,
//      from the first row of the band below; sin P kept and published;
//      barrier;
//   3. kick with F0 = beta (sin P - sin P(j-1)), F1 = beta (sin P(i-1) -
//      sin P), sin P(i-1) from a register, from the run above's last row or,
//      for the band's first row, from the band above's last; drift.
// That is 4 shared accesses a site a step (plus 3 a run). A barrier is
// __syncthreads for C = 1 and a cluster barrier otherwise, split into
// arrive and wait around the sites that need only this CTA's rows: the
// rows from the bands above and below (wrapping rank C - 1 <-> 0) are read
// through distributed shared memory after the wait. Neighbour offsets are
// computed once before the step loop, so the loop has no division; S is a
// template argument, so the fields stay in registers, and FULL (every band
// G S rows) drops the per-site predicates (a copy with them was markedly
// slower). At the headline's plan (one CTA of 1024 threads of 4 sites a
// chain) a step issues ~75 instructions a site (the accurate sinf ~25, the
// _rn flops 15, 4 shared accesses and their addresses), which bounds the
// kernel: it runs at about the SMs' issue rate, not at the fp32 rate the
// bound counts. A tile (K3) puts TC chains in a CTA, so a small lattice's
// CTA is a warp or more where one chain (K2 at 8^2) is 8 threads.
// K4/K5 add cos P0 of each site (kept in shared memory) and the end's
// delta-form dH, reduced in a fixed order: over the thread's sites, a tree
// over the CTA, then the CTAs' sums in rank order, read by every CTA of the
// cluster (so each gets the same bits and no second pass is needed). K4
// keeps its drawn momenta in shared memory for the kinetic term instead of
// drawing them again.

// Threads a CTA at most, by sites a thread: the launch bounds, which cap a
// thread's registers at 65536 / this (64 up to 4 sites, 128 above).
__host__ __device__ constexpr int traj_max_threads(int S) {
  return S >= 8 ? 512 : 1024;
}

enum TrajKind { TRAJ_LEAPFROG = 0, TRAJ_HMC = 1, TRAJ_HMC_HOSTRNG = 2 };

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Shared-memory layout of a CTA, in floats: x0 and sin P of the band's
// rows (R L TC each), x1 of each run's first row (indexed by thread), and
// for K4/K5 cos P0 (R L), the tree of the dH sums (2 pow2_at_least(T)) and
// the CTA's two sums; K4 also the drawn momenta (2 R L).
struct BandSmem {
  int xs0, sps, x1f, c0s, red, part, v0s, floats;
};

__host__ __device__ inline BandSmem band_smem(int L, int R, int T, int kind,
                                              int tile = 1) {
  BandSmem m;
  const int RL = R * L * tile;
  int o = 0;
  m.xs0 = o;
  o += RL;
  m.sps = o;
  o += RL;
  m.x1f = o;
  o += T;
  m.c0s = m.red = m.part = m.v0s = o;
  if (kind != TRAJ_LEAPFROG) {
    m.c0s = o;
    o += RL;
    m.red = o;
    o += 2 * pow2_at_least(T);
    m.part = o;
    o += 2;
    m.v0s = o;
    if (kind == TRAJ_HMC) o += 2 * RL;
  }
  m.floats = o;
  return m;
}

__host__ __device__ inline bool traj_sites_ok(int S) {
  return S == 1 || S == 2 || S == 4 || S == 8 || S == 16;
}

// Bytes of dynamic shared memory a CTA of the band body takes (kind: 0 K2
// and K3, 1 K4, 2 K5) for an L^2 lattice, bands of at most `rows` rows,
// `threads` threads of `sites` sites each, tiles of `tile` chains (K3; 1
// otherwise); -1 for what the kernels do not take. The Python wrappers hold
// it against the card's limit before they launch.
extern "C" int traj_band_smem_bytes(int L, int rows, int threads, int sites,
                                    int kind, int tile) {
  if (L < 2 || rows < 1 || rows > L || !traj_sites_ok(sites) ||
      tile < 1 || (tile > 1 && kind != TRAJ_LEAPFROG) ||
      threads < L * tile || threads % (L * tile) != 0 ||
      threads > traj_max_threads(sites) ||
      (threads / (L * tile)) * sites < rows || kind < 0 || kind > 2)
    return -1;
  return static_cast<int>(sizeof(float)) *
         band_smem(L, rows, threads, kind, tile).floats;
}

// What a thread knows of its sites and neighbours, computed once. A shared
// cell of the band's fields is row * `row` + column TC + chain: `cj`,
// `cjp` and `cjm` are the cells of the thread's column and of its
// neighbours in a row, `row` = L TC (with TC = 1, the column and L).
struct BandGeo {
  int L, C, rank, b;   // lattice side, bands, this CTA's band, chain
  int r0, R;           // the band's first row and rows
  int j, jp, jm;       // the column and its neighbours (j + 1, j - 1)
  int g0;              // the run's first local row
  int nv;              // sites of the run inside the band
  int klast;           // k of the band's last row in the run, or -1
  int row, cj, cjp, cjm;  // shared cells: a row's, the columns' in it
  const float* x1_below;  // x1 of the band below's first row, column j
  const float* sp_above;  // sin P of the band above's last row, column j
};

template <int S>
__device__ inline BandGeo band_geo(const Bands& bands, int L, float* sm,
                                   const BandSmem& m, int tile = 1) {
  BandGeo g;
  g.L = L;
  g.C = bands.C;
  g.rank = g.C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  g.r0 = bands.row0[g.rank];
  g.R = bands.row0[g.rank + 1] - g.r0;
  const int t = threadIdx.x, c = t % tile, q = t / tile;
  g.b = (blockIdx.x / g.C) * tile + c;
  g.j = q % L;
  g.g0 = (q / L) * S;
  g.jp = g.j + 1 == L ? 0 : g.j + 1;
  g.jm = (g.j == 0 ? L : g.j) - 1;
  g.nv = min(max(g.R - g.g0, 0), S);
  g.klast = (g.R - 1 >= g.g0 && g.R - 1 < g.g0 + S) ? g.R - 1 - g.g0 : -1;
  g.row = L * tile;
  g.cj = g.j * tile + c;
  g.cjp = g.jp * tile + c;
  g.cjm = g.jm * tile + c;
  const int up = (g.rank + g.C - 1) % g.C, dn = (g.rank + 1) % g.C;
  const int R_up = bands.row0[up + 1] - bands.row0[up];
  float* x1f = sm + m.x1f;
  float* sps = sm + m.sps;
  if (g.C > 1) {
    x1f = cg::this_cluster().map_shared_rank(x1f, dn);
    sps = cg::this_cluster().map_shared_rank(sps, up);
  }
  g.x1_below = x1f + g.cj;
  g.sp_above = sps + (R_up - 1) * g.row + g.cj;
  return g;
}

// A barrier over the chain's CTAs (their shared-memory writes before it
// are seen after it).
__device__ __forceinline__ void band_sync(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The cluster barrier split in two: arrive (release) once this CTA's rows
// are published, wait (acquire) before reading a neighbour band's, so the
// sites that need only this CTA's rows are computed in between (a little
// faster than a whole cluster barrier at 128^2 and 256^2 on an H100). For
// C = 1 a __syncthreads and nothing to wait for.
__device__ __forceinline__ bool band_arrive(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
    return true;
  }
  band_sync(C);
  return false;
}

__device__ __forceinline__ void band_wait(bool arrived) {
  if (arrived)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Publishes x0 of the run and x1 of its first row, waits for the chain's,
// and gives P of each site of the run (sites past the band are left).
// FULL: every band has G S rows, so every thread's run is whole and the
// sites need no predicate.
template <int S, bool FULL>
__device__ __forceinline__ void band_plaq(float (&P)[S], const float (&x0)[S],
                                          const float (&x1)[S],
                                          const BandGeo& g, float* xs0,
                                          float* x1f) {
  const int L = g.row, base = g.g0 * L;
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (FULL || k < g.nv) xs0[base + k * L + g.cj] = x0[k];
  if (FULL || g.nv > 0) x1f[threadIdx.x] = x1[0];
  const bool arrived = band_arrive(g.C);
  // x1(i+1) of the run's last site when the band continues below: the
  // next run's first row (the thread a row of cells further on)
  const float next =
      g.klast < 0 && (FULL || g.nv == S) ? x1f[threadIdx.x + L] : 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if ((FULL || k < g.nv) && k != g.klast) {
      const float xn = k + 1 == S ? next : x1[k + 1 < S ? k + 1 : k];
      P[k] = x0[k] + xn - xs0[base + k * L + g.cjp] - x1[k];
    }
  }
  band_wait(arrived);
  // the band's last row: x1(i+1) from the band below's first row
  if (g.klast >= 0) {
    const float below = *g.x1_below;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k == g.klast)
        P[k] = x0[k] + below - xs0[base + k * L + g.cjp] - x1[k];
  }
}

// The whole leapfrog trajectory on the thread's registers: half drift,
// nstep x (kick with the sin-stencil force, drift), then the trailing half
// drift undone (hmc.leapfrog).
template <int S, bool FULL>
__device__ void band_leapfrog(float (&x0)[S], float (&x1)[S], float (&p0)[S],
                              float (&p1)[S], const BandGeo& g, float* sm,
                              const BandSmem& m, const TrajArgs& a) {
  float* xs0 = sm + m.xs0;
  float* sps = sm + m.sps;
  float* x1f = sm + m.x1f;
  const int L = g.row, base = g.g0 * L;
  const bool has_run = FULL || g.nv > 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x0[k] = __fadd_rn(x0[k], __fmul_rn(a.hdt, p0[k]));
    x1[k] = __fadd_rn(x1[k], __fmul_rn(a.hdt, p1[k]));
  }
  for (int step = 0; step < a.nstep; ++step) {
    float sp[S];
    band_plaq<S, FULL>(sp, x0, x1, g, xs0, x1f);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (FULL || k < g.nv) {
        sp[k] = sinf(sp[k]);
        sps[base + k * L + g.cj] = sp[k];
      }
    }
    const bool arrived = band_arrive(g.C);
    // kick (F0 = beta (sin P - sin P(j-1)), F1 = beta (sin P(i-1) -
    // sin P)) and drift of site k, sa = sin P(i-1)
    auto kick = [&](int k, float sa) {
      const float f0 =
          __fmul_rn(a.beta, __fsub_rn(sp[k], sps[base + k * L + g.cjm]));
      const float f1 = __fmul_rn(a.beta, __fsub_rn(sa, sp[k]));
      p0[k] = __fsub_rn(p0[k], __fmul_rn(a.dt, f0));
      p1[k] = __fsub_rn(p1[k], __fmul_rn(a.dt, f1));
      x0[k] = __fadd_rn(x0[k], __fmul_rn(a.dt, p0[k]));
      x1[k] = __fadd_rn(x1[k], __fmul_rn(a.dt, p1[k]));
    };
    // sin P(i-1) of the run's first site: the run above's last row, or,
    // for the band's first row, the band above's last (kicked last)
    const bool first_row = g.g0 == 0;
    if (has_run && !first_row) kick(0, sps[base - L + g.cj]);
#pragma unroll
    for (int k = 1; k < S; ++k)
      if (FULL || k < g.nv) kick(k, sp[k - 1]);
    band_wait(arrived);
    if (has_run && first_row) kick(0, *g.sp_above);
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x0[k] = __fsub_rn(x0[k], __fmul_rn(a.hdt, p0[k]));
    x1[k] = __fsub_rn(x1[k], __fmul_rn(a.hdt, p1[k]));
  }
}

// Offset of site k of the thread's run in its chain's direction-0 plane,
// (row L + column).
__device__ __forceinline__ int band_site(const BandGeo& g, int k) {
  return (g.r0 + g.g0 + k) * g.L + g.j;
}

// Sum of the chain's dsw and dk in a fixed order: the CTA's tree over its
// threads' sums, then the CTAs' sums in rank order; every thread of every
// CTA of the chain gets the same two values.
__device__ inline void band_sum2(float& dsw, float& dk, const BandGeo& g,
                                 float* sm, const BandSmem& m) {
  float* red = sm + m.red;
  float* part = sm + m.part;
  const int t = threadIdx.x, T = blockDim.x, P2 = pow2_at_least(T);
  red[t] = dsw;
  red[P2 + t] = dk;
  if (T + t < P2) {
    red[T + t] = 0.f;
    red[P2 + T + t] = 0.f;
  }
  __syncthreads();
  for (int h = P2 / 2; h > 0; h >>= 1) {
    if (t < h) {
      red[t] += red[t + h];
      red[P2 + t] += red[P2 + t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    part[0] = red[0];
    part[1] = red[P2];
  }
  band_sync(g.C);
  dsw = 0.f;
  dk = 0.f;
  for (int r = 0; r < g.C; ++r) {
    const float* pr =
        g.C > 1 ? cg::this_cluster().map_shared_rank(part, r) : part;
    dsw += pr[0];
    dk += pr[1];
  }
}

// Sums of the chain's N values (each thread's in s) in a fixed order: a
// shuffle tree in each warp, the warps' sums in order by the first warp,
// then the CTAs' sums in rank order; every thread of every CTA of the chain
// (C of them, a cluster) gets the same N values (K12). `red` holds 32 N
// floats, `part` N. A warp cut short by the CTA's size (threads not a
// multiple of 32) adds only the lanes it has. A caller with C > 1 holds a
// cluster barrier before it exits: its peers read its `part`.
template <int N>
__device__ inline void band_sum_n(float (&s)[N], int C, float* red,
                                  float* part) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int T = blockDim.x, warps = (T + 31) >> 5;
  auto warp_sum = [lane](float (&v)[N], int width) {
    const unsigned mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float o_v = __shfl_down_sync(mask, v[i], o);
        if (lane + o < width) v[i] += o_v;
      }
    }
  };
  warp_sum(s, min(32, T - (w << 5)));
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 32 + w] = s[i];
  }
  __syncthreads();
  if (w == 0) {
    float r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = lane < warps ? red[i * 32 + lane] : 0.f;
    warp_sum(r, min(32, T));
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) part[i] = r[i];
    }
  }
  band_sync(C);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 0.f;
  for (int r = 0; r < C; ++r) {
    const float* pr =
        C > 1 ? cg::this_cluster().map_shared_rank(part, r) : part;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] += pr[i];
  }
}

// Checks a plan (C bands of row0, `threads` threads of `sites` sites, tiles
// of a.tile chains) of the band body for a kernel of `kind`, and fills
// a.rows, bands and full (every band G S rows); returns the CTA's
// shared-memory bytes, or -1 for what the kernels do not take.
inline int band_plan(int kind, int C, const int* row0, int threads,
                     int sites, TrajArgs* a, Bands* bands, bool* full) {
  int R = 0;
  if (a->B < 1 || a->L < 2 || a->nstep < 0 ||
      !bands_from(C, row0, a->L, &R, bands))
    return -1;
  a->rows = R;
  *full = a->L % C == 0 && R == threads / (a->L * a->tile) * sites;
  return traj_band_smem_bytes(a->L, R, threads, sites, kind, a->tile);
}

// launch.template run<S, FULL>() for the plan's sites a thread and
// fullness: the kernels' instances.
template <class Launch>
int band_dispatch(int sites, bool full, const Launch& launch) {
  switch (sites) {
    case 1:
      return full ? launch.template run<1, true>()
                  : launch.template run<1, false>();
    case 2:
      return full ? launch.template run<2, true>()
                  : launch.template run<2, false>();
    case 4:
      return full ? launch.template run<4, true>()
                  : launch.template run<4, false>();
    case 8:
      return full ? launch.template run<8, true>()
                  : launch.template run<8, false>();
    default:
      return full ? launch.template run<16, true>()
                  : launch.template run<16, false>();
  }
}

// A launch of the band body: `groups` chains (or tiles) of C CTAs, in
// clusters of C, the shared memory opted in to once a device (set_bytes:
// the kernel's record).
template <class... Params, class... Args>
int launch_band(void (*kernel)(Params...), int* set_bytes, int bytes,
                int groups, int C, int threads, void* stream,
                Args&&... args) {
  const cudaError_t err = ensure_smem(kernel, bytes, set_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_clusters(kernel, groups, C, threads, bytes,
                                          stream,
                                          std::forward<Args>(args)...));
}
