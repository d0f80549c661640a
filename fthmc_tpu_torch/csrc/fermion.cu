// K9, K10 and K11: the Wilson-Dirac normal operator on packed real planes
// and the CG iteration's vector update.
//
// K9 replaces fthmc_tpu/ops/pallas_fermion.py::_mdagm_kernel (_mdagm_call,
// pallas_mdagm layout 'cf'): chains-first planes p (B, 4, L0, L1)
// [Re s0, Im s0, Re s1, Im s1], links ur, ui (B, 2, L0, L1) with the
// antiperiodic time sign folded in. K10 replaces _mdagm_cl_kernel
// (_mdagm_call_cl): chains-last planes (4, L0, L1, B), links (2, L0, L1, B).
// K11 replaces the body of cg_solve_fused's while_loop: one block a chain,
// both reductions a fixed-order tree inside the block (deterministic, one
// launch an iteration), element e of chain c at e * stride_e + c *
// stride_c, so it serves both layouts.
//
// Operator (fthmc_tpu_torch/ops/fermion_kernels.py, normal_op_planes):
//   eo:  Dhat s = a s - b even * H(odd * H s),  a = m + 2, b = 1 / (4 a)
//   not: D s    = a s - H s / 2
//   out = g5 D g5 D s   (g5 negates planes 2 and 3)
// as hop passes with a barrier between them:
//   eo:  T = odd H(S);  S = g5(a S - b even H(T));  T = odd H(S);
//        out = g5(a S - b even H(T))
//   not: T = g5(a S - H(S) / 2);  out = g5(a T - H(T) / 2)
// H per site is hop_site below, the twins' hop_planes op for op with
// explicit _rn intrinsics (nvcc contracts nothing into an FMA the twins
// lack), so K9 and K10 repeat their twins' arithmetic exactly.
//
// K9 and K10 are one kernel, op_kernel, one launch an operator. A group of
// work is a chain (K9) or a tile of TC consecutive chains (K10: the
// chains-last layout's coalesced axis, the last tile masked where TC does
// not divide B), split into C bands of rows, one CTA a band: CTA r of a
// group owns rows [row0[r], row0[r + 1]) (common.cuh's Bands; the plan is
// ops/fermion_kernels.fermion_band_plan's). A CTA brings its band of the
// input planes with four halo rows a side, and its link rows, into shared
// memory at once: K9 by 1-D TMA bulk copies, one a run of rows of a plane,
// on one mbarrier; K10 by 16-byte cp.async, 4 chains of a site (where B and
// TC are multiples of 4; else 4 bytes a copy). Every pass then runs on
// chip, each over one row fewer a side than the one before, so a band
// needs nothing of the other bands: no barrier or copy between CTAs (a
// cluster with a halo exchange through distributed shared memory after
// each pass, and one with two halo rows and one exchange, both measured
// slower on the H100: PERF.md, PR 5). A pass maps its threads to the sites
// of one checkerboard parity, the parity taken from the global row, so
// every lane does the same work; the odd half of an even-odd combine
// (a S, g5) is a pass of its own. The result lands in the band's S planes
// and leaves by 16-byte stores. Offsets inside a band are 32-bit, and the
// loops step without divisions; only a row's global base takes 64-bit
// math. Where a band does not fit in shared memory (fermion_smem_bytes
// over the card's opt-in limit) the same layout lives in a device scratch
// the wrapper allocates.
//
// Bounds: K9 and K10 must read p and four link planes and write four
// planes, 48 bytes a site a chain (12.6 MB at 64^2, B=64: 3.8 us at
// 3.35 TB/s); their arithmetic is 112 flops a site (each eo hop pass 44
// on half the sites, each combine 12 on all), 0.44 us at 67 TFLOP/s. K11
// reads p, Mp, x, r and writes x, r, p, 112 bytes a site a chain (29.4 MB,
// 8.8 us). All three are bound by bytes; what the design does about it is
// to read every input once into the chip (K9, K10: up to the halo rows),
// keep the intermediates there, fill the card's SMs in one wave with bands
// (K9, K10), and make every global access coalesced (K9, K10, K11).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int OP_THREADS = 256;
constexpr int K11_THREADS = 1024;

enum PassKind { HOP = 0, COMBINE = 1, SCALE = 2 };

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// h = (H s) at one site: s the source planes (plane stride ps), U the links
// ur0, ui0, ur1, ui1 (plane stride us); f0, b0, f1, b1 the offsets in a
// plane of the site's neighbours n + e0, n - e0, n + e1, n - e1, self its
// own (the links share the planes' offsets). The four hop directions in
// hop_planes' order.
__device__ __forceinline__ void hop_site(const float* s, int ps,
                                         const float* U, int us, int self,
                                         int f0, int b0, int f1, int b1,
                                         float h[4]) {
  // forward 0: u0(n) psi(n + e0), (d, -d), d = t0 - t1
  float dr = sub(s[f0], s[2 * ps + f0]);
  float di = sub(s[ps + f0], s[3 * ps + f0]);
  float u_r = U[self], u_i = U[us + self];
  float mr = sub(mul(u_r, dr), mul(u_i, di));
  float mi = add(mul(u_r, di), mul(u_i, dr));
  float h0r = mr, h0i = mi, h1r = -mr, h1i = -mi;
  // backward 0: conj(u0(n - e0)) psi(n - e0), (e, e), e = s0 + s1
  dr = add(s[b0], s[2 * ps + b0]);
  di = add(s[ps + b0], s[3 * ps + b0]);
  u_r = U[b0];
  u_i = U[us + b0];
  mr = add(mul(u_r, dr), mul(u_i, di));
  mi = sub(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = add(h1r, mr);
  h1i = add(h1i, mi);
  // forward 1: u1(n) psi(n + e1), (w, -i w), w = t0 + i t1
  dr = sub(s[f1], s[3 * ps + f1]);
  di = add(s[ps + f1], s[2 * ps + f1]);
  u_r = U[2 * us + self];
  u_i = U[3 * us + self];
  mr = sub(mul(u_r, dr), mul(u_i, di));
  mi = add(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = add(h1r, mi);
  h1i = sub(h1i, mr);
  // backward 1: conj(u1(n - e1)) psi(n - e1), (v, i v), v = s0 - i s1
  dr = add(s[b1], s[3 * ps + b1]);
  di = sub(s[ps + b1], s[2 * ps + b1]);
  u_r = U[2 * us + b1];
  u_i = U[3 * us + b1];
  mr = add(mul(u_r, dr), mul(u_i, di));
  mi = sub(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = sub(h1r, mi);
  h1i = add(h1i, mr);
  h[0] = h0r;
  h[1] = h0i;
  h[2] = h1r;
  h[3] = h1i;
}

// Halo rows a side of a band: the eo operator's four hop passes each
// reach one row further, so with four a band needs nothing of the others.
constexpr int HALO = 4;

// A CTA's band: S and T, four planes each of R + 8 rows (four halo rows
// above the own rows 4..R + 3 and four below), then the links U (ur0, ui0,
// ur1, ui1) of R + 7 rows (down to the third below the own rows;
// direction 1 from band row 1 on). Band row b is global row r0 - 4 + b;
// element (plane k, band row b, column j, tile chain t) of a buffer at
// ((k * rows + b) * L1 + j) * TC + t, so a plane's band is one run of
// global rows for K9. R is the plan's largest band, so every CTA carves
// its band alike; the last 4 floats hold the load's mbarrier. Used by the
// launch (size), the device (carving) and, through fermion_smem_bytes,
// the Python wrappers.
struct OpLayout {
  int L1;
  int TC, tc_shift;  // chains a tile (a power of two), log2 TC
  int rs;            // row stride, L1 * TC
  int ps;            // S / T plane stride, (R + 8) * rs
  int us;            // link plane stride, (R + 7) * rs
  int total;         // floats of a band, 8 ps + 4 us + 4
};

__host__ __device__ inline OpLayout op_layout(int L1, int R, int TC) {
  OpLayout l;
  l.L1 = L1;
  l.TC = TC;
  l.tc_shift = 0;
  while ((1 << l.tc_shift) < TC) ++l.tc_shift;
  l.rs = L1 * TC;
  l.ps = (R + 2 * HALO) * l.rs;
  l.us = (R + 2 * HALO - 1) * l.rs;
  l.total = 8 * l.ps + 4 * l.us + 4;
  return l;
}

struct OpArgs {
  const float* ur;
  const float* ui;
  const float* p;
  float* out;
  float* scratch;  // null: the bands in shared memory
  int B, L0;
  float a, b;
  int eo;
  int vec;  // 1: 16-byte aligned rows (K9: TMA loads, 16-byte stores;
            // K10: 4 chains a 16-byte copy)
  Bands bands;
  OpLayout ly;
};

// What a CTA knows of its group and band.
struct Band {
  int c0, nc;     // first chain of the group, its valid chains
  int r0, R;      // first own row (global), own rows
  float* base;    // this CTA's band (shared memory or scratch)
};

// A thread's walk over the (plane q, row r, chunk c) of planes of nr rows
// of cpr chunks, from chunk `start` in steps of `step` chunks, with no
// division past the first.
struct Walk {
  int nr, cpr, step_r, step_c;
  int q, r, c;
  __device__ __forceinline__ Walk(int nr_, int cpr_,
                                  int start = threadIdx.x,
                                  int step = OP_THREADS)
      : nr(nr_), cpr(cpr_) {
    const int job = start / cpr;
    c = start - job * cpr;
    step_r = step / cpr;
    step_c = step - step_r * cpr;
    q = job / nr;
    r = job - q * nr;
  }
  __device__ __forceinline__ void next() {
    c += step_c;
    r += step_r;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
    while (r >= nr) {
      r -= nr;
      ++q;
    }
  }
};

__device__ __forceinline__ int wrap_row(int i, int L0) {
  return i < 0 ? i + L0 : (i >= L0 ? i - L0 : i);
}

// Global offset of (plane k, row i, column 0) of the group's first chain
// c0 in an array of `planes` planes: chains-first (K9) ((c0 planes + k) L0
// + i) L1, the columns then 1 apart; chains-last (K10) ((k L0 + i) L1) B +
// c0, the columns B apart.
template <bool CL>
__device__ __forceinline__ size_t row_base(int planes, int k, int i, int c0,
                                           int B, int L0, int L1) {
  if constexpr (CL) {
    return (static_cast<size_t>(k) * L0 + i) * L1 * B + c0;
  } else {
    return ((static_cast<size_t>(c0) * planes + k) * L0 + i) * L1;
  }
}

// Copy N = 1 or 4 floats src -> dst, zeros where !valid: by cp.async into
// shared memory (src-size 0 fills zeros), else loads and stores.
template <bool SM, int N>
__device__ __forceinline__ void copy_in(float* dst, const float* src,
                                        bool valid) {
  if constexpr (SM) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (N == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(valid ? 16 : 0)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(valid ? 4 : 0)
                   : "memory");
  } else if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) =
        valid ? __ldg(reinterpret_cast<const float4*>(src))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    *dst = valid ? __ldg(src) : 0.f;
  }
}

// Brings global rows g_lo.. (nr of them, wrapped) of np planes (k0.. of an
// array of `planes` planes) into the band buffer rows b_lo.. of dst (plane
// stride pstride), in chunks of N = 4 or 1 floats of a row: K9 consecutive
// columns, K10 consecutive tile chains of a site.
template <bool CL, bool SM, int N>
__device__ void load_rows(const OpArgs& A, const Band& bd, const float* src,
                          int planes, int k0, int np, int g_lo, int nr,
                          float* dst, int b_lo, int pstride) {
  const OpLayout& ly = A.ly;
  for (Walk it(nr, ly.rs / N); it.q < np; it.next()) {
    const int i = wrap_row(g_lo + it.r, A.L0);
    const float* g = src + row_base<CL>(planes, k0 + it.q, i, bd.c0, A.B,
                                        A.L0, ly.L1);
    const int e = it.c * N;
    const int j = e >> ly.tc_shift, t = e & (ly.TC - 1);
    const bool valid = !CL || t < bd.nc;
    const float* s = CL ? g + static_cast<size_t>(j) * A.B + t : g + e;
    copy_in<SM, N>(dst + it.q * pstride + (b_lo + it.r) * ly.rs + e,
                   valid ? s : src, valid);
  }
}

// One thread's 1-D TMA bulk copies of rows g_lo.. (nr of them, wrapped)
// of a chains-first plane (rows of L1 floats, 16-byte aligned) into band
// rows from dst, completing on the mbarrier at shared address bar: one
// copy a run of consecutive global rows.
__device__ void bulk_rows(float* dst, const float* plane, int g_lo, int nr,
                          int L0, int L1, unsigned bar) {
  for (int r = 0; r < nr;) {
    const int i = wrap_row(g_lo + r, L0);
    const int run = min(nr - r, L0 - i);
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * L1));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(d),
        "l"(plane + static_cast<size_t>(i) * L1),
        "r"(run * L1 * static_cast<int>(sizeof(float))), "r"(bar)
        : "memory");
    r += run;
  }
}

// Brings the band in: S rows r0 - 2 .. r0 + R + 1 of the four input
// planes, U rows r0 - 2 .. r0 + R of direction 0's links and r0 - 1 ..
// r0 + R of direction 1's; then every thread may read it. K9 with aligned
// rows in shared memory: TMA bulk copies issued by one thread, a run of
// rows each; else 16-byte (vec) or 4-byte copies spread over the threads.
template <bool CL, bool SM>
__device__ void load_band(const OpArgs& A, const Band& bd, float* S,
                          float* U) {
  const OpLayout& ly = A.ly;
  const int nS = bd.R + 2 * HALO, nU0 = bd.R + 2 * HALO - 1, nU1 = nU0 - 1;
  const int g = bd.r0 - HALO;
  if (!CL && SM && A.vec) {
    const int L0 = A.L0, L1 = ly.L1;
    const unsigned bar = static_cast<unsigned>(
        __cvta_generic_to_shared(bd.base + ly.total - 4));
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const int bytes = static_cast<int>(sizeof(float)) * L1 *
                        (4 * nS + 2 * nU0 + 2 * nU1);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      const size_t n = static_cast<size_t>(L0) * L1;
      const float* p = A.p + static_cast<size_t>(bd.c0) * 4 * n;
      const float* ur = A.ur + static_cast<size_t>(bd.c0) * 2 * n;
      const float* ui = A.ui + static_cast<size_t>(bd.c0) * 2 * n;
      for (int k = 0; k < 4; ++k)
        bulk_rows(S + k * ly.ps, p + k * n, g, nS, L0, L1, bar);
      bulk_rows(U, ur, g, nU0, L0, L1, bar);
      bulk_rows(U + ly.us, ui, g, nU0, L0, L1, bar);
      bulk_rows(U + 2 * ly.us + ly.rs, ur + n, g + 1, nU1, L0, L1, bar);
      bulk_rows(U + 3 * ly.us + ly.rs, ui + n, g + 1, nU1, L0, L1, bar);
    }
    __syncthreads();  // the mbarrier is initialised
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar)
          : "memory");
    return;
  }
  if (A.vec) {
    load_rows<CL, SM, 4>(A, bd, A.p, 4, 0, 4, g, nS, S, 0, ly.ps);
    load_rows<CL, SM, 4>(A, bd, A.ur, 2, 0, 1, g, nU0, U, 0, ly.us);
    load_rows<CL, SM, 4>(A, bd, A.ui, 2, 0, 1, g, nU0, U + ly.us, 0, ly.us);
    load_rows<CL, SM, 4>(A, bd, A.ur, 2, 1, 1, g + 1, nU1, U + 2 * ly.us, 1,
                         ly.us);
    load_rows<CL, SM, 4>(A, bd, A.ui, 2, 1, 1, g + 1, nU1, U + 3 * ly.us, 1,
                         ly.us);
  } else {
    load_rows<CL, SM, 1>(A, bd, A.p, 4, 0, 4, g, nS, S, 0, ly.ps);
    load_rows<CL, SM, 1>(A, bd, A.ur, 2, 0, 1, g, nU0, U, 0, ly.us);
    load_rows<CL, SM, 1>(A, bd, A.ui, 2, 0, 1, g, nU0, U + ly.us, 0, ly.us);
    load_rows<CL, SM, 1>(A, bd, A.ur, 2, 1, 1, g + 1, nU1, U + 2 * ly.us, 1,
                         ly.us);
    load_rows<CL, SM, 1>(A, bd, A.ui, 2, 1, 1, g + 1, nU1, U + 3 * ly.us, 1,
                         ly.us);
  }
  if constexpr (SM) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
}

// One pass over the sites of checkerboard parity par (0 even, 1 odd, by
// global row) of nb band rows from b_lo, the tile's chains fastest. HOP:
// dst = H(src); COMBINE: dst = g5(a self - c H(src)); SCALE: dst = g5(a
// self). dst may be self (each site is its own thread's).
template <int KIND>
__device__ void op_pass(const OpLayout& ly, const Band& bd, int par,
                        int b_lo, int nb, const float* src, const float* self,
                        float* dst, const float* U, float a, float c) {
  const int t = static_cast<int>(threadIdx.x) & (ly.TC - 1);
  const int w = ly.L1 / 2;
  for (Walk it(nb, w, threadIdx.x >> ly.tc_shift, OP_THREADS >> ly.tc_shift);
       it.q < 1; it.next()) {
    const int b = b_lo + it.r;
    const int row = b * ly.rs;
    const int j = 2 * it.c + ((bd.r0 - HALO + b + par) & 1);
    const int at = row + j * ly.TC + t;
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    if (KIND != SCALE) {
      const int jp = (j + 1 == ly.L1) ? 0 : j + 1;
      const int jm = (j == 0 ? ly.L1 : j) - 1;
      hop_site(src, ly.ps, U, ly.us, at, at + ly.rs, at - ly.rs,
               row + jp * ly.TC + t, row + jm * ly.TC + t, h);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (KIND == HOP) {
        dst[at + k * ly.ps] = h[k];
      } else {
        const float as = mul(a, self[at + k * ly.ps]);
        const float v = KIND == COMBINE ? sub(as, mul(c, h[k])) : as;
        dst[at + k * ly.ps] = k < 2 ? v : -v;  // g5
      }
    }
  }
}

// Store the own rows of the band's S planes to out (valid chains only), in
// chunks of N = 4 or 1 floats of a row.
template <bool CL, int N>
__device__ void store_rows(const OpArgs& A, const Band& bd, const float* S) {
  const OpLayout& ly = A.ly;
  for (Walk it(bd.R, ly.rs / N); it.q < 4; it.next()) {
    const int e = it.c * N;
    const int j = e >> ly.tc_shift, t = e & (ly.TC - 1);
    if (CL && t >= bd.nc) continue;
    float* g = A.out + row_base<CL>(4, it.q, bd.r0 + it.r, bd.c0, A.B,
                                    A.L0, ly.L1) +
               (CL ? static_cast<size_t>(j) * A.B + t : e);
    const float* s = S + it.q * ly.ps + (HALO + it.r) * ly.rs + e;
    if constexpr (N == 4)
      *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(s);
    else
      *g = *s;
  }
}

// K9 (CL false) and K10 (CL true); SM: the bands in shared memory. Each
// hop pass covers the rows its consumer reads: eo, T on the own rows and
// three more a side, S combined on two more, T again on one more, then the
// own rows combined; plain, one more row a side, then the own rows.
template <bool CL, bool SM>
__global__ void __launch_bounds__(OP_THREADS)
    op_kernel(const __grid_constant__ OpArgs A) {
  extern __shared__ float4 smem4[];
  const OpLayout& ly = A.ly;
  const int C = A.bands.C, rank = static_cast<int>(blockIdx.x) % C;
  Band bd;
  bd.c0 = (static_cast<int>(blockIdx.x) / C) * ly.TC;
  bd.nc = CL ? min(ly.TC, A.B - bd.c0) : 1;
  bd.r0 = A.bands.row0[rank];
  bd.R = A.bands.row0[rank + 1] - bd.r0;
  bd.base = SM ? reinterpret_cast<float*>(smem4)
               : A.scratch + static_cast<size_t>(blockIdx.x) * ly.total;
  float* S = bd.base;
  float* T = S + 4 * ly.ps;
  float* U = S + 8 * ly.ps;
  const int R = bd.R;
  load_band<CL, SM>(A, bd, S, U);
  if (A.eo) {
    op_pass<HOP>(ly, bd, 1, 1, R + 6, S, nullptr, T, U, A.a, 0.f);
    __syncthreads();
    op_pass<COMBINE>(ly, bd, 0, 2, R + 4, T, S, S, U, A.a, A.b);
    op_pass<SCALE>(ly, bd, 1, 2, R + 4, nullptr, S, S, U, A.a, 0.f);
    __syncthreads();
    op_pass<HOP>(ly, bd, 1, 3, R + 2, S, nullptr, T, U, A.a, 0.f);
    __syncthreads();
    op_pass<COMBINE>(ly, bd, 0, HALO, R, T, S, S, U, A.a, A.b);
    op_pass<SCALE>(ly, bd, 1, HALO, R, nullptr, S, S, U, A.a, 0.f);
  } else {
    for (int par = 0; par < 2; ++par)
      op_pass<COMBINE>(ly, bd, par, HALO - 1, R + 2, S, S, T, U, A.a, 0.5f);
    __syncthreads();
    for (int par = 0; par < 2; ++par)
      op_pass<COMBINE>(ly, bd, par, HALO, R, T, T, S, U, A.a, 0.5f);
  }
  __syncthreads();
  if (A.vec)
    store_rows<CL, 4>(A, bd, S);
  else
    store_rows<CL, 1>(A, bd, S);
}

// Sum over the block, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(K11_THREADS)
    k11_kernel(float* p, const float* __restrict__ mp, float* x, float* r,
               float* rsq, const float* __restrict__ stop, int* counters,
               int n_elem, long long stride_e, long long stride_c, int it) {
  __shared__ float red[33];
  const int c = blockIdx.x;
  const long long base = c * stride_c;
  const float rs = rsq[c], st = stop[c];
  const bool active = rs > st;
  float acc = 0.f;
  for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
    const long long g = base + e * stride_e;
    acc = add(acc, mul(p[g], mp[g]));
  }
  const float denom = block_sum(acc, red);
  const float alpha = active ? rs / fmaxf(denom, 1e-30f) : 0.f;
  acc = 0.f;
  for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
    const long long g = base + e * stride_e;
    const float pv = p[g];
    x[g] = add(x[g], mul(alpha, pv));
    const float rv = sub(r[g], mul(alpha, mp[g]));
    r[g] = rv;
    acc = add(acc, mul(rv, rv));
  }
  const float rsq_new = block_sum(acc, red);
  const float beta = active ? rsq_new / fmaxf(rs, 1e-30f) : 0.f;
  for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
    const long long g = base + e * stride_e;
    p[g] = add(r[g], mul(beta, p[g]));
  }
  if (threadIdx.x == 0) {
    rsq[c] = active ? rsq_new : rs;
    if (active) atomicMax(counters, it + 1);
    if (active && rsq_new > st) atomicMax(counters + 1, it + 1);
  }
}

bool sides_ok(int L0, int L1) {
  return L0 >= 4 && L1 >= 4 && L0 % 2 == 0 && L1 % 2 == 0;
}

bool tile_ok(int tile) {
  return tile >= 1 && tile <= OP_THREADS && (tile & (tile - 1)) == 0;
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
}

int g_op_smem[2][64];  // opt-in set so far, by kernel (K9, K10) and device

// The launch of K9 (CL false, tile 1) or K10; see the entries below.
template <bool CL>
int launch_op(const float* ur, const float* ui, const float* p, float* out,
              float* scratch, int B, int L0, int L1, float a, float b, int eo,
              int C, const int* row0, int tile, void* stream) {
  OpArgs A;
  int R = 0;
  if (B < 1 || !sides_ok(L0, L1) || !tile_ok(tile) ||
      !bands_from(C, row0, L0, &R, &A.bands))
    return static_cast<int>(cudaErrorInvalidValue);
  A.ur = ur;
  A.ui = ui;
  A.p = p;
  A.out = out;
  A.scratch = scratch;
  A.B = B;
  A.L0 = L0;
  A.a = a;
  A.b = b;
  A.eo = eo;
  A.ly = op_layout(L1, R, tile);
  A.vec = aligned16(ur) && aligned16(ui) && aligned16(p) && aligned16(out) &&
          (CL ? B % 4 == 0 && tile % 4 == 0 : L1 % 4 == 0);
  const int groups = CL ? (B + tile - 1) / tile : B;
  int bytes = 0;
  auto kernel = &op_kernel<CL, false>;
  if (scratch == nullptr) {
    kernel = &op_kernel<CL, true>;
    bytes = static_cast<int>(sizeof(float)) * A.ly.total;
    const cudaError_t err = ensure_smem(kernel, bytes, g_op_smem[CL]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<groups * C, OP_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of one K9 / K10 CTA's band (OpLayout) under a plan of C bands of
// at most `rows` rows and chain tiles of `tile` chains (1 for K9), or -1
// for what the kernels do not take. The wrappers keep the bands in shared
// memory where this is within the card's opt-in limit, else in a device
// scratch of this many bytes a CTA.
extern "C" int fermion_smem_bytes(int L0, int L1, int C, int rows,
                                  int tile) {
  if (!sides_ok(L0, L1) || C < 1 || C > MAX_BANDS || rows < 1 ||
      rows > L0 || rows * C < L0 || !tile_ok(tile))
    return -1;
  return static_cast<int>(sizeof(float)) * op_layout(L1, rows, tile).total;
}

// ur, ui: (B, 2, L0, L1); p, out: (B, 4, L0, L1); fp32 contiguous. scratch:
// nullptr (the bands in shared memory, which must fit) or B * C *
// fermion_smem_bytes(L0, L1, C, rows, 1) bytes. a = m + 2, b = 1 / (4 a).
// (C, row0[C + 1]): the band plan, C CTAs a chain.
extern "C" int k9_mdagm(const float* ur, const float* ui, const float* p,
                        float* out, float* scratch, int B, int L0, int L1,
                        float a, float b, int eo, int C, const int* row0,
                        void* stream) {
  return launch_op<false>(ur, ui, p, out, scratch, B, L0, L1, a, b, eo, C,
                          row0, 1, stream);
}

// ur, ui: (2, L0, L1, B); p, out: (4, L0, L1, B); fp32 contiguous. C
// CTAs a tile of `tile` chains (a power of two up to 256);
// scratch: nullptr or ceil(B / tile) * C * fermion_smem_bytes(L0, L1, C,
// rows, tile) bytes. One launch an operator.
extern "C" int k10_mdagm_cl(const float* ur, const float* ui, const float* p,
                            float* out, float* scratch, int B, int L0,
                            int L1, float a, float b, int eo, int C,
                            const int* row0, int tile, void* stream) {
  return launch_op<true>(ur, ui, p, out, scratch, B, L0, L1, a, b, eo, C,
                         row0, tile, stream);
}

// One CG iteration's update of B chains in place, after mp = M p. Element e
// of chain c at e * stride_e + c * stride_c (chains-first: 1, n_elem;
// chains-last: B, 1). rsq, stop: (B,); counters: int32 (2,), see
// cg_update_plain.
extern "C" int k11_cg_update(float* p, const float* mp, float* x, float* r,
                             float* rsq, const float* stop, int* counters,
                             int B, int n_elem, int stride_e, int stride_c,
                             int it, void* stream) {
  if (B < 1 || n_elem < 1) return static_cast<int>(cudaErrorInvalidValue);
  k11_kernel<<<B, K11_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, mp, x, r, rsq, stop, counters, n_elem, stride_e, stride_c, it);
  return static_cast<int>(cudaGetLastError());
}
