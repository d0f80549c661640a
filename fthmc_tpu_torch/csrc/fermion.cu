// K9, K10 and K11: the Wilson-Dirac normal operator on packed real planes
// and the whole CG solve built on it.
//
// K9 replaces fthmc_tpu/ops/pallas_fermion.py::_mdagm_kernel (_mdagm_call,
// pallas_mdagm layout 'cf'): chains-first planes p (B, 4, L0, L1)
// [Re s0, Im s0, Re s1, Im s1], links ur, ui (B, 2, L0, L1) with the
// antiperiodic time sign folded in. K10 replaces _mdagm_cl_kernel
// (_mdagm_call_cl): chains-last planes (4, L0, L1, B), links (2, L0, L1, B).
// K11 replaces cg_solve_fused (pallas_fermion.py:321-416), its
// while_loop included: one launch a solve, in either layout (cg_kernel,
// below the operator).
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
// K11 is the same operator inside the CG loop, on the card from start to
// end. A group of work is one chain, split into C bands of rows, a CTA
// each, in a thread-block cluster when C > 1. The chain's links, b and x0
// are read once and x written once (chains-last, one float of a 32-byte
// sector a load: on the H100 that cost less than tiles of 8 chains, which
// left SMs idle at 128 chains; PERF.md); everything else stays in the band:
// p and the operator's intermediates in shared memory, checkerboard-compact
// (two parities apart, eo keeping only the even sites, where its vectors
// live: at 64^2 one CTA holds a chain in 224 KB), x, r and M p beside them,
// each chain's scalars in registers. One band (C = 1) wraps its rows around
// the lattice and needs nothing of another CTA; in a cluster each
// iteration copies p's four halo rows a side from the neighbour bands
// through distributed shared memory after a cluster barrier, and the
// passes recompute the halo as K9's do. Where no plan of up to 8 bands
// fits in shared memory, the same region lives in a device scratch, its
// halo rows read past L1 after the cluster barriers (release / acquire).
// The two sums of an iteration are deterministic: a butterfly in the warp,
// the warps in order, the cluster's ranks in order. M p repeats K9's
// arithmetic op for op (hop_site and combine), the update
// cg_update_plain's.
//
// K11 has a second storage type, bf16 (k11_cg_solve_bf16): the inner solve
// of the mixed-precision CG (fthmc_tpu/fermion.py _cg_solve_mixed's bf16
// inner while_loop). Its links, b, x0 and x are bf16 in device memory and
// every set of its band region is bf16 on chip (halving the region's
// bytes, so cg_plan may pick fewer bands); each value is rounded to bf16
// where it is stored, and the hops, alpha, beta and both sums run in fp32
// registers (the JAX loop rounds alpha and beta to bf16 too: the same
// algorithm, not the same bits). The layout (CgLayout) counts elements;
// cg_smem_bytes turns them into bytes by the storage type.
//
// Bounds: K9 and K10 must read p and four link planes and write four
// planes, 48 bytes a site a chain (12.6 MB at 64^2, B=64: 3.8 us at
// 3.35 TB/s); their arithmetic is 112 flops a site (each eo hop pass 44
// on half the sites, each combine 12 on all), 0.44 us at 67 TFLOP/s. Both
// are bound by bytes; what the design does about it is to read every
// input once into the chip (up to the halo rows), keep the intermediates
// there, fill the card's SMs in one wave with bands, and make every global
// access coalesced. K11 moves 64 bytes a site a chain once a solve (links,
// b, x0 in, x out) and does, an iteration, 120 flops a site eo (four hop
// passes of 44 and two combines of 12 on half the sites, and the update's
// 40 on the even half) or 152 not eo: at 64^2, 64 chains, 40 iterations
// 5.0 us of bytes against 18.8 us of arithmetic, so it is bound by
// operations, and by the latency of its barriers (six an eo iteration in
// one CTA) at small L.
#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int OP_THREADS = 256;

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

// Storage conversions: an element of a set (fp32 or bf16) as fp32, and an
// fp32 value rounded to the storage type (round to nearest even).
__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 rnd<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// h = (H s) at one site: s the source planes (plane stride ps); Us and Un
// the links ur0, ui0, ur1, ui1 (plane stride us) read at the site and at
// its neighbours (one array for K9 and K10; K11 keeps the two parities of
// a checkerboard apart); f0, b0, f1, b1 the offsets in a plane of the
// site's neighbours n + e0, n - e0, n + e1, n - e1, self its own (the
// links share the planes' offsets). The four hop directions in
// hop_planes' order.
// Every element is read through f32, so the sets may hold bf16 (K11's
// mixed-precision instance); the arithmetic is fp32 either way.
template <class T>
__device__ __forceinline__ void hop_site(const T* s, int ps, const T* Us,
                                         const T* Un, int us, int self,
                                         int f0, int b0, int f1, int b1,
                                         float h[4]) {
  // forward 0: u0(n) psi(n + e0), (d, -d), d = t0 - t1
  float dr = sub(f32(s[f0]), f32(s[2 * ps + f0]));
  float di = sub(f32(s[ps + f0]), f32(s[3 * ps + f0]));
  float u_r = f32(Us[self]), u_i = f32(Us[us + self]);
  float mr = sub(mul(u_r, dr), mul(u_i, di));
  float mi = add(mul(u_r, di), mul(u_i, dr));
  float h0r = mr, h0i = mi, h1r = -mr, h1i = -mi;
  // backward 0: conj(u0(n - e0)) psi(n - e0), (e, e), e = s0 + s1
  dr = add(f32(s[b0]), f32(s[2 * ps + b0]));
  di = add(f32(s[ps + b0]), f32(s[3 * ps + b0]));
  u_r = f32(Un[b0]);
  u_i = f32(Un[us + b0]);
  mr = add(mul(u_r, dr), mul(u_i, di));
  mi = sub(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = add(h1r, mr);
  h1i = add(h1i, mi);
  // forward 1: u1(n) psi(n + e1), (w, -i w), w = t0 + i t1
  dr = sub(f32(s[f1]), f32(s[3 * ps + f1]));
  di = add(f32(s[ps + f1]), f32(s[2 * ps + f1]));
  u_r = f32(Us[2 * us + self]);
  u_i = f32(Us[3 * us + self]);
  mr = sub(mul(u_r, dr), mul(u_i, di));
  mi = add(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = add(h1r, mi);
  h1i = sub(h1i, mr);
  // backward 1: conj(u1(n - e1)) psi(n - e1), (v, i v), v = s0 - i s1
  dr = add(f32(s[b1]), f32(s[3 * ps + b1]));
  di = sub(f32(s[ps + b1]), f32(s[2 * ps + b1]));
  u_r = f32(Un[2 * us + b1]);
  u_i = f32(Un[3 * us + b1]);
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

// Plane k of g5(a s - c h) at one site (g5 negates planes 2 and 3): the
// combine of both operators, as normal_op_planes forms it.
__device__ __forceinline__ float combine(int k, float a, float s, float c,
                                         float h) {
  const float v = sub(mul(a, s), mul(c, h));
  return k < 2 ? v : -v;
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
      hop_site(src, ly.ps, U, U, ly.us, at, at + ly.rs, at - ly.rs,
               row + jp * ly.TC + t, row + jm * ly.TC + t, h);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (KIND == HOP) {
        dst[at + k * ly.ps] = h[k];
      } else if (KIND == COMBINE) {
        dst[at + k * ly.ps] = combine(k, a, self[at + k * ly.ps], c, h[k]);
      } else {
        const float as = mul(a, self[at + k * ly.ps]);
        dst[at + k * ly.ps] = k < 2 ? as : -as;  // g5
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

// ---------------------------------------------------------------------------
// K11: the whole CG solve, one launch
// ---------------------------------------------------------------------------

constexpr int CG_MAX_THREADS = 1024;

// Four planes in a CTA's region, checkerboard-compact: element (plane k,
// parity par, set row b, half-column h) at off + k ks + par ps + b rs + h
// holds site (row, 2 h + ((row + par) & 1)). A set of
// one parity (eo: the even sites) has ps 0; row0 is the band row of the
// set's row 0 (the own-row sets start at the first own row).
struct CgSet {
  int off, ks, ps, row0;
};

// A CTA's region: a band of NR = R + 2 H rows, R the plan's largest band
// and H = HALO halo rows a side in a cluster (none where one CTA holds the
// lattice: rows wrap around the band). U the links [ur0, ui0, ur1, ui1],
// both parities; P the search direction; Q the operator's intermediates
// (eo: T on the odd sites, S and then M p on the even; not eo: T); M the
// result M p (eo: Q itself, not eo: own rows); X the solution and Rr the
// residual (own rows). eo keeps only the even sites of P, X and Rr, where
// the solve's vectors live. The reduction area follows the region in
// shared memory (the region itself may be device scratch): two slots of 32
// warp sums, two of the CTA's sums, the halo table.
struct CgLayout {
  int L0, L1, W;      // sides, W = L1 / 2
  int H, R, NR;       // halo rows a side, largest band, band rows
  int rs;             // row stride, W
  CgSet U, P, Q, M, X, Rr;
  int total;          // elements of a band region
  int red;            // floats of the reduction area
};

// Floats from a region's start to its reduction area: the region's
// elements of `elem` bytes, rounded up to a float.
__host__ __device__ inline int cg_red_at(const CgLayout& l, int elem) {
  return (l.total * elem + 3) / 4;
}

__host__ __device__ inline CgSet cg_set(int* off, int halves, int rows,
                                        int rs, int row0) {
  CgSet s;
  const int span = rows * rs;
  s.off = *off;
  s.ps = halves == 2 ? span : 0;
  s.ks = halves * span;
  s.row0 = row0;
  *off += 4 * s.ks;
  return s;
}

__host__ __device__ inline CgLayout cg_layout(int L0, int L1, int C, int R,
                                              int eo) {
  CgLayout l;
  l.L0 = L0;
  l.L1 = L1;
  l.W = L1 / 2;
  l.H = C > 1 ? HALO : 0;
  l.R = R;
  l.NR = R + 2 * l.H;
  l.rs = l.W;
  const int halves = eo ? 1 : 2;
  int off = 0;
  l.U = cg_set(&off, 2, l.NR, l.rs, 0);
  l.P = cg_set(&off, halves, l.NR, l.rs, 0);
  l.Q = cg_set(&off, 2, l.NR, l.rs, 0);
  l.M = eo ? l.Q : cg_set(&off, 2, R, l.rs, l.H);
  l.X = cg_set(&off, halves, R, l.rs, l.H);
  l.Rr = cg_set(&off, halves, R, l.rs, l.H);
  l.total = off;
  l.red = 2 * 32 + 2 + 4 * HALO;
  return l;
}

// T, the storage type: float, or __nv_bfloat16 for the inner solve of the
// mixed-precision CG (links, vectors and intermediates in bf16, in device
// memory and on chip; the arithmetic and the sums in fp32).
template <class T>
struct CgArgs {
  const T* ur;      // links (B, 2, L0, L1), or (2, L0, L1, B) chains-last
  const T* ui;
  const T* b;       // right-hand side (B, 4, L0, L1), or (4, L0, L1, B)
  const T* x0;      // start, b's shape, or null (zero)
  T* x;             // the solution, b's shape
  float* rel;       // (B,) final |r|^2 / max(|b|^2, 1e-30)
  int* counters;    // int32 (3,), see k11_cg_solve
  T* scratch;       // null: the bands in shared memory
  int B;
  float a, bq, tol;  // a = m + 2, bq = 1 / (4 a)
  int maxiter;
  Bands bands;
  CgLayout ly;
};

// What a CTA knows of its group and band.
template <class T>
struct CgBand {
  int C, rank, group;  // group: the chain
  int r0, R;     // first own row (global), own rows
  T* base;       // the band region (shared memory or scratch)
  float* red;    // the reduction area (shared memory)
};

template <class T>
__device__ __forceinline__ T* cg_at(T* base, const CgSet& s, int par) {
  return base + s.off + par * s.ps;
}

template <bool CL>
__device__ __forceinline__ size_t cg_gidx(int planes, int k, int i, int j,
                                          int c, int B, int L0, int L1) {
  if constexpr (CL)
    return ((static_cast<size_t>(k) * L0 + i) * L1 + j) *
               static_cast<size_t>(B) + c;
  else
    return ((static_cast<size_t>(c) * planes + k) * L0 + i) * L1 + j;
}

// Element e of a walk over (plane k, row rr of nr, column j), columns
// fastest.
__device__ __forceinline__ void cg_decode(int e, int nr, const CgLayout& ly,
                                          int& k, int& rr, int& j) {
  j = e % ly.L1;
  const int q = e / ly.L1;
  rr = q % nr;
  k = q / nr;
}

// Reads global rows g_lo .. g_lo + nr - 1 (wrapped) of four planes into
// set s from its row s_lo: a spinor (src1 null: planes 0-3 of src0) or
// the links (plane k from ur = src0 for even k, ui = src1 for odd, of
// direction k / 2). A set of one parity keeps the even sites, and an odd
// site that is not zero sets *odd (the compact storage would drop it).
template <bool CL, class T>
__device__ void cg_load(const CgArgs<T>& A, const CgBand<T>& bd,
                        const T* src0, const T* src1, const CgSet& s,
                        int s_lo, int g_lo, int nr, bool* odd) {
  const CgLayout& ly = A.ly;
  const int n = 4 * nr * ly.L1;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int k, rr, j;
    cg_decode(e, nr, ly, k, rr, j);
    int i = (g_lo + rr) % ly.L0;
    if (i < 0) i += ly.L0;
    const T v =
        src1 == nullptr
            ? __ldg(src0 + cg_gidx<CL>(4, k, i, j, bd.group, A.B, ly.L0,
                                       ly.L1))
            : __ldg((k & 1 ? src1 : src0) + cg_gidx<CL>(2, k >> 1, i, j,
                                                        bd.group, A.B, ly.L0,
                                                        ly.L1));
    const int par = (i + j) & 1;
    if (par && s.ps == 0) {
      if (f32(v) != 0.f) *odd = true;  // NaN too
      continue;
    }
    cg_at(bd.base, s, par)[k * s.ks + (s_lo + rr) * ly.rs + (j >> 1)] = v;
  }
}

// Writes the own rows of X to x (eo: zeros on the odd sites).
template <bool CL, class T>
__device__ void cg_store(const CgArgs<T>& A, const CgBand<T>& bd) {
  const CgLayout& ly = A.ly;
  const int n = 4 * bd.R * ly.L1;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int k, rr, j;
    cg_decode(e, bd.R, ly, k, rr, j);
    const int i = bd.r0 + rr, par = (i + j) & 1;
    T v = rnd<T>(0.f);
    if (!par || ly.X.ps)
      v = cg_at(bd.base, ly.X, par)[k * ly.X.ks + rr * ly.rs + (j >> 1)];
    A.x[cg_gidx<CL>(4, k, i, j, bd.group, A.B, ly.L0, ly.L1)] = v;
  }
}

// One pass over the sites of parity tp (by global row) of band rows [lo,
// lo + n): HOP dst = H(src), COMBINE dst =
// g5(a self - c H(src)), op_pass's arithmetic on checkerboard-compact
// sets (src read at the other parity). Row neighbours wrap around the band
// where it holds the lattice (H = 0). DOT: also adds p dst over the
// thread's sites to acc (p the P set), in the order the update sweeps
// visit them. Each value is rounded to the storage type as it is stored,
// and the dot takes the stored value.
template <int KIND, bool DOT, class T>
__device__ void cg_pass(const CgLayout& ly, const CgBand<T>& bd, int tp,
                        int lo, int n, const CgSet& src, const CgSet& self,
                        const CgSet& dst, float a, float c, float& acc) {
  const T* S = cg_at(bd.base, src, 1 - tp);
  const T* Us = cg_at(bd.base, ly.U, tp);
  const T* Un = cg_at(bd.base, ly.U, 1 - tp);
  const T* F = cg_at(bd.base, self, tp);
  T* D = cg_at(bd.base, dst, tp);
  const T* Pp = cg_at(bd.base, ly.P, tp);
  const int W = ly.W, rs = ly.rs;
  const int fo = self.row0 * rs, dof = dst.row0 * rs;
  for (Walk it(n, W, threadIdx.x, blockDim.x); it.q < 1; it.next()) {
    const int b = lo + it.r, h = it.c;
    const int q = (bd.r0 - ly.H + b + tp) & 1;  // the site's column 2 h + q
    int up = b + 1, dn = b - 1;
    if (ly.H == 0) {
      if (up == ly.NR) up = 0;
      if (dn < 0) dn = ly.NR - 1;
    }
    int hf = h + q, hb = h + q - 1;  // columns 2 h + q + 1 and 2 h + q - 1
    if (hf == W) hf = 0;
    if (hb < 0) hb = W - 1;
    const int at = b * rs + it.c;
    float hv[4];
    hop_site(S, src.ks, Us, Un, ly.U.ks, at, up * rs + it.c, dn * rs + it.c,
             b * rs + hf, b * rs + hb, hv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T v = rnd<T>(
          KIND == HOP ? hv[k]
                      : combine(k, a, f32(F[at - fo + k * self.ks]), c,
                                hv[k]));
      D[at - dof + k * dst.ks] = v;
      if (DOT) acc = add(acc, mul(f32(Pp[at + k * ly.P.ks]), f32(v)));
    }
  }
}

// M p of the P set into the M set's own rows: K9's passes (op_kernel) on
// the compact sets, each pass one row narrower a side in a cluster (rows
// [i, R + 2 H - i) of pass i), every row where one CTA holds the lattice.
// eo leaves out K9's odd-site SCALE passes: a vector on the even sites
// has zeros there. Returns this thread's sum of p M p.
template <bool EO, class T>
__device__ float cg_apply(const CgLayout& ly, const CgBand<T>& bd, float a,
                          float bq) {
  const int H = ly.H, R = bd.R;
  const int lo1 = H ? 1 : 0, n1 = H ? R + 6 : ly.NR;
  const int lo2 = H ? 2 : 0, n2 = H ? R + 4 : ly.NR;
  const int lo3 = H ? 3 : 0, n3 = H ? R + 2 : ly.NR;
  float dot = 0.f;
  if (EO) {
    cg_pass<HOP, false>(ly, bd, 1, lo1, n1, ly.P, ly.P, ly.Q, a, 0.f, dot);
    __syncthreads();
    cg_pass<COMBINE, false>(ly, bd, 0, lo2, n2, ly.Q, ly.P, ly.Q, a, bq, dot);
    __syncthreads();
    cg_pass<HOP, false>(ly, bd, 1, lo3, n3, ly.Q, ly.Q, ly.Q, a, 0.f, dot);
    __syncthreads();
    cg_pass<COMBINE, true>(ly, bd, 0, H, R, ly.Q, ly.Q, ly.Q, a, bq, dot);
  } else {
    for (int tp = 0; tp < 2; ++tp)
      cg_pass<COMBINE, false>(ly, bd, tp, lo3, n3, ly.P, ly.P, ly.Q, a, 0.5f,
                              dot);
    __syncthreads();
    for (int tp = 0; tp < 2; ++tp)
      cg_pass<COMBINE, true>(ly, bd, tp, H, R, ly.Q, ly.Q, ly.M, a, 0.5f, dot);
  }
  return dot;
}

// The chain's sum of each thread's v, in a fixed order: a butterfly over
// the warp, the warps' sums in warp order (every warp alike), then, in a
// cluster, the ranks' sums in rank order through distributed shared
// memory. Every thread gets the sum, the same bits in every CTA of the
// chain. slot alternates between consecutive calls: a slot is written
// again only after every thread has passed the barrier of the call
// between.
template <class T>
__device__ float cg_sum(float v, const CgBand<T>& bd, int slot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* wp = bd.red + slot * 32;
  for (int o = 16; o >= 1; o >>= 1)
    v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) wp[w] = v;
  __syncthreads();
  float s = 0.f;
  const int n = static_cast<int>(blockDim.x >> 5);
  if (lane < n) s = wp[lane];
  for (int o = 16; o >= 1; o >>= 1)
    s = add(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (bd.C == 1) return s;
  float* mine = bd.red + 2 * 32 + slot;
  if (threadIdx.x == 0) *mine = s;
  cg::this_cluster().sync();
  float tot = 0.f;
  for (int r = 0; r < bd.C; ++r)
    tot = add(tot, *cg::this_cluster().map_shared_rank(mine, r));
  return tot;
}

// The halo rows of P from the bands that own them, after a cluster barrier
// (every rank's own rows of p written): halo row hr's owner tab[2 hr] and
// its band row there tab[2 hr + 1], through distributed shared memory or
// the scratch (read past L1).
template <bool SM, class T>
__device__ void cg_halo(const CgArgs<T>& A, const CgBand<T>& bd,
                        const int* tab) {
  const CgLayout& ly = A.ly;
  cg::this_cluster().sync();
  const int span = ly.NR * ly.rs;
  const int per = (ly.P.ks / span) * 4 * ly.rs;  // floats of a band row
  const int n = 2 * ly.H * per;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int hr = e / per, rem = e - hr * per;
    const int ph = rem / ly.rs, c = rem - ph * ly.rs;
    const int o = tab[2 * hr], sb = tab[2 * hr + 1];
    const int db = hr < ly.H ? hr : bd.R + hr;
    const int at = ly.P.off + ph * span + c;
    T v;
    if constexpr (SM)
      v = *cg::this_cluster().map_shared_rank(bd.base + at + sb * ly.rs, o);
    else
      v = __ldcg(A.scratch +
                 static_cast<size_t>(bd.group * bd.C + o) * ly.total + at +
                 sb * ly.rs);
    bd.base[at + db * ly.rs] = v;
  }
  __syncthreads();
}

// K11: the whole solve of a chain, cg_solve_fused's while_loop on the
// card. Every thread keeps the chain's scalars (rsq, stop, active) in
// registers, the same bits in every thread; the chain loops while it is
// active and at most maxiter times, and stops at its own convergence
// (JAX's alpha = beta = 0 from then on; a NaN rsq stops it, as NaN > stop
// is false). No chain waits for another.
template <bool CL, bool SM, bool EO, class T>
__global__ void __launch_bounds__(CG_MAX_THREADS)
    cg_kernel(const __grid_constant__ CgArgs<T> A) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const CgLayout& ly = A.ly;
  CgBand<T> bd;
  bd.C = A.bands.C;
  bd.rank = bd.C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  bd.group = static_cast<int>(blockIdx.x) / bd.C;
  bd.r0 = A.bands.row0[bd.rank];
  bd.R = A.bands.row0[bd.rank + 1] - bd.r0;
  bd.base = SM ? reinterpret_cast<T*>(sm)
               : A.scratch + static_cast<size_t>(blockIdx.x) * ly.total;
  bd.red = SM ? sm + cg_red_at(ly, sizeof(T)) : sm;
  int* tab = reinterpret_cast<int*>(bd.red + 2 * 32 + 2);
  const int H = ly.H, R = bd.R;
  if (static_cast<int>(threadIdx.x) < 2 * H) {
    const int hr = threadIdx.x;
    int g = (bd.r0 - H + (hr < H ? hr : R + hr)) % ly.L0;
    if (g < 0) g += ly.L0;
    int o = 0;
    while (g >= A.bands.row0[o + 1]) ++o;
    tab[2 * hr] = o;
    tab[2 * hr + 1] = H + g - A.bands.row0[o];
  }
  bool odd = false;
  cg_load<CL, T>(A, bd, A.ur, A.ui, ly.U, 0, bd.r0 - H, R + 2 * H, &odd);
  cg_load<CL, T>(A, bd, A.b, nullptr, ly.Rr, 0, bd.r0, R, &odd);
  if (A.x0 != nullptr)
    cg_load<CL, T>(A, bd, A.x0, nullptr, ly.P, 0, bd.r0 - H, R + 2 * H,
                   &odd);
  if (odd) atomicOr(A.counters + 2, 1);
  __syncthreads();

  // r = b - M x0, x = x0, p = r, over the thread's own sites (the walk of
  // the last pass of M p, so a thread reads only the M p it wrote)
  const int npar = EO ? 1 : 2, cpr = ly.W, rs = ly.rs;
  if (A.x0 != nullptr) cg_apply<EO>(ly, bd, A.a, A.bq);
  float bs = 0.f, r2 = 0.f;
  for (int par = 0; par < npar; ++par) {
    T* P = cg_at(bd.base, ly.P, par) + H * rs;
    T* X = cg_at(bd.base, ly.X, par);
    T* Rr = cg_at(bd.base, ly.Rr, par);
    const T* M = cg_at(bd.base, ly.M, par) + (H - ly.M.row0) * rs;
    for (Walk it(R, cpr, threadIdx.x, blockDim.x); it.q < 1; it.next()) {
      const int o = it.r * rs + it.c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float bv = f32(Rr[o + k * ly.Rr.ks]);
        bs = add(bs, mul(bv, bv));
        float rv = bv, xv = 0.f;
        if (A.x0 != nullptr) {
          xv = f32(P[o + k * ly.P.ks]);
          rv = f32(rnd<T>(sub(bv, f32(M[o + k * ly.M.ks]))));
        }
        X[o + k * ly.X.ks] = rnd<T>(xv);
        Rr[o + k * ly.Rr.ks] = rnd<T>(rv);
        P[o + k * ly.P.ks] = rnd<T>(rv);
        r2 = add(r2, mul(rv, rv));
      }
    }
  }
  const float bsq = cg_sum(bs, bd, 0);
  float rsq = cg_sum(r2, bd, 1);
  const float stop = mul(A.tol, bsq);
  bool act = rsq > stop;
  bool any = __syncthreads_or(act);
  int slot = 0, iters = 0, live = 0;
  for (int it = 0; any && it < A.maxiter; ++it) {
    if (H) cg_halo<SM>(A, bd, tab);
    const float denom = cg_sum(cg_apply<EO>(ly, bd, A.a, A.bq), bd, slot);
    slot ^= 1;
    const float alpha = act ? rsq / fmaxf(denom, 1e-30f) : 0.f;
    float acc = 0.f;
    if (act) {
      for (int par = 0; par < npar; ++par) {
        const T* P = cg_at(bd.base, ly.P, par) + H * rs;
        T* X = cg_at(bd.base, ly.X, par);
        T* Rr = cg_at(bd.base, ly.Rr, par);
        const T* M = cg_at(bd.base, ly.M, par) + (H - ly.M.row0) * rs;
        for (Walk w(R, cpr, threadIdx.x, blockDim.x); w.q < 1; w.next()) {
          const int o = w.r * rs + w.c;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            T* xp = X + o + k * ly.X.ks;
            T* rp = Rr + o + k * ly.Rr.ks;
            *xp = rnd<T>(add(f32(*xp), mul(alpha, f32(P[o + k * ly.P.ks]))));
            const T rv =
                rnd<T>(sub(f32(*rp), mul(alpha, f32(M[o + k * ly.M.ks]))));
            *rp = rv;
            acc = add(acc, mul(f32(rv), f32(rv)));
          }
        }
      }
    }
    const float rn = cg_sum(acc, bd, slot);
    slot ^= 1;
    const bool next = act && rn > stop;
    if (act) {
      const float beta = rn / fmaxf(rsq, 1e-30f);
      for (int par = 0; par < npar; ++par) {
        T* P = cg_at(bd.base, ly.P, par) + H * rs;
        const T* Rr = cg_at(bd.base, ly.Rr, par);
        for (Walk w(R, cpr, threadIdx.x, blockDim.x); w.q < 1; w.next()) {
          const int o = w.r * rs + w.c;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            T* pp = P + o + k * ly.P.ks;
            *pp = rnd<T>(add(f32(Rr[o + k * ly.Rr.ks]), mul(beta, f32(*pp))));
          }
        }
      }
      rsq = rn;
    }
    iters = it + 1;
    any = __syncthreads_or(next);
    if (any) live = it + 1;
    act = next;
  }
  __syncthreads();
  cg_store<CL, T>(A, bd);
  if (bd.rank == 0 && threadIdx.x == 0) {
    A.rel[bd.group] = rsq / fmaxf(bsq, 1e-30f);
    atomicMax(A.counters, iters);
    atomicMax(A.counters + 1, live);
  }
  if (bd.C > 1) cg::this_cluster().sync();  // no rank reads a finished one
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

// opt-in set so far, by K11 instance (fp32, then bf16) and device
int g_cg_smem[16][64];

// A K11 launch: groups clusters of C CTAs.
template <bool CL, bool SM, bool EO, class T>
int launch_cg(const CgArgs<T>& A, int groups, int threads, int bytes,
              void* stream) {
  auto kernel = &cg_kernel<CL, SM, EO, T>;
  const int bf = sizeof(T) == 2 ? 8 : 0;
  const cudaError_t err =
      ensure_smem(kernel, bytes, g_cg_smem[bf + (CL ? 4 : 0) + (SM ? 2 : 0) +
                                           (EO ? 1 : 0)]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_clusters(kernel, groups, A.bands.C, threads,
                                          bytes, stream, A));
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

// Bytes of a K11 CTA's dynamic shared memory under a plan of C bands of at
// most `rows` rows, its sets of `elem` bytes an element (4: fp32, 2: bf16):
// the band region and the reduction area (in_smem 1), or the reduction area
// alone, the band region in device scratch (0); -1 for what the kernel does
// not take. The band region is the difference.
extern "C" int cg_smem_bytes(int L0, int L1, int C, int rows, int eo,
                             int in_smem, int elem) {
  if (!sides_ok(L0, L1) || C < 1 || C > MAX_BANDS || rows < 1 ||
      rows > L0 || rows * C < L0 || (elem != 4 && elem != 2))
    return -1;
  const CgLayout l = cg_layout(L0, L1, C, rows, eo);
  return static_cast<int>(sizeof(float)) *
         (in_smem ? cg_red_at(l, elem) + l.red : l.red);
}

namespace {

// Binds a K11 launch of storage type T; see the entries below.
template <class T>
int launch_k11(const void* ur, const void* ui, const void* b, const void* x0,
               void* x, float* rel, int* counters, void* scratch, int B,
               int L0, int L1, float a, float bq, int eo, float tol,
               int maxiter, int C, const int* row0, int threads, int cl,
               void* stream) {
  CgArgs<T> A;
  int R = 0;
  if (B < 1 || maxiter < 0 || !sides_ok(L0, L1) || threads < 32 ||
      threads > CG_MAX_THREADS || threads % 32 != 0 ||
      !bands_from(C, row0, L0, &R, &A.bands))
    return static_cast<int>(cudaErrorInvalidValue);
  A.ur = static_cast<const T*>(ur);
  A.ui = static_cast<const T*>(ui);
  A.b = static_cast<const T*>(b);
  A.x0 = static_cast<const T*>(x0);
  A.x = static_cast<T*>(x);
  A.rel = rel;
  A.counters = counters;
  A.scratch = static_cast<T*>(scratch);
  A.B = B;
  A.a = a;
  A.bq = bq;
  A.tol = tol;
  A.maxiter = maxiter;
  A.ly = cg_layout(L0, L1, C, R, eo);
  const int sm = scratch == nullptr;
  const int bytes = static_cast<int>(sizeof(float)) *
                    (sm ? cg_red_at(A.ly, sizeof(T)) + A.ly.red : A.ly.red);
  const int g = B, n = threads;
  switch ((cl ? 4 : 0) + (sm ? 2 : 0) + (eo ? 1 : 0)) {
    case 0: return launch_cg<false, false, false>(A, g, n, bytes, stream);
    case 1: return launch_cg<false, false, true>(A, g, n, bytes, stream);
    case 2: return launch_cg<false, true, false>(A, g, n, bytes, stream);
    case 3: return launch_cg<false, true, true>(A, g, n, bytes, stream);
    case 4: return launch_cg<true, false, false>(A, g, n, bytes, stream);
    case 5: return launch_cg<true, false, true>(A, g, n, bytes, stream);
    case 6: return launch_cg<true, true, false>(A, g, n, bytes, stream);
    default: return launch_cg<true, true, true>(A, g, n, bytes, stream);
  }
}

}  // namespace

// K11: B chains' whole CG solves of (M) x = b, M the normal operator of
// k9_mdagm (eo: its Schur form), in one launch: a cluster of C CTAs (the
// band plan row0[C + 1]) a chain, `threads` threads a CTA
// (a multiple of 32 up to 1024). ur, ui, b, x0 (null: zero), x in the
// layout of k9_mdagm (cl 0) or k10_mdagm_cl (cl 1), fp32 contiguous; eo:
// b and x0 zero on the odd sites. rel: (B,) each chain's final |r|^2 /
// max(|b|^2, 1e-30). counters: int32 (3,), zero before the launch: [0]
// the iterations in which a chain was active, [1] those after which one
// still was (maxima over chains), [2] 1 where b or x0 was not zero on an
// odd site (eo; the result is then not the solve). scratch: null (the
// bands in shared memory, which must fit) or B * C band regions
// (cg_smem_bytes). tol on |r|^2 / |b|^2; a = m + 2, bq = 1 / (4 a).
extern "C" int k11_cg_solve(const void* ur, const void* ui, const void* b,
                            const void* x0, void* x, float* rel,
                            int* counters, void* scratch, int B, int L0,
                            int L1, float a, float bq, int eo, float tol,
                            int maxiter, int C, const int* row0,
                            int threads, int cl, void* stream) {
  return launch_k11<float>(ur, ui, b, x0, x, rel, counters, scratch, B, L0,
                           L1, a, bq, eo, tol, maxiter, C, row0, threads, cl,
                           stream);
}

// K11 on bf16 storage, the inner solve of the mixed-precision CG: as
// k11_cg_solve, with ur, ui, b, x0 and x bf16 (and the band region bf16,
// cg_smem_bytes with elem 2). Every value is rounded to bf16 where it is
// stored; the hops, alpha, beta and the sums are fp32.
extern "C" int k11_cg_solve_bf16(const void* ur, const void* ui,
                                 const void* b, const void* x0, void* x,
                                 float* rel, int* counters, void* scratch,
                                 int B, int L0, int L1, float a, float bq,
                                 int eo, float tol, int maxiter, int C,
                                 const int* row0, int threads, int cl,
                                 void* stream) {
  return launch_k11<__nv_bfloat16>(ur, ui, b, x0, x, rel, counters, scratch,
                                   B, L0, L1, a, bq, eo, tol, maxiter, C,
                                   row0, threads, cl, stream);
}
