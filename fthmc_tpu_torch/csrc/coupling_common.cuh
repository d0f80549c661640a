// Device code shared by the coupling-layer kernels K6/K7 (coupling_fwd.cu)
// and K8 (coupling_bwd.cu): the band geometry, the circular 3x3 conv of a
// band, the halo exchange between the CTAs of a chain, and the per-site
// mixture transform of ncp / rncp.
//
// Geometry. A chain is one thread-block cluster of C CTAs (C <= 8, the
// portable cluster limit); CTA rank r owns rows [row0[r], row0[r+1]) of the
// lattice, for every channel (common.cuh's Bands; the band plan is chosen
// by the Python wrapper, ops/coupling_kernels.band_plan). A band's
// activations stay put for the whole conv chain: each channel is a plane
// of (R + 2) rows (the own rows 1..R, a halo row above and below) by
// L + 8 columns (column j at index j + 4, its periodic images j = -1 and
// j = L at indices 3 and L + 4, so a thread's four sites are one aligned
// float4). Between convs a cluster barrier, then each CTA copies its two
// halo rows from its neighbours' own rows (rank r - 1 and r + 1, wrapping
// C - 1 <-> 0) through distributed shared memory. Where the planes do not
// fit in shared memory they live in a device-memory scratch buffer of the
// band instead (the same layout), and the halo rows are read from the
// neighbours' scratch.
//
// The conv: a thread item is KS = 4 consecutive sites of a row x KO = 4
// output channels (16 sums in registers). For each (input channel, dy) it
// loads the row's six inputs (one float4 and two floats) and the 3 x KO
// weights of that row of taps (three float4s): 48 FFMAs for six
// shared-memory loads, 72 bytes a lane. A warp covers a row's site groups
// and its channel groups, so its input loads are broadcasts and its weight
// loads contiguous lines. The SM's shared-memory bandwidth, at 1.5 bytes a
// lane per FFMA, is what bounds the conv. Both ways around it that were
// tried ran slower on the H100: 8 sites an item (fewer bytes, half the
// warps idle) and every item's input channels split over lanes with the
// sums added by warp shuffles (the shuffles take the same bandwidth). So
// only a conv whose items would occupy less than a quarter of the threads
// (K8's last, two output channels; K6/K7's last on the active stripe) splits
// its input channels, with partial sums in planes the conv does not write.
//
// Stripe sparsity (ConvMode). The transform reads the conditioner's output
// on the layer's active stripe only, one row or one column in four, so
// K6/K7 compute their last conv only there (a quarter of its items, their
// input channels split over the CTA); K8's first transposed conv reads that
// cotangent, 0 off the stripe, so its items sum only the taps that reach
// the stripe (3 of 9 where any does). Every other conv is dense.
//
// Weights sit as w_s[(c * 9 + tap) * cpad + o], cpad = Cout rounded up to
// KO, followed by the cpad biases: the wrapper packs each conv once in that
// order (ops/coupling_kernels.pack_conv), so a conv's stage is one
// contiguous 16-byte cp.async copy, issued as soon as the previous conv is
// done and in flight during the halo exchange. One weight buffer, not two:
// a second takes CTA slots from the SMs, and on the H100 it left the last
// clusters of a flagship launch (4-row bands then) to a second wave, which
// cost more than the overlap saved (cudaOccupancyMaxActiveClusters tells).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int MAX_CONVS = 8;   // conv layers per conditioner
constexpr int KO = 4;          // output channels a thread item
constexpr int KS = 4;          // consecutive sites of a row a thread item
constexpr int THREADS = 256;   // threads a CTA
constexpr int COL0 = 4;        // plane index of column 0
constexpr int NRED = 32;       // floats of the logJ reduction
constexpr float HARD_CLIP = 30.f;
constexpr float TINY = 1e-30f;

enum Activation { ACT_RELU = 0, ACT_SILU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

// The conditioner of one coupling layer: widths[0] = 2 (cos, sin),
// widths[n_convs] = Cout of the last conv; w[l] conv l's (Cout, Cin, 3, 3)
// weights and bias packed in staging order, forward (K6/K7: rin =
// widths[l], rout = widths[l + 1]) or transposed (K8: rin = widths[l + 1],
// rout = widths[l], zero bias): rin * 9 * cpad weights
// w[(c * 9 + tap) * cpad + o], then cpad biases, cpad = rout rounded up to
// KO, zeros past rout.
struct Net {
  int n_convs;
  int width[MAX_CONVS + 1];
  const float* w[MAX_CONVS];
};

// Per-conv pre-activation buffers, each (B, width[l + 1], L, L): K7's
// residual outputs (null for K6), K8's residual inputs.
struct Bufs {
  float* act[MAX_CONVS];
};

struct Layer {
  int L;        // lattice edge, a multiple of 4
  int rncp;     // 1: rotated mixture, 0: ncp
  int M;        // mixture components
  int act;      // Activation
  int mu, off;  // mask parameters of this layer
  float s_clip; // <= 0: no smooth clip
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Offsets and sizes (in floats) of a CTA's memory. Used by the launches
// (size), the device (carving) and, through ft_smem_bytes and
// ft_band_floats, the Python wrappers, so none of them can disagree.
struct SmemLayout {
  int act_smem;  // 1: the band planes live in shared memory
  int wbuf;      // floats of the weight buffer: a packed conv
  int red;       // offset of the reduction floats
  int act;       // offset of the band region (shared memory or scratch)
  int rs;        // row stride of a plane, L + 8
  int plane;     // floats of one channel's plane, (R + 2) x rs
  int cmax;      // planes of one activation buffer
  int gp;        // offset in the band region of K8's plaquette cotangent
  int region;    // floats of the band region: two buffers and gp
  int total;     // floats of shared memory
};

__host__ __device__ inline SmemLayout smem_layout(const Net& net, int L,
                                                  int R, int act_smem) {
  int wmax = 0, cmax = 0;
  for (int l = 0; l < net.n_convs; ++l) {
    const int ci = net.width[l], co = net.width[l + 1];
    // forward (Cin -> Cout) and transposed (Cout -> Cin) staging
    const int fw = ci * 9 * round_up(co, KO), bw = co * 9 * round_up(ci, KO);
    wmax = fw > wmax ? fw : wmax;
    wmax = bw > wmax ? bw : wmax;
    cmax = ci > cmax ? ci : cmax;
    cmax = co > cmax ? co : cmax;
  }
  SmemLayout s;
  s.act_smem = act_smem;
  s.wbuf = round_up(wmax + round_up(cmax, KO), 4);
  s.red = s.wbuf;
  s.act = s.red + NRED;
  s.rs = L + 8;
  s.plane = (R + 2) * s.rs;
  s.cmax = cmax;
  s.gp = 2 * cmax * s.plane;
  s.region = round_up(s.gp + (R + 2) * L, 4);
  s.total = s.act + (act_smem ? s.region : 0);
  return s;
}

// The layout of a CTA of R rows under a limit of `limit` bytes: the band
// planes in shared memory where they fit, else in device memory (a layout
// over the limit even so is the caller's to refuse).
__host__ inline SmemLayout choose_layout(const Net& net, int L, int R,
                                         int limit) {
  const SmemLayout s = smem_layout(net, L, R, 1);
  return static_cast<long>(sizeof(float)) * s.total <= limit
             ? s
             : smem_layout(net, L, R, 0);
}

__host__ inline bool net_from(int n_convs, const int* widths, int L, int R,
                              Net* net) {
  if (n_convs < 1 || n_convs > MAX_CONVS || L < 4 || L % 4 != 0 || R < 1)
    return false;
  net->n_convs = n_convs;
  for (int l = 0; l <= n_convs; ++l) {
    if (widths[l] < 1) return false;
    net->width[l] = widths[l];
  }
  return true;
}

// Bytes of dynamic shared memory one K6/K7/K8 CTA takes for a conditioner
// of n_convs convs of the given widths (n_convs + 1 ints), lattice edge L
// and bands of at most R rows, under a limit of `limit` bytes (the card's
// opt-in maximum), or -1 for a conditioner or lattice the kernels do not
// take. A result over `limit` means no layout fits: the wrappers refuse.
extern "C" int ft_smem_bytes(int n_convs, const int* widths, int L, int R,
                             int limit) {
  Net net;
  if (!net_from(n_convs, widths, L, R, &net)) return -1;
  return static_cast<int>(sizeof(float)) *
         choose_layout(net, L, R, limit).total;
}

// Floats of device-memory scratch one CTA's band takes under that layout:
// 0 where its planes fit in shared memory.
extern "C" int ft_band_floats(int n_convs, const int* widths, int L, int R,
                              int limit) {
  Net net;
  if (!net_from(n_convs, widths, L, R, &net)) return -1;
  const SmemLayout s = choose_layout(net, L, R, limit);
  return s.act_smem ? 0 : s.region;
}

__device__ __forceinline__ float act_fn(int a, float v) {
  switch (a) {
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_SILU: return v / (1.f + expf(-v));
    case ACT_LEAKY: return v > 0.f ? v : 0.01f * v;
    default: return tanhf(v);
  }
}

__device__ __forceinline__ float act_grad(int a, float v) {
  switch (a) {
    case ACT_RELU: return v > 0.f ? 1.f : 0.f;
    case ACT_SILU: {
      const float sg = 1.f / (1.f + expf(-v));
      return sg * (1.f + v * (1.f - sg));
    }
    case ACT_LEAKY: return v > 0.f ? 1.f : 0.01f;
    default: {
      const float t = tanhf(v);
      return 1.f - t * t;
    }
  }
}

// Floats of one conv's packed weights and biases (rin inputs, rout
// outputs of the routine).
__host__ __device__ inline int packed_floats(int rin, int rout) {
  return (rin * 9 + 1) * round_up(rout, KO);
}

// Start staging one conv's packed weights and biases into a weight buffer
// by 16-byte cp.async, as one commit group.
__device__ void stage_weights(const float* __restrict__ src, int nfloats,
                              float* dst) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int e = threadIdx.x; e < nfloats / 4; e += THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     d + 16u * static_cast<unsigned>(e)),
                 "l"(src + 4 * e)
                 : "memory");
  cp_async_commit();
}

// What a CTA knows of its chain and band.
struct Band {
  int b;        // chain
  int rank, C;  // rank in the cluster, cluster size
  int r0, R;    // first own row, own rows
  int up, dn;   // ranks of the bands above (r0 - 1) and below
  int R_up;     // own rows of the band above
  float* region;        // this CTA's band region
  float* chain_region;  // rank 0's (device-memory layout only)
};

// (The layout is a template argument so that the compiler sees shared
// memory as such and reads it with shared-memory loads.)
template <bool SM>
__device__ inline Band band_of(const Bands& bands, const SmemLayout& sl,
                               float* smem, float* scratch) {
  Band bd;
  bd.C = bands.C;
  bd.b = blockIdx.x / bands.C;
  bd.rank = static_cast<int>(cg::this_cluster().block_rank());
  bd.r0 = bands.row0[bd.rank];
  bd.R = bands.row0[bd.rank + 1] - bd.r0;
  bd.up = (bd.rank + bd.C - 1) % bd.C;
  bd.dn = (bd.rank + 1) % bd.C;
  bd.R_up = bands.row0[bd.up + 1] - bands.row0[bd.up];
  if constexpr (SM) {
    bd.region = smem + sl.act;
    bd.chain_region = nullptr;
  } else {
    bd.chain_region =
        scratch + static_cast<size_t>(bd.b) * bd.C * sl.region;
    bd.region = bd.chain_region + static_cast<size_t>(bd.rank) * sl.region;
  }
  return bd;
}

// The same offset as p (inside this CTA's band region) in rank's region.
template <bool SM>
__device__ __forceinline__ const float* peer(const Band& bd,
                                             const SmemLayout& sl, float* p,
                                             int rank) {
  if constexpr (SM) {
    return cg::this_cluster().map_shared_rank(p, rank);
  } else {
    return bd.chain_region + static_cast<size_t>(rank) * sl.region +
           (p - bd.region);
  }
}

template <bool SM>
__device__ __forceinline__ float4 load_peer4(const float* p) {
  if constexpr (SM) {
    return *reinterpret_cast<const float4*>(p);
  } else {  // written by another SM: past L1
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
}

// Fill the halo rows (0 and R + 1) of `ch` planes of buf from the
// neighbours' own rows (the band above's last, the band below's first),
// whole padded rows. Call after a cluster barrier that follows the
// neighbours' writes of those rows.
template <bool SM>
__device__ void exchange_halos(const Band& bd, const SmemLayout& sl,
                               float* buf, int ch) {
  const float* up = peer<SM>(bd, sl, buf, bd.up);
  const float* dn = peer<SM>(bd, sl, buf, bd.dn);
  const int n4 = sl.rs / 4;
  for (int e = threadIdx.x; e < ch * 2 * n4; e += THREADS) {
    const int q = e % n4, t = e / n4;
    const int side = t & 1, c = t >> 1;
    const float* src = side == 0 ? up + c * sl.plane + bd.R_up * sl.rs
                                 : dn + c * sl.plane + sl.rs;
    float* dst = buf + c * sl.plane + (side == 0 ? 0 : (bd.R + 1) * sl.rs);
    reinterpret_cast<float4*>(dst)[q] = load_peer4<SM>(src + 4 * q);
  }
}

// Write the periodic column images (j = -1 and j = L) of rows 1..R of `ch`
// planes of buf.
__device__ void pad_columns(const SmemLayout& sl, float* buf, int ch, int R,
                            int L) {
  for (int e = threadIdx.x; e < ch * R; e += THREADS) {
    float* row = buf + (e / R) * sl.plane + (e % R + 1) * sl.rs;
    row[COL0 - 1] = row[COL0 + L - 1];
    row[COL0 + L] = row[COL0];
  }
}

// The sums of one thread item, KO output channels x KS sites of a row,
// from input channels [c0, c1), added to acc, in the order (c, dy, dx).
// ONE_ROW: only tap row dy1 (K8's first transposed conv, see item_sums).
template <bool ONE_ROW = false>
__device__ __forceinline__ void conv_item(int c0, int c1, int cpad,
                                          const float* w_s, const float* in,
                                          const SmemLayout& sl, int r, int j0,
                                          int o0, float (&acc)[KO][KS],
                                          int dy1 = 0) {
  const int rs = sl.rs, plane = sl.plane;
  // band row r (own row r + 1 in the plane) minus one, column j0 - 1
  const float* ip = in + r * rs + COL0 - 1 + j0;
  const float* wp = w_s + o0;
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
#pragma unroll
    for (int d = 0; d < (ONE_ROW ? 1 : 3); ++d) {
      const int dy = ONE_ROW ? dy1 : d;
      const float* row = ip + c * plane + dy * rs;
      const float4 m = *reinterpret_cast<const float4*>(row + 1);
      const float v[KS + 2] = {row[0], m.x, m.y, m.z, m.w, row[KS + 1]};
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            wp + (c * 9 + dy * 3 + dx) * cpad);
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const float u = v[s + dx];
          acc[0][s] = fmaf(w4.x, u, acc[0][s]);
          acc[1][s] = fmaf(w4.y, u, acc[1][s]);
          acc[2][s] = fmaf(w4.z, u, acc[2][s]);
          acc[3][s] = fmaf(w4.w, u, acc[3][s]);
        }
      }
    }
  }
}

// conv_item where the input is 0 off every fourth column: E is the index
// in the item's six inputs v (columns j0 - 1 .. j0 + 4, j0 a multiple of
// 4) of the first nonzero one, E + 4 the second where it is among them.
// Site s sums, for each (c, dy), only the tap dx with s + dx = E or E + 4:
// one tap or none (the site two columns from the stripe).
template <int E>
__device__ __forceinline__ void conv_item_cols(int c0, int c1, int cpad,
                                               const float* w_s,
                                               const float* in,
                                               const SmemLayout& sl, int r,
                                               int j0, int o0,
                                               float (&acc)[KO][KS]) {
  const int rs = sl.rs, plane = sl.plane;
  const float* ip = in + r * rs + COL0 - 1 + j0;
  const float* wp = w_s + o0;
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = ip + c * plane + dy * rs;
      const float u0 = row[E];
      const float u1 = E + 4 <= KS + 1 ? row[E + 4] : 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            wp + (c * 9 + dy * 3 + dx) * cpad);
        const int s0 = E - dx, s1 = E + 4 - dx;
        if (s0 >= 0 && s0 < KS) {
          acc[0][s0] = fmaf(w4.x, u0, acc[0][s0]);
          acc[1][s0] = fmaf(w4.y, u0, acc[1][s0]);
          acc[2][s0] = fmaf(w4.z, u0, acc[2][s0]);
          acc[3][s0] = fmaf(w4.w, u0, acc[3][s0]);
        }
        if (E + 4 <= KS + 1 && s1 >= 0 && s1 < KS) {
          acc[0][s1] = fmaf(w4.x, u1, acc[0][s1]);
          acc[1][s1] = fmaf(w4.y, u1, acc[1][s1]);
          acc[2][s1] = fmaf(w4.z, u1, acc[2][s1]);
          acc[3][s1] = fmaf(w4.w, u1, acc[3][s1]);
        }
      }
    }
  }
}

// The sums of a thread item of KS sites of a row at stride 4 (the active
// stripe's columns j0, j0 + 4, ...; a site at or past L repeats site j0 and
// its sums are not stored), every tap, in conv_item's order.
__device__ __forceinline__ void conv_item_stripe(int c0, int c1, int cpad,
                                                 const float* w_s,
                                                 const float* in,
                                                 const SmemLayout& sl, int L,
                                                 int r, int j0, int o0,
                                                 float (&acc)[KO][KS]) {
  const int rs = sl.rs, plane = sl.plane;
  const float* ip = in + r * rs + COL0 - 1;
  const float* wp = w_s + o0;
  int col[KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) col[s] = j0 + 4 * s < L ? j0 + 4 * s : j0;
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = ip + c * plane + dy * rs;
      float v[KS][3];
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[s][dx] = row[col[s] + dx];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            wp + (c * 9 + dy * 3 + dx) * cpad);
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const float u = v[s][dx];
          acc[0][s] = fmaf(w4.x, u, acc[0][s]);
          acc[1][s] = fmaf(w4.y, u, acc[1][s]);
          acc[2][s] = fmaf(w4.z, u, acc[2][s]);
          acc[3][s] = fmaf(w4.w, u, acc[3][s]);
        }
      }
    }
  }
}

// How a conv's thread items are laid and which taps they sum.
//   CONV_DENSE: every own row, KS consecutive sites from a multiple of KS,
//     every tap.
//   CONV_TO_STRIPE: the last conv of K6/K7, whose output the transform reads
//     on the active stripe only (stripe() == 0): mu == 1, the band's active
//     rows, KS consecutive sites; mu == 0, every own row, its L / 4 active
//     sites KS at a time at stride 4 (the last item of a row short where
//     L / 4 is not a multiple of KS: L = 4, 8, 20).
//   CONV_FROM_STRIPE: the first transposed conv of K8, whose input (the
//     cotangent of the conditioner's output) is 0 off the active stripe:
//     dense items, each summing only the taps whose input site is on the
//     stripe (item_sums). The terms dropped are exact zeros and the rest
//     keep conv_item's order, so the sums are the dense ones bit for bit.
enum ConvMode { CONV_DENSE = 0, CONV_TO_STRIPE = 1, CONV_FROM_STRIPE = 2 };

// The items of a conv: KO output channels x KS sites of own row
// r_first + k r_step (k < nrows), sites j0 + s step from
// j0 = j_first + g KS step (g < ngroups).
struct Items {
  int nrows, r_first, r_step;
  int ngroups, j_first, step;

  __device__ __forceinline__ void place(int item, int ncg, int* r, int* j0,
                                        int* o0) const {
    const int g = item % ngroups, q = item / ngroups;
    *o0 = (q % ncg) * KO;
    *r = r_first + (q / ncg) * r_step;
    *j0 = j_first + g * KS * step;
  }
};

__device__ inline Items items_of(int mode, const Band& bd, const Layer& ly) {
  const int L = ly.L, o = (ly.off % 4 + 4) % 4;
  if (mode != CONV_TO_STRIPE) return {bd.R, 0, 1, L / KS, 0, 1};
  if (ly.mu == 1) {
    const int first = ((o - bd.r0) % 4 + 4) % 4;  // first own active row
    return {first < bd.R ? (bd.R - 1 - first) / 4 + 1 : 0, first, 4, L / KS,
            0, 1};
  }
  return {bd.R, 0, 1, (L / 4 + KS - 1) / KS, o, 4};
}

// The sums of one item (r, j0, o0) of a conv of the given mode, input
// channels [c0, c1), added to acc.
template <int MODE>
__device__ __forceinline__ void item_sums(int c0, int c1, int cpad,
                                          const float* w_s, const float* in,
                                          const SmemLayout& sl,
                                          const Band& bd, const Layer& ly,
                                          int step, int r, int j0, int o0,
                                          float (&acc)[KO][KS]) {
  if constexpr (MODE == CONV_FROM_STRIPE) {
    if (ly.mu == 1) {
      // the tap row whose input row r0 + r + dy - 1 is active; none (3)
      // for the rows two steps from the stripe
      const int dy = ((ly.off - bd.r0 - r + 1) % 4 + 4) % 4;
      if (dy < 3)
        conv_item<true>(c0, c1, cpad, w_s, in, sl, r, j0, o0, acc, dy);
    } else {
      // v[e] is column j0 - 1 + e, active for e = off + 1 (mod 4)
      switch (((ly.off + 1) % 4 + 4) % 4) {
        case 0:
          conv_item_cols<0>(c0, c1, cpad, w_s, in, sl, r, j0, o0, acc);
          break;
        case 1:
          conv_item_cols<1>(c0, c1, cpad, w_s, in, sl, r, j0, o0, acc);
          break;
        case 2:
          conv_item_cols<2>(c0, c1, cpad, w_s, in, sl, r, j0, o0, acc);
          break;
        default:
          conv_item_cols<3>(c0, c1, cpad, w_s, in, sl, r, j0, o0, acc);
      }
    }
  } else if (MODE == CONV_TO_STRIPE && step != 1) {
    conv_item_stripe(c0, c1, cpad, w_s, in, sl, ly.L, r, j0, o0, acc);
  } else {
    conv_item(c0, c1, cpad, w_s, in, sl, r, j0, o0, acc);
  }
}

// One circular 3x3 conv of a band: out[o](i, j) = b[o] + sum_{c,dy,dx}
// w[o][c][dy][dx] * in[c](i + dy - 1, j + dx - 1) for the sites of the
// mode's items (ConvMode), the input planes holding their halo rows and
// column images, w_s a packed conv (its biases follow its weights).
// epi.gate(o0, r, j0, g) may fill g[k][s] for channels o0..o0+KO-1 at own
// row r (0-based), sites j0..j0+KS-1 before the sums start (K8's activation
// gates, loaded early; dense items only); epi.store(o0, r, j0, step, acc,
// g) takes the sums of sites j0 + s step. Where the items would occupy
// less than a quarter of the CTA and `part` (part_floats floats of this
// CTA's memory, not read or written by the epilogue) is given, the input
// channels are split between threads and the partial sums added in a fixed
// order. Every thread of the CTA calls this.
template <int MODE, class Epi>
__device__ void conv_band(int cin, int cout, const float* w_s,
                          const float* in, const SmemLayout& sl,
                          const Band& bd, const Layer& ly, const Epi& epi,
                          float* part = nullptr, int part_floats = 0) {
  const Items it = items_of(MODE, bd, ly);
  const int cpad = round_up(cout, KO);
  const int ncg = cpad / KO;
  const int nitems = it.nrows * ncg * it.ngroups;
  if (nitems == 0) return;
  const float* b_s = w_s + cin * 9 * cpad;
  int nsplit = 1;
  if (part != nullptr && 4 * nitems <= THREADS) {
    nsplit = THREADS / nitems;
    nsplit = nsplit < cin ? nsplit : cin;
    const int fit = part_floats / (nitems * KO * KS);
    nsplit = nsplit < fit ? nsplit : fit;
    nsplit = nsplit > 1 ? nsplit : 1;
  }
  if (nsplit > 1) {
    const int t = threadIdx.x;
    if (t < nitems * nsplit) {
      const int item = t % nitems, chunk = t / nitems;
      int r, j0, o0;
      it.place(item, ncg, &r, &j0, &o0);
      float acc[KO][KS];
#pragma unroll
      for (int k = 0; k < KO; ++k)
#pragma unroll
        for (int s = 0; s < KS; ++s) acc[k][s] = 0.f;
      item_sums<MODE>(chunk * cin / nsplit, (chunk + 1) * cin / nsplit, cpad,
                      w_s, in, sl, bd, ly, it.step, r, j0, o0, acc);
      float4* dst = reinterpret_cast<float4*>(part) + t * KO;
#pragma unroll
      for (int k = 0; k < KO; ++k)
        dst[k] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    }
    __syncthreads();
  }
  for (int item = threadIdx.x; item < nitems; item += THREADS) {
    int r, j0, o0;
    it.place(item, ncg, &r, &j0, &o0);
    float g[KO][KS];
    epi.gate(o0, r, j0, g);
    float acc[KO][KS];
    const float4 bv = *reinterpret_cast<const float4*>(b_s + o0);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      acc[0][s] = bv.x;
      acc[1][s] = bv.y;
      acc[2][s] = bv.z;
      acc[3][s] = bv.w;
    }
    if (nsplit == 1) {
      item_sums<MODE>(0, cin, cpad, w_s, in, sl, bd, ly, it.step, r, j0, o0,
                      acc);
    } else {
      for (int chunk = 0; chunk < nsplit; ++chunk) {
        const float4* src = reinterpret_cast<const float4*>(part) +
                            (chunk * nitems + item) * KO;
#pragma unroll
        for (int k = 0; k < KO; ++k) {
          const float4 v = src[k];
          acc[k][0] += v.x;
          acc[k][1] += v.y;
          acc[k][2] += v.z;
          acc[k][3] += v.w;
        }
      }
    }
    epi.store(o0, r, j0, it.step, acc, g);
  }
}

// Sum of v over the CTA in a fixed order (warp shuffles, then the warps in
// turn), returned to thread 0.
__device__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  return t;
}

// Log-scale of component m after the optional smooth clip.
__device__ __forceinline__ float clipped_s(float raw, float s_clip) {
  return s_clip > 0.f ? s_clip * tanhf(raw / s_clip) : raw;
}

// log h'_s(y), factored by m = |s| so both exponents are <= 0.
__device__ __forceinline__ float tan_logj(float s, float cy, float sy) {
  const float m = fabsf(s);
  const float inner = expf(-s - m) * cy * cy + expf(s - m) * sy * sy;
  return -(m + logf(inner + TINY));
}

// Threads that share one site's mixture transform: a power of two up to 8
// with every site of the band taken at once where the CTA has the threads.
__device__ __forceinline__ int site_threads(int sites) {
  int t = 1;
  while (t < 8 && 2 * t * sites <= THREADS) t *= 2;
  return t;
}

// Sum of v over the tps lanes of a site's group (aligned lanes of a warp),
// in a fixed order; every lane of the warp calls it.
__device__ __forceinline__ float group_sum(float v, int tps) {
  for (int o = 1; o < tps; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The logsumexp (max mx, scaled sum se) of the tps lanes of a group.
__device__ __forceinline__ void group_lse(float& mx, float& se, int tps) {
  for (int o = 1; o < tps; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, mx, o);
    const float so = __shfl_xor_sync(0xffffffffu, se, o);
    const float m = fmaxf(mx, mo);
    se = (se > 0.f ? se * expf(mx - m) : 0.f) +
         (so > 0.f ? so * expf(mo - m) : 0.f);
    mx = m;
  }
}

// Add log-Jacobian l of one component to the running (mx, se).
__device__ __forceinline__ void lse_add(float l, float& mx, float& se) {
  if (l > mx) {
    se = se * expf(mx - l) + 1.f;
    mx = l;
  } else {
    se += expf(l - mx);
  }
}

// Forward mixture transform of the plaquette p at one site, its components
// m = sub, sub + tps, ... taken by lane sub of a group of tps lanes (every
// lane of the warp calls it; active is the same for a group). raw points at
// the site's first conditioner channel, channel stride cs. Returns the
// plaquette change new_p - p and writes the site's log-Jacobian
// contribution (0 off the active stripe), both on every lane of the group.
__device__ float transform_site(const float* raw, int cs, float p,
                                bool active, const Layer& ly, int sub,
                                int tps, float* lj) {
  const int M = ly.M;
  float hsum = 0.f, mx = -INFINITY, se = 0.f;
  if (active) {
    for (int m = sub; m < M; m += tps) {
      const float s = clipped_s(raw[m * cs], ly.s_clip);
      const float y = ly.rncp ? wrap_pi(p - raw[(M + m) * cs]) : p;
      const float cy = cosf(0.5f * y), sy = sinf(0.5f * y);
      const float sc = fminf(fmaxf(s, -HARD_CLIP), HARD_CLIP);
      const float h = wrap_pi(2.f * atan2f(expf(sc) * sy, cy));
      hsum += ly.rncp ? h - y : h;
      lse_add(tan_logj(s, cy, sy), mx, se);
    }
  }
  hsum = group_sum(hsum, tps);
  group_lse(mx, se, tps);
  if (!active) {
    *lj = 0.f;
    return 0.f;
  }
  const float t = raw[(ly.rncp ? 2 * M : M) * cs];
  const float f1 = ly.rncp ? p + hsum / M : hsum / M;
  *lj = mx + logf(se) - logf(static_cast<float>(M));
  return wrap_pi(f1 + t) - p;
}
