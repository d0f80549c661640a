// K8: input-cotangent VJP of one coupling layer from K7's residuals.
//
// Replaces fthmc_tpu/ops/pallas_coupling_vjp.py::_bwd_kernel
// (pallas_link_coupling_bwd). Given the layer input x, the residuals (hidden
// pre-activations and the raw conditioner output), the cotangent gy of the
// layer output and gl of its logJ, it returns gx. No parameter gradients and
// no conv recompute: the activation gates come from the stored
// pre-activations. One cluster a chain, a band of rows a CTA, as K7
// (coupling_common.cuh), in three stages:
//   A. per own site: the link-lift and mixture-transform backward, giving
//      the cotangents of the conditioner outputs (s, r, t), which land in
//      the band planes on the active stripe (0 elsewhere, and not read:
//      the first transposed conv sums only the taps that reach the
//      stripe, coupling_common.cuh's CONV_FROM_STRIPE), and the direct
//      part of the plaquette cotangent gp.
//      It keeps the value path's +-30 hard clip (zero gradient outside),
//      logJ's detached |s| and the s_clip chain rule (d/ds c*tanh(s/c) =
//      1 - (s_clipped/c)^2).
//   B. the transposed 3x3 conv chain, last conv first, the cotangent
//      staying in the band planes (halo rows from the neighbours between
//      convs); each hidden cotangent is gated by act'(pre), the
//      pre-activations loaded from K7's residuals before the sums start;
//      the first conv's (cos, sin) cotangents fold into gp on the frozen
//      stripe.
//   C. the plaquette-stencil transpose, gp's row above the band read from
//      the band above:
//      gx0(i,j) = gy0 + gp(i,j) - gp(i,j-1),
//      gx1(i,j) = gy1 + gp(i-1,j) - gp(i,j).
// Bound: the transposed conv chain's flops, as K7's (276 MFLOP per flagship
// launch; it runs 361, the taps of the first transposed conv that reach
// the stripe and the rest dense).
#include "coupling_common.cuh"

// Stage A at one site, its components m = sub, sub + tps, ... taken by
// lane sub of a group of tps lanes (every lane of the warp calls it; active
// is the same for a group): on the active stripe, writes the
// conditioner-output cotangents of its components (channel stride gs) and
// returns, on every lane of the group, the cotangent of the active
// plaquette through the transform (including the rncp identity term); the
// t channel is the caller's. raw has channel stride cs.
__device__ float transform_site_grad(const float* raw, int cs, float* g_out,
                                     int gs, float p, float g_f, float g_lj,
                                     bool active, const Layer& ly, int sub,
                                     int tps) {
  const int M = ly.M;
  const float inv_m = 1.f / static_cast<float>(M);
  // pass 1: the logsumexp of the component log-Jacobians
  float mx = -INFINITY, se = 0.f;
  if (active) {
    for (int m = sub; m < M; m += tps) {
      const float s = clipped_s(raw[m * cs], ly.s_clip);
      const float y = ly.rncp ? wrap_pi(p - raw[(M + m) * cs]) : p;
      lse_add(tan_logj(s, cosf(0.5f * y), sinf(0.5f * y)), mx, se);
    }
  }
  group_lse(mx, se, tps);
  // pass 2: per-component cotangents
  float g_xa = 0.f;
  const float g_hy = g_f * inv_m;
  if (active) {
    for (int m = sub; m < M; m += tps) {
      const float s = clipped_s(raw[m * cs], ly.s_clip);
      const float y = ly.rncp ? wrap_pi(p - raw[(M + m) * cs]) : p;
      const float cy = cosf(0.5f * y), sy = sinf(0.5f * y);
      const float sc = fminf(fmaxf(s, -HARD_CLIP), HARD_CLIP);
      const float gate = fabsf(s) < HARD_CLIP ? 1.f : 0.f;
      const float e = expf(sc);
      const float dh_dy = e / (cy * cy + (e * e) * (sy * sy));
      const float dh_ds = (2.f * sy * cy) * dh_dy * gate;
      const float mabs = fabsf(s);
      const float ep = expf(s - mabs), en = expf(-s - mabs);
      const float inner = en * cy * cy + ep * sy * sy;
      const float l = -(mabs + logf(inner + TINY));
      const float inv_inner = 1.f / (inner + TINY);
      const float dlj_dy = -(sy * cy) * (ep - en) * inv_inner;
      const float dlj_ds = (en * cy * cy - ep * sy * sy) * inv_inner;
      const float g_l = g_lj * (expf(l - mx) / se);
      float g_y = g_hy * dh_dy + g_l * dlj_dy;
      if (ly.rncp) g_y -= g_hy;  // the mixture sums h(y) - y
      float g_s = g_hy * dh_ds + g_l * dlj_ds;
      g_xa += g_y;
      if (ly.rncp) g_out[(M + m) * gs] = -g_y;
      if (ly.s_clip > 0.f) {
        const float u = s / ly.s_clip;
        g_s *= 1.f - u * u;
      }
      g_out[m * gs] = g_s;
    }
  }
  g_xa = group_sum(g_xa, tps);
  return ly.rncp ? g_f + g_xa : g_xa;
}

template <bool SM>
__device__ __forceinline__ float load_peer(const float* p) {
  if constexpr (SM) {
    return *p;
  } else {  // written by another SM: past L1
    return __ldcg(p);
  }
}

// The epilogue of a hidden transposed conv: the cotangent gated by
// act'(pre) into the output planes, pre loaded before the sums start.
struct GateEpi {
  float* out;         // output planes
  const float* pre;   // this chain's pre-activations of the conv's input
  int rout, L, r0, rs, plane, act;

  __device__ __forceinline__ void gate(int o0, int r, int j0,
                                       float (&g)[KO][KS]) const {
    const int i = r0 + r;
#pragma unroll
    for (int k = 0; k < KO; ++k)
#pragma unroll
      for (int q = 0; q < KS / 4; ++q) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (o0 + k < rout)
          v = __ldg(reinterpret_cast<const float4*>(
              pre + ((o0 + k) * L + i) * L + j0 + 4 * q));
        g[k][4 * q] = v.x;
        g[k][4 * q + 1] = v.y;
        g[k][4 * q + 2] = v.z;
        g[k][4 * q + 3] = v.w;
      }
  }

  __device__ __forceinline__ void store(int o0, int r, int j0, int,
                                        const float (&acc)[KO][KS],
                                        const float (&g)[KO][KS]) const {
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = o0 + k;
      if (o < rout) {
        float a[KS];
#pragma unroll
        for (int s = 0; s < KS; ++s) a[s] = acc[k][s] * act_grad(act, g[k][s]);
        float* row = out + o * plane + (r + 1) * rs + COL0;
#pragma unroll
        for (int q = 0; q < KS / 4; ++q)
          *reinterpret_cast<float4*>(row + j0 + 4 * q) =
              make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
        if (j0 == 0) row[L] = a[0];
        if (j0 + KS == L) row[-1] = a[KS - 1];
      }
    }
  }
};

// The epilogue of the first conv's transpose: d/dx2 of (cos x2, sin x2),
// x2 = p on the frozen stripe, added to gp.
struct FeatureEpi {
  float* gp;          // (R + 2) x L, own rows 1..R
  const float* xb;    // this chain's links
  int L, r0, mu, off;

  __device__ __forceinline__ void gate(int, int, int,
                                       float (&)[KO][KS]) const {}

  __device__ __forceinline__ void store(int o0, int r, int j0, int,
                                        const float (&acc)[KO][KS],
                                        const float (&)[KO][KS]) const {
    if (o0 != 0) return;
    const int i = r0 + r;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int j = j0 + s;
      const int st = stripe(i, j, mu, off);
      if (st == 1 || st == 2) {
        const float p = plaq_at(xb, i, j, L);
        gp[(r + 1) * L + j] += -sinf(p) * acc[0][s] + cosf(p) * acc[1][s];
      }
    }
  }
};

template <bool SM>
__global__ void __launch_bounds__(THREADS)
    coupling_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ gy,
                        const float* __restrict__ gl, float* __restrict__ gx,
                        Net net, Bufs res, Layer ly, Bands bands,
                        SmemLayout sl, float* scratch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Band bd = band_of<SM>(bands, sl, smem, scratch);
  const int L = ly.L, LL = L * L, n = net.n_convs;
  const int cn = net.width[n];
  const float* xb = x + static_cast<size_t>(bd.b) * 2 * LL;
  const float* gyb = gy + static_cast<size_t>(bd.b) * 2 * LL;
  const float* rawb = res.act[n - 1] + static_cast<size_t>(bd.b) * cn * LL;
  float* const buf0 = bd.region;
  float* const buf1 = bd.region + sl.cmax * sl.plane;
  float* gp = bd.region + sl.gp;  // (R + 2) x L: own rows 1..R, 0 above
  const float glb = gl[bd.b];

  stage_weights(net.w[n - 1], packed_floats(cn, net.width[n - 1]), smem);
  // A: transform and link-lift backward on the own rows, tps threads a
  // site, every lane in every pass (the group's shuffles)
  const int sites = bd.R * L, tps = site_threads(sites);
  const int sub = threadIdx.x % tps;
  for (int base = 0; base < sites; base += THREADS / tps) {
    const int s = base + threadIdx.x / tps;
    const bool valid = s < sites;
    const int r = valid ? s / L : 0, j = valid ? s - r * L : 0;
    const int i = bd.r0 + r, q = i * L + j;
    float* g = buf0 + (r + 1) * sl.rs + COL0 + j;
    const bool active = valid && stripe(i, j, ly.mu, ly.off) == 0;
    // fx_mu = wrap(x_mu +- delta): the cotangent of delta
    const float g_delta = active ? (ly.mu == 0 ? gyb[q] : -gyb[LL + q]) : 0.f;
    const float p = active ? plaq_at(xb, i, j, L) : 0.f;
    const float g_xa = transform_site_grad(rawb + q, LL, g, sl.plane, p,
                                           g_delta, glb, active, ly, sub,
                                           tps);
    if (valid && sub == 0) {
      if (active) g[(ly.rncp ? 2 * ly.M : ly.M) * sl.plane] = g_delta;  // t
      gp[(r + 1) * L + j] = active ? -g_delta + g_xa : 0.f;
    }
  }
  __syncthreads();
  pad_columns(sl, buf0, cn, bd.R, L);

  // B: transposed conv chain
  for (int k = 0; k < n; ++k) {
    const int l = n - 1 - k;
    const int rin = net.width[l + 1], rout = net.width[l];
    float* in = (k & 1) ? buf1 : buf0;
    float* out = (k & 1) ? buf0 : buf1;
    // the neighbours' own rows of this conv's input are written, and every
    // CTA is done with the previous conv
    cluster.sync();
    if (k > 0) stage_weights(net.w[l], packed_floats(rin, rout), smem);
    exchange_halos<SM>(bd, sl, in, rin);
    cp_async_wait<0>();
    __syncthreads();

    // the first (k = 0) reads stage A's cotangents, on the active stripe
    // only: its items sum the taps that reach the stripe
    if (l > 0) {
      GateEpi epi;
      epi.out = out;
      epi.pre = res.act[l - 1] + static_cast<size_t>(bd.b) * rout * LL;
      epi.rout = rout;
      epi.L = L;
      epi.r0 = bd.r0;
      epi.rs = sl.rs;
      epi.plane = sl.plane;
      epi.act = ly.act;
      if (k == 0)
        conv_band<CONV_FROM_STRIPE>(rin, rout, smem, in, sl, bd, ly, epi);
      else
        conv_band<CONV_DENSE>(rin, rout, smem, in, sl, bd, ly, epi);
    } else {
      // few items (two output channels): the input channels are split
      // between threads, the partial sums in the unused output planes
      FeatureEpi epi;
      epi.gp = gp;
      epi.xb = xb;
      epi.L = L;
      epi.r0 = bd.r0;
      epi.mu = ly.mu;
      epi.off = ly.off;
      if (k == 0)
        conv_band<CONV_FROM_STRIPE>(rin, rout, smem, in, sl, bd, ly, epi, out,
                                    sl.cmax * sl.plane);
      else
        conv_band<CONV_DENSE>(rin, rout, smem, in, sl, bd, ly, epi, out,
                              sl.cmax * sl.plane);
    }
  }

  // C: plaquette-stencil transpose
  cluster.sync();  // every band's gp is final
  const float* gp_up = peer<SM>(bd, sl, gp, bd.up) + bd.R_up * L;
  for (int j = threadIdx.x; j < L; j += THREADS)
    gp[j] = load_peer<SM>(gp_up + j);
  __syncthreads();
  float* gxb = gx + static_cast<size_t>(bd.b) * 2 * LL;
  for (int s = threadIdx.x; s < bd.R * L; s += THREADS) {
    const int r = s / L, j = s - r * L;
    const int q = (bd.r0 + r) * L + j;
    const int jm = (j == 0) ? L - 1 : j - 1;
    const float* row = gp + (r + 1) * L;
    gxb[q] = gyb[q] + row[j] - row[jm];
    gxb[LL + q] = gyb[LL + q] + row[j - L] - row[j];
  }
  cluster.sync();  // no CTA leaves while its band may be read
}

static int g_bwd_smem[2][64];  // opt-in set so far, by layout and device

// x, gy, gx: (B, 2, L, L); gl: (B,); res[l]: K7's residuals
// (B, widths[l+1], L, L); scratch: B * C * ft_band_floats(...) floats of
// device memory, or null where that is 0; (C, row0[C + 1]): the band plan;
// limit: the card's opt-in shared memory a block, bytes; w[l]: conv l
// packed transposed (Net). All fp32, contiguous, on the device.
extern "C" int k8_coupling_bwd(const float* x, const float* gy,
                               const float* gl, float* gx,
                               void* const* res, float* scratch, int B,
                               int L, int n_convs, const int* widths,
                               const void* const* w, int rncp, int M,
                               float s_clip, int activation, int mu, int off,
                               int C, const int* row0, int limit,
                               void* stream) {
  Bands bands;
  Net net;
  int R = 0;
  if (B < 1 || !bands_from(C, row0, L, &R, &bands) ||
      !net_from(n_convs, widths, L, R, &net))
    return static_cast<int>(cudaErrorInvalidValue);
  Bufs bufs;
  for (int l = 0; l < MAX_CONVS; ++l) {
    net.w[l] = l < n_convs ? static_cast<const float*>(w[l]) : nullptr;
    bufs.act[l] = l < n_convs ? static_cast<float*>(res[l]) : nullptr;
  }
  Layer ly;
  ly.L = L;
  ly.rncp = rncp;
  ly.M = M;
  ly.act = activation;
  ly.mu = mu;
  ly.off = off;
  ly.s_clip = s_clip;
  const SmemLayout sl = choose_layout(net, L, R, limit);
  const int bytes = static_cast<int>(sizeof(float)) * sl.total;
  if (bytes > limit || (!sl.act_smem && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sl.act_smem ? &coupling_bwd_kernel<true>
                            : &coupling_bwd_kernel<false>;
  cudaError_t err = ensure_smem(kernel, bytes, g_bwd_smem[sl.act_smem]);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_clusters(kernel, B, C, THREADS, bytes, stream, x, gy, gl,
                        gx, net, bufs, ly, bands, sl, scratch);
  return static_cast<int>(err);
}
