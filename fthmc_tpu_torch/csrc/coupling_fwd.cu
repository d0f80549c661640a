// K6 and K7: one fused gauge-equivariant coupling layer (ncp / rncp).
//
// K6 replaces fthmc_tpu/ops/pallas_coupling.py::_ncp_kernel
// (pallas_link_coupling_forward): links -> (links', logJ).
// K7 replaces fthmc_tpu/ops/pallas_coupling_vjp.py::_fwd_res_kernel
// (pallas_link_coupling_fwd_res): the same layer, keeping as residuals every
// hidden pre-activation and the raw conditioner output (s_raw, r, t) on the
// active stripe, 0 elsewhere, so that K8 needs no conv recompute.
//
// Both are one cluster launch of coupling_fwd_kernel: a cluster of C CTAs a
// chain, each owning a band of rows (coupling_common.cuh). A CTA computes
// the conv input (cos, sin of the frozen plaquettes) of its rows and their
// halo rows itself, then runs the circular 3x3 conv chain with its
// activations in its band planes: the activation is applied once, as a
// conv's output lands there, and between convs the halo rows come from the
// neighbours' planes after a cluster barrier. The last conv runs on the
// active stripe only, the one place the transform reads it
// (coupling_common.cuh, CONV_TO_STRIPE). K7 also stores every hidden
// pre-activation to its residual outputs as it lands (float4 stores of four
// consecutive sites), and the last after the chain. Then the mixture
// transform with its logsumexp log-Jacobian and the link update on the own
// rows, and logJ summed in a
// fixed order: per CTA, then by rank 0 over the cluster in rank order
// through distributed shared memory. Two launches on one input are
// bit-equal, and K6's logJ equals K7's.
//
// Bound: the conv flops the layer's outputs depend on (the last conv on the
// active stripe, the one before on its one-site halo: 285 MFLOP per
// flagship launch at 16^2 x 64 chains; the kernel runs 361 MFLOP, the
// convs before the last dense, on fp32 CUDA cores); bytes are far below.
#include "coupling_common.cuh"

// The epilogue of forward conv l: the pre-activations to K7's residuals,
// the activation into the output planes. The last conv's items lie on the
// active stripe (CONV_TO_STRIPE): its raw output goes to the planes at
// those sites alone, and K7's residual of it is stored after the chain.
struct FwdEpi {
  float* out;         // output planes
  float* res;         // this chain's residual of conv l; null: K6, last
  int cout, L, r0, rs, plane, act;
  bool last;

  __device__ __forceinline__ void gate(int, int, int,
                                       float (&)[KO][KS]) const {}

  __device__ __forceinline__ void store(int o0, int r, int j0, int step,
                                        const float (&acc)[KO][KS],
                                        const float (&)[KO][KS]) const {
    if (last) {
#pragma unroll
      for (int k = 0; k < KO; ++k) {
        if (o0 + k >= cout) continue;
        float* row = out + (o0 + k) * plane + (r + 1) * rs + COL0;
#pragma unroll
        for (int s = 0; s < KS; ++s)
          if (j0 + s * step < L) row[j0 + s * step] = acc[k][s];
      }
      return;
    }
    const int i = r0 + r;
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = o0 + k;
      if (o < cout) {
        float a[KS];
#pragma unroll
        for (int s = 0; s < KS; ++s) a[s] = act_fn(act, acc[k][s]);
        float* row = out + o * plane + (r + 1) * rs + COL0;
#pragma unroll
        for (int q = 0; q < KS / 4; ++q) {
          if (res != nullptr)
            *reinterpret_cast<float4*>(res + (o * L + i) * L + j0 + 4 * q) =
                make_float4(acc[k][4 * q], acc[k][4 * q + 1],
                            acc[k][4 * q + 2], acc[k][4 * q + 3]);
          *reinterpret_cast<float4*>(row + j0 + 4 * q) =
              make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
        }
        if (j0 == 0) row[L] = a[0];
        if (j0 + KS == L) row[-1] = a[KS - 1];
      }
    }
  }
};

template <bool SM>
__global__ void __launch_bounds__(THREADS)
    coupling_fwd_kernel(const float* __restrict__ x, float* __restrict__ fx,
                        float* __restrict__ logj, Net net, Bufs res,
                        Layer ly, Bands bands, SmemLayout sl,
                        float* scratch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Band bd = band_of<SM>(bands, sl, smem, scratch);
  const int L = ly.L, LL = L * L, n = net.n_convs;
  const float* xb = x + static_cast<size_t>(bd.b) * 2 * LL;
  float* red = smem + sl.red;
  float* const buf0 = bd.region;
  float* const buf1 = bd.region + sl.cmax * sl.plane;
  const bool keep = res.act[0] != nullptr;

  stage_weights(net.w[0], packed_floats(net.width[0], net.width[1]), smem);
  // conv 0's input: (cos, sin) of the frozen plaquettes, 0 elsewhere ->
  // (1, 0), on the own rows, both halo rows and the column images
  for (int e = threadIdx.x; e < (bd.R + 2) * (L + 2); e += THREADS) {
    const int rb = e / (L + 2), jj = e - rb * (L + 2);
    const int i = (bd.r0 + rb - 1 + L) % L, j = (jj - 1 + L) % L;
    const int st = stripe(i, j, ly.mu, ly.off);
    const float x2 = (st == 1 || st == 2) ? plaq_at(xb, i, j, L) : 0.f;
    float* p = buf0 + rb * sl.rs + COL0 - 1 + jj;
    p[0] = cosf(x2);
    p[sl.plane] = sinf(x2);
  }

  for (int l = 0; l < n; ++l) {
    const int cin = net.width[l], cout = net.width[l + 1];
    float* in = (l & 1) ? buf1 : buf0;
    if (l > 0) {
      // the neighbours' own rows of this conv's input are written, and
      // every CTA is done with conv l - 1 (its weights, its input planes)
      cluster.sync();
      stage_weights(net.w[l], packed_floats(cin, cout), smem);
      exchange_halos<SM>(bd, sl, in, cin);
    }
    cp_async_wait<0>();
    __syncthreads();

    FwdEpi epi;
    epi.out = (l & 1) ? buf0 : buf1;
    epi.last = l == n - 1;
    epi.res = keep && !epi.last
                  ? res.act[l] + static_cast<size_t>(bd.b) * cout * LL
                  : nullptr;
    epi.cout = cout;
    epi.L = L;
    epi.r0 = bd.r0;
    epi.rs = sl.rs;
    epi.plane = sl.plane;
    epi.act = ly.act;
    if (epi.last)  // the partial sums in the output planes past cout
      conv_band<CONV_TO_STRIPE>(cin, cout, smem, in, sl, bd, ly, epi,
                                epi.out + cout * sl.plane,
                                (sl.cmax - cout) * sl.plane);
    else
      conv_band<CONV_DENSE>(cin, cout, smem, in, sl, bd, ly, epi);
  }
  __syncthreads();  // the raw conditioner output is in its planes

  const float* raw = (n & 1) ? buf1 : buf0;
  if (keep) {
    // K7's residual of the last conv: the raw output on the active stripe,
    // 0 elsewhere (stored, not computed), four sites a store
    const int cn = net.width[n], n4 = L / 4;
    float* rl = res.act[n - 1] + static_cast<size_t>(bd.b) * cn * LL;
    for (int e = threadIdx.x; e < cn * bd.R * n4; e += THREADS) {
      const int q = e % n4, t = e / n4;
      const int r = t % bd.R, o = t / bd.R, i = bd.r0 + r;
      const float4 v = *reinterpret_cast<const float4*>(
          raw + o * sl.plane + (r + 1) * sl.rs + COL0 + 4 * q);
      const float a[4] = {v.x, v.y, v.z, v.w};
      float z[4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        z[s] = stripe(i, 4 * q + s, ly.mu, ly.off) == 0 ? a[s] : 0.f;
      *reinterpret_cast<float4*>(rl + (o * L + i) * L + 4 * q) =
          make_float4(z[0], z[1], z[2], z[3]);
    }
  }
  float* fxb = fx + static_cast<size_t>(bd.b) * 2 * LL;
  // the transform, tps threads a site, every lane in every pass (the
  // group's shuffles)
  const int sites = bd.R * L, tps = site_threads(sites);
  const int sub = threadIdx.x % tps;
  float lsum = 0.f;
  for (int base = 0; base < sites; base += THREADS / tps) {
    const int s = base + threadIdx.x / tps;
    const bool valid = s < sites;
    const int r = valid ? s / L : 0, j = valid ? s - r * L : 0;
    const int i = bd.r0 + r, q = i * L + j;
    const bool active = valid && stripe(i, j, ly.mu, ly.off) == 0;
    const float p = active ? plaq_at(xb, i, j, L) : 0.f;
    float lj;
    const float delta = transform_site(raw + (r + 1) * sl.rs + COL0 + j,
                                       sl.plane, p, active, ly, sub, tps,
                                       &lj);
    if (valid && sub == 0) {
      lsum += lj;
      const float x0 = xb[q], x1 = xb[LL + q];
      fxb[q] = (active && ly.mu == 0) ? wrap_pi(delta + x0) : x0;
      fxb[LL + q] = (active && ly.mu == 1) ? wrap_pi(-delta + x1) : x1;
    }
  }
  const float t = cta_sum(lsum, red);
  if (threadIdx.x == 0) red[NRED - 1] = t;
  cluster.sync();  // every CTA's sum is in place
  if (bd.rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < bd.C; ++r)
      total += *cluster.map_shared_rank(red + NRED - 1, r);
    logj[bd.b] = total;
  }
  cluster.sync();  // no CTA leaves while its shared memory may be read
}

static int g_fwd_smem[2][64];  // opt-in set so far, by layout and device

// The one C entry of K6 and K7; the two differ only in `res`.
// x, fx: (B, 2, L, L); logj: (B,); res: null (K6) or n_convs device
// buffers (B, widths[l+1], L, L) for the pre-activations (K7); scratch:
// B * C * ft_band_floats(...) floats of device memory, or null where that
// is 0; widths: n_convs + 1 ints (host); w[l]: (widths[l+1], widths[l], 3,
// 3) and bias[l] packed forward (Net); (C, row0[C + 1]): the band plan;
// limit: the card's opt-in shared memory a block, bytes. All fp32,
// contiguous.
extern "C" int ft_coupling_forward(const float* x, float* fx, float* logj,
                                   void* const* res, float* scratch, int B,
                                   int L, int n_convs, const int* widths,
                                   const void* const* w, int rncp, int M,
                                   float s_clip, int activation, int mu,
                                   int off, int C, const int* row0,
                                   int limit, void* stream) {
  Bands bands;
  Net net;
  int R = 0;
  if (B < 1 || !bands_from(C, row0, L, &R, &bands) ||
      !net_from(n_convs, widths, L, R, &net))
    return static_cast<int>(cudaErrorInvalidValue);
  Bufs bufs;
  for (int l = 0; l < MAX_CONVS; ++l) {
    net.w[l] = l < n_convs ? static_cast<const float*>(w[l]) : nullptr;
    bufs.act[l] = res != nullptr && l < n_convs ? static_cast<float*>(res[l])
                                                : nullptr;
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
  auto kernel = sl.act_smem ? &coupling_fwd_kernel<true>
                            : &coupling_fwd_kernel<false>;
  cudaError_t err = ensure_smem(kernel, bytes, g_fwd_smem[sl.act_smem]);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_clusters(kernel, B, C, THREADS, bytes, stream, x, fx, logj,
                        net, bufs, ly, bands, sl, scratch);
  return static_cast<int>(err);
}
