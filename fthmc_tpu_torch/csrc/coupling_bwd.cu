// K8: input-cotangent VJP of one coupling layer from K7's residuals.
//
// Replaces fthmc_tpu/ops/pallas_coupling_vjp.py::_bwd_kernel
// (pallas_link_coupling_bwd). Given the layer input x, the residuals (hidden
// pre-activations and the raw conditioner output), the cotangent gy of the
// layer output and gl of its logJ, it returns gx. No parameter gradients and
// no conv recompute: the activation gates come from the stored
// pre-activations. One block per chain, in three stages:
//   A. per site: the link-lift and mixture-transform backward, giving the
//      cotangents of the conditioner outputs (s, r, t) and the direct part
//      of the plaquette cotangent. It keeps the value path's +-30 hard clip
//      (zero gradient outside), logJ's detached |s| and the s_clip chain
//      rule (d/ds c*tanh(s/c) = 1 - (s_clipped/c)^2).
//   B. the transposed 3x3 conv chain, last conv first, each hidden cotangent
//      gated by act'(pre); the first conv's (cos, sin) cotangents fold into
//      the plaquette cotangent on the frozen stripe.
//   C. the plaquette-stencil transpose:
//      gx0(i,j) = gy0 + gp(i,j) - gp(i,j-1), gx1(i,j) = gy1 + gp(i-1,j) - gp(i,j).
// Bound: the transposed conv chain's flops, as K7's.
#include "coupling_common.cuh"

// Stage A at one active site: writes the conditioner-output cotangents
// (channel stride LL) and returns the cotangent of the active plaquette
// through the transform (including the rncp identity term).
__device__ float transform_site_grad(const float* raw, float* g_out, int LL,
                                     float p, float g_f, float g_lj,
                                     const Layer& ly) {
  const int M = ly.M;
  const float inv_m = 1.f / static_cast<float>(M);
  // pass 1: the logsumexp of the component log-Jacobians
  float mx = -INFINITY, se = 0.f;
  for (int m = 0; m < M; ++m) {
    const float s = clipped_s(raw[m * LL], ly.s_clip);
    const float y = ly.rncp ? wrap_pi(p - raw[(M + m) * LL]) : p;
    const float l = tan_logj(s, cosf(0.5f * y), sinf(0.5f * y));
    if (l > mx) {
      se = se * expf(mx - l) + 1.f;
      mx = l;
    } else {
      se += expf(l - mx);
    }
  }
  // pass 2: per-component cotangents
  float g_xa = ly.rncp ? g_f : 0.f;
  const float g_hy = g_f * inv_m;
  for (int m = 0; m < M; ++m) {
    const float s = clipped_s(raw[m * LL], ly.s_clip);
    const float y = ly.rncp ? wrap_pi(p - raw[(M + m) * LL]) : p;
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
    if (ly.rncp) g_out[(M + m) * LL] = -g_y;
    if (ly.s_clip > 0.f) {
      const float u = s / ly.s_clip;
      g_s *= 1.f - u * u;
    }
    g_out[m * LL] = g_s;
  }
  g_out[(ly.rncp ? 2 * M : M) * LL] = g_f;  // t
  return g_xa;
}

__global__ void __launch_bounds__(THREADS)
    coupling_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ gy,
                        const float* __restrict__ gl, float* __restrict__ gx,
                        Net net, Bufs res, float* __restrict__ scratch0,
                        float* __restrict__ scratch1, float* __restrict__ gp,
                        int cmax, Layer ly) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const SmemLayout sl = smem_layout(net, ly.TW);
  float* w_s = smem + sl.w;
  float* b_s = smem + sl.b;
  float* tile = smem + sl.tile;

  const int L = ly.L, LL = L * L;
  const int b = blockIdx.x;
  const int n = net.n_convs;
  const float* xb = x + static_cast<size_t>(b) * 2 * LL;
  const float* gyb = gy + static_cast<size_t>(b) * 2 * LL;
  const float* raw = res.act[n - 1] + static_cast<size_t>(b) * net.width[n] * LL;
  float* gin = scratch0 + static_cast<size_t>(b) * cmax * LL;
  float* gnext = scratch1 + static_cast<size_t>(b) * cmax * LL;
  float* gpb = gp + static_cast<size_t>(b) * LL;
  const float glb = gl[b];

  // A: transform and link-lift backward
  for (int s = threadIdx.x; s < LL; s += blockDim.x) {
    const int i = s / L, j = s - (s / L) * L;
    const bool active = stripe(i, j, ly.mu, ly.off) == 0;
    float gpart = 0.f;
    if (active) {
      // fx_mu = wrap(x_mu +- delta): the cotangent of delta
      const float g_delta = ly.mu == 0 ? gyb[s] : -gyb[LL + s];
      const float p = plaq_at(xb, i, j, L);
      const float g_xa =
          transform_site_grad(raw + s, gin + s, LL, p, g_delta, glb, ly);
      gpart = -g_delta + g_xa;
    } else {
      for (int c = 0; c < net.width[n]; ++c) gin[c * LL + s] = 0.f;
    }
    gpb[s] = gpart;
  }

  // B: transposed conv chain
  for (int l = n - 1; l >= 0; --l) {
    const int rin = net.width[l + 1], rout = net.width[l];
    __syncthreads();  // stage A / the previous conv is done
    stage_weights(net.w[l], nullptr, rin, rout, true, w_s, b_s);
    const float* g = gin;
    auto load = [&](int c, int i, int j) { return g[c * LL + i * L + j]; };
    if (l > 0) {
      const float* pre = res.act[l - 1] + static_cast<size_t>(b) * rout * LL;
      float* o = gnext;
      auto store = [&](int o0, int i, int j, const float(&acc)[OC]) {
        const int s = i * L + j;
#pragma unroll
        for (int k = 0; k < OC; ++k)
          if (o0 + k < rout)
            o[(o0 + k) * LL + s] =
                acc[k] * act_grad(ly.act, pre[(o0 + k) * LL + s]);
      };
      conv3x3(rin, rout, w_s, b_s, tile, ly, load, store);
      float* tmp = gin;
      gin = gnext;
      gnext = tmp;
    } else {
      // d/dx2 of (cos x2, sin x2), x2 = p on the frozen stripe
      auto store = [&](int o0, int i, int j, const float(&acc)[OC]) {
        const int st = stripe(i, j, ly.mu, ly.off);
        if (o0 == 0 && (st == 1 || st == 2)) {
          const float p = plaq_at(xb, i, j, L);
          gpb[i * L + j] += -sinf(p) * acc[0] + cosf(p) * acc[1];
        }
      };
      conv3x3(rin, rout, w_s, b_s, tile, ly, load, store);
    }
  }
  __syncthreads();

  // C: plaquette-stencil transpose
  float* gxb = gx + static_cast<size_t>(b) * 2 * LL;
  for (int s = threadIdx.x; s < LL; s += blockDim.x) {
    const int i = s / L, j = s - (s / L) * L;
    const int im = (i == 0) ? L - 1 : i - 1;
    const int jm = (j == 0) ? L - 1 : j - 1;
    gxb[s] = gyb[s] + gpb[s] - gpb[i * L + jm];
    gxb[LL + s] = gyb[LL + s] + gpb[im * L + j] - gpb[s];
  }
}

// x, gy, gx: (B, 2, L, L); gl: (B,); res[l]: K7's residuals
// (B, widths[l+1], L, L); scratch0/scratch1: (B, cmax, L, L) with cmax the
// widest conv width; gp: (B, L, L). All fp32, contiguous, on the device.
extern "C" int k8_coupling_bwd(const float* x, const float* gy,
                               const float* gl, float* gx,
                               void* const* res, float* scratch0,
                               float* scratch1, float* gp, int B, int L,
                               int n_convs, const int* widths,
                               const void* const* w, int rncp, int M,
                               float s_clip, int activation, int mu, int off,
                               void* stream) {
  if (n_convs < 1 || n_convs > MAX_CONVS || L % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  Bufs bufs;
  net.n_convs = n_convs;
  int cmax = 0;
  for (int l = 0; l <= n_convs; ++l) {
    net.width[l] = widths[l];
    cmax = widths[l] > cmax ? widths[l] : cmax;
  }
  for (int l = 0; l < n_convs; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = nullptr;
    bufs.act[l] = static_cast<float*>(res[l]);
  }
  Layer ly;
  ly.L = L;
  ly.TW = tile_edge(L);
  ly.rncp = rncp;
  ly.M = M;
  ly.act = activation;
  ly.mu = mu;
  ly.off = off;
  ly.s_clip = s_clip;
  const size_t bytes = sizeof(float) * smem_layout(net, ly.TW).total;
  cudaError_t err = cudaFuncSetAttribute(
      coupling_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  coupling_bwd_kernel<<<B, THREADS, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, gy, gl, gx, net, bufs, scratch0, scratch1, gp, cmax, ly);
  return static_cast<int>(cudaGetLastError());
}
