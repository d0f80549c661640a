// K6 and K7: one fused gauge-equivariant coupling layer (ncp / rncp).
//
// K6 replaces fthmc_tpu/ops/pallas_coupling.py::_ncp_kernel
// (pallas_link_coupling_forward): links -> (links', logJ).
// K7 replaces fthmc_tpu/ops/pallas_coupling_vjp.py::_fwd_res_kernel
// (pallas_link_coupling_fwd_res): the same layer, keeping as residuals every
// hidden pre-activation and the raw conditioner output (s_raw, r, t), so
// that K8 needs no conv recompute.
//
// Both are one launch of coupling_fwd_kernel, one block per chain: the
// plaquettes, the frozen-stripe cos/sin features, the circular 3x3 conv
// chain (coupling_common.cuh), the mixture transform with its logsumexp
// log-Jacobian, the link update on the active stripe and the per-chain
// logJ sum as a block reduction. The conv chain writes its activations to
// the buffers the caller passes: K7's residual outputs, or K6's two
// ping-pong scratch buffers. Bound: the conv flops the layer's outputs
// depend on (the last conv on the active stripe, the one before on its
// one-site halo: 285 MFLOP per flagship launch at 16^2 x 64 chains; the
// kernel runs all 481 MFLOP of the dense chain); bytes are far below.
#include "coupling_common.cuh"

__global__ void __launch_bounds__(THREADS)
    coupling_fwd_kernel(const float* __restrict__ x, float* __restrict__ fx,
                        float* __restrict__ logj, Net net, Bufs bufs,
                        Layer ly) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const SmemLayout sl = smem_layout(net, ly.TW);
  float* w_s = smem + sl.w;
  float* b_s = smem + sl.b;
  float* tile = smem + sl.tile;
  float* red = smem + sl.red;

  const int L = ly.L, LL = L * L;
  const int b = blockIdx.x;
  const float* xb = x + static_cast<size_t>(b) * 2 * LL;

  for (int l = 0; l < net.n_convs; ++l) {
    const int cin = net.width[l], cout = net.width[l + 1];
    float* outb = bufs.act[l] + static_cast<size_t>(b) * cout * LL;
    __syncthreads();  // the previous conv is done with the weights
    stage_weights(net.w[l], net.b[l], cin, cout, false, w_s, b_s);
    auto store = [&](int o0, int i, int j, const float(&acc)[OC]) {
#pragma unroll
      for (int k = 0; k < OC; ++k)
        if (o0 + k < cout) outb[(o0 + k) * LL + i * L + j] = acc[k];
    };
    if (l == 0) {
      // (cos, sin) of the frozen plaquettes; 0 elsewhere -> (1, 0)
      auto load = [&](int c, int i, int j) {
        const int st = stripe(i, j, ly.mu, ly.off);
        const float x2 = (st == 1 || st == 2) ? plaq_at(xb, i, j, L) : 0.f;
        return c == 0 ? cosf(x2) : sinf(x2);
      };
      conv3x3(cin, cout, w_s, b_s, tile, ly, load, store);
    } else {
      const float* inb =
          bufs.act[l - 1] + static_cast<size_t>(b) * cin * LL;
      auto load = [&](int c, int i, int j) {
        return act_fn(ly.act, inb[c * LL + i * L + j]);
      };
      conv3x3(cin, cout, w_s, b_s, tile, ly, load, store);
    }
  }
  __syncthreads();  // the last conv's outputs are visible to the block

  const int clast = net.width[net.n_convs];
  const float* raw =
      bufs.act[net.n_convs - 1] + static_cast<size_t>(b) * clast * LL;
  float* fxb = fx + static_cast<size_t>(b) * 2 * LL;
  float lsum = 0.f;
  for (int s = threadIdx.x; s < LL; s += blockDim.x) {
    const int i = s / L, j = s - (s / L) * L;
    const bool active = stripe(i, j, ly.mu, ly.off) == 0;
    const float p = plaq_at(xb, i, j, L);
    float lj;
    const float delta = transform_site(raw + s, LL, p, active, ly, &lj);
    lsum += lj;
    const float x0 = xb[s], x1 = xb[LL + s];
    fxb[s] = (active && ly.mu == 0) ? wrap_pi(delta + x0) : x0;
    fxb[LL + s] = (active && ly.mu == 1) ? wrap_pi(-delta + x1) : x1;
  }
  const float total = block_sum(lsum, red);
  if (threadIdx.x == 0) logj[b] = total;
}

// The one C entry of K6 and K7; the two differ only in the buffers passed.
// x, fx: (B, 2, L, L); logj: (B,); widths: n_convs + 1 ints (host);
// w[l]: (widths[l+1], widths[l], 3, 3), bias[l]: (widths[l+1],);
// act[l]: (B, widths[l+1], L, L) device buffers. All fp32, contiguous.
// K6: act holds scratch (any two alternating buffers of the widest size).
// K7: act[l] are the residual outputs (hidden pre-activations, then the raw
// conditioner output).
extern "C" int ft_coupling_forward(const float* x, float* fx, float* logj,
                                   void* const* act, int B, int L,
                                   int n_convs, const int* widths,
                                   const void* const* w,
                                   const void* const* bias, int rncp, int M,
                                   float s_clip, int activation, int mu,
                                   int off, void* stream) {
  if (n_convs < 1 || n_convs > MAX_CONVS || L % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  Bufs bufs;
  net.n_convs = n_convs;
  for (int l = 0; l <= n_convs; ++l) net.width[l] = widths[l];
  for (int l = 0; l < n_convs; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(bias[l]);
    bufs.act[l] = static_cast<float*>(act[l]);
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
      coupling_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  coupling_fwd_kernel<<<B, THREADS, bytes,
                        static_cast<cudaStream_t>(stream)>>>(x, fx, logj, net,
                                                             bufs, ly);
  return static_cast<int>(cudaGetLastError());
}
