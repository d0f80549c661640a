// K4 and K5: one fused HMC trajectory of a batch of chains in one launch:
// the leapfrog trajectory, the delta-form energy difference, the Metropolis
// accept and the wrap, chains-first (B, 2, L, L), one block a chain.
//
// K4 replaces fthmc_tpu/ops/pallas_lattice.py::_hmc_traj_kernel
// (pallas_hmc_traj): the momenta and the accept draw come from the
// in-kernel Philox4x32-10 stream (philox.cuh) keyed by (seed, chain), the
// seed read from device memory so the caller never syncs. The momenta are
// drawn again at the end instead of kept: shared memory stays at the 80 KB
// of K2 (two blocks an SM at L=64), at the cost of one more draw a link.
// K5 replaces _hmc_traj_hostrng_kernel (pallas_hmc_traj_hostrng): the same
// with the caller's momenta v0 and accept draws u.
// Both share _hmc_traj_body's counterpart: leapfrog_smem and energy_accept
// (traj_common.cuh), where the design and what bounds it are described.
#include "philox.cuh"
#include "traj_common.cuh"

__global__ void hmc_traj_kernel(const float* __restrict__ x,
                                const int* __restrict__ seed,
                                float* __restrict__ xo,
                                float* __restrict__ dh,
                                float* __restrict__ acc, TrajArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int LL = a.L * a.L, b = blockIdx.x;
  float* vs = xs + 2 * LL;
  float* sp = vs + 2 * LL;
  float* red = sp + LL;
  const uint32_t sd = static_cast<uint32_t>(*seed);
  const float* xb = x + static_cast<size_t>(b) * 2 * LL;
  auto v0_of = [&](int d, int s) { return momentum_draw(sd, b, d, s); };
  for (int e = threadIdx.x; e < 2 * LL; e += blockDim.x) {
    xs[e] = xb[e];
    vs[e] = v0_of(e / LL, e % LL);
  }
  __syncthreads();
  leapfrog_smem<1>(xs, vs, sp, a);
  energy_accept(xs, vs, red, xb, v0_of, accept_draw(sd, b), a, b,
                xo + static_cast<size_t>(b) * 2 * LL, dh, acc);
}

__global__ void hmc_traj_hostrng_kernel(const float* __restrict__ x,
                                        const float* __restrict__ v0,
                                        const float* __restrict__ u,
                                        float* __restrict__ xo,
                                        float* __restrict__ dh,
                                        float* __restrict__ acc,
                                        TrajArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int LL = a.L * a.L, b = blockIdx.x;
  float* vs = xs + 2 * LL;
  float* sp = vs + 2 * LL;
  float* red = sp + LL;
  const float* xb = x + static_cast<size_t>(b) * 2 * LL;
  const float* vb = v0 + static_cast<size_t>(b) * 2 * LL;
  for (int e = threadIdx.x; e < 2 * LL; e += blockDim.x) {
    xs[e] = xb[e];
    vs[e] = vb[e];
  }
  __syncthreads();
  leapfrog_smem<1>(xs, vs, sp, a);
  energy_accept(
      xs, vs, red, xb, [&](int d, int s) { return vb[d * LL + s]; }, u[b],
      a, b, xo + static_cast<size_t>(b) * 2 * LL, dh, acc);
}

// x, xo: (B, 2, L, L); dh, acc: (B,); seed: one int32; fp32 contiguous.
extern "C" int k4_hmc_traj(const float* x, const int* seed, float* xo,
                           float* dh, float* acc, int B, int L, float beta,
                           float dt, float hdt, int nstep, void* stream) {
  return launch_traj(hmc_traj_kernel, B, 1,
                     traj_args(B, L, beta, dt, hdt, nstep), stream, x, seed,
                     xo, dh, acc);
}

// x, v0, xo: (B, 2, L, L); u, dh, acc: (B,); fp32 contiguous.
extern "C" int k5_hmc_traj_hostrng(const float* x, const float* v0,
                                   const float* u, float* xo, float* dh,
                                   float* acc, int B, int L, float beta,
                                   float dt, float hdt, int nstep,
                                   void* stream) {
  return launch_traj(hmc_traj_hostrng_kernel, B, 1,
                     traj_args(B, L, beta, dt, hdt, nstep), stream, x, v0,
                     u, xo, dh, acc);
}
