// K2 and K3: the whole leapfrog trajectory of a batch of chains in one
// launch.
//
// K2 replaces fthmc_tpu/ops/pallas_lattice.py::_leapfrog_kernel
// (pallas_leapfrog), chains-first (B, 2, L, L): one block a chain.
// K3 replaces _leapfrog_cl_kernel (pallas_leapfrog_cl), chains-last
// (2, L, L, B) with the transposes at the tensor boundary (the wrapper):
// one block holds CL_CHAINS consecutive chains, which neighbouring threads
// read as 16-byte runs; shared memory is laid out with the chain fastest.
// Both run the device body of traj_common.cuh; see there for the design and
// what bounds it.
#include "traj_common.cuh"

template <int TB, bool CHAINS_LAST>
__global__ void leapfrog_kernel(const float* __restrict__ x,
                                const float* __restrict__ v,
                                float* __restrict__ xo,
                                float* __restrict__ vo, TrajArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int LL = a.L * a.L, n = LL * TB;
  float* vs = xs + 2 * n;
  float* sp = vs + 2 * n;
  const int b0 = blockIdx.x * TB;
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    const size_t g = field_index<TB, CHAINS_LAST>(e, b0, a.B, LL);
    xs[e] = x[g];
    vs[e] = v[g];
  }
  __syncthreads();
  leapfrog_smem<TB>(xs, vs, sp, a);
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    const size_t g = field_index<TB, CHAINS_LAST>(e, b0, a.B, LL);
    xo[g] = xs[e];
    vo[g] = vs[e];
  }
}

// x, v, xo, vo: (B, 2, L, L) fp32 contiguous.
extern "C" int k2_leapfrog(const float* x, const float* v, float* xo,
                           float* vo, int B, int L, float beta, float dt,
                           float hdt, int nstep, void* stream) {
  return launch_traj(leapfrog_kernel<1, false>, B, 1,
                     traj_args(B, L, beta, dt, hdt, nstep), stream, x, v, xo,
                     vo);
}

// x, v, xo, vo: (2, L, L, B) fp32 contiguous, B a multiple of CL_CHAINS.
extern "C" int k3_leapfrog_cl(const float* x, const float* v, float* xo,
                              float* vo, int B, int L, float beta, float dt,
                              float hdt, int nstep, void* stream) {
  if (B % CL_CHAINS != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_traj(leapfrog_kernel<CL_CHAINS, true>, B / CL_CHAINS,
                     CL_CHAINS, traj_args(B, L, beta, dt, hdt, nstep),
                     stream, x, v, xo, vo);
}

extern "C" int k3_chains_per_block() { return CL_CHAINS; }
