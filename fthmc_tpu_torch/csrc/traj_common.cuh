// The device body shared by the trajectory kernels: K2 and K3
// (leapfrog.cu) and K4 and K5 (hmc_traj.cu).
//
// Replaces the bodies of the TPU kernels _leapfrog_kernel,
// _leapfrog_cl_kernel and _hmc_traj_body (fthmc_tpu/ops/pallas_lattice.py).
// One block owns TB chains for a whole trajectory. Their links x, momenta v
// and the sin P field sit in shared memory throughout, so device memory sees
// one read of (x, v) and one write of the result a trajectory: 5 L^2 TB
// floats a block, 80 KB at L=64, TB=1, over the 48 KB default and so opted
// in to (traj_smem_bytes is what the wrappers hold against the card's
// limit). A step is two phases with a barrier after each: sin P of every
// plaquette, then kick and drift of every link. Bounded by operations
// (an accurate sinf a site a step, about 35 fp32 operations a site a step in
// all), not bytes.
//
// Shared-memory layout, in floats, element e = (d L^2 + s) TB + c for link
// direction d, site s = i L + j and chain c of the block:
//   xs[2 n], vs[2 n], sp[n] (n = L^2 TB), then 2 x threads for the sums.
// Arithmetic follows the plain twins op for op (explicit _rn intrinsics, so
// nvcc contracts nothing into an FMA the twins do not have), and sinf/cosf
// are the accurate ones: fp32 differences would grow along 25 steps.
#pragma once

#include "common.cuh"

constexpr int TRAJ_MAX_THREADS = 512;
constexpr int CL_CHAINS = 4;   // chains a K3 block holds (16-byte runs)

struct TrajArgs {
  int B, L, nstep;
  float beta, dt, hdt;   // hdt = dt / 2
};

// Threads of a block: a power of two (the tree sums), 32 to 512.
__host__ __device__ inline int traj_threads(int L, int TB) {
  const int n = L * L * TB;
  int t = 32;
  while (t < n && t < TRAJ_MAX_THREADS) t *= 2;
  return t;
}

__host__ __device__ inline int traj_smem_floats(int L, int TB) {
  return 5 * L * L * TB + 2 * traj_threads(L, TB);
}

// Bytes of dynamic shared memory one trajectory block takes, or -1 for a
// lattice the kernels do not take. The Python wrappers hold it against
// ft_smem_limit before they launch.
extern "C" int traj_smem_bytes(int L, int TB) {
  if (L < 2 || TB < 1) return -1;
  return static_cast<int>(sizeof(float)) * traj_smem_floats(L, TB);
}

// Device-memory offset of shared-memory element e of the block whose first
// chain is b0: chains-first (B, 2, L, L) or chains-last (2, L, L, B).
template <int TB, bool CHAINS_LAST>
__device__ __forceinline__ size_t field_index(int e, int b0, int B, int LL) {
  const int c = e % TB, r = e / TB;   // r = d L^2 + s
  return CHAINS_LAST ? static_cast<size_t>(r) * B + b0 + c
                     : static_cast<size_t>(b0 + c) * 2 * LL + r;
}

// Plaquette phase at element e (direction 0) of the shared-memory field.
template <int TB>
__device__ __forceinline__ float plaq_smem(const float* xs, int e, int L) {
  const int n = L * L * TB;
  const int c = e % TB, s = e / TB, i = s / L, j = s - i * L;
  const int ip = (i + 1 == L) ? 0 : i + 1;
  const int jp = (j + 1 == L) ? 0 : j + 1;
  return xs[e] + xs[n + (ip * L + j) * TB + c] - xs[(i * L + jp) * TB + c] -
         xs[n + e];
}

// The whole leapfrog trajectory on the block's shared-memory (xs, vs):
// half drift, nstep x (kick with the sin-stencil force, drift), then the
// trailing half drift undone (hmc.leapfrog).
template <int TB>
__device__ void leapfrog_smem(float* xs, float* vs, float* sp,
                              const TrajArgs& a) {
  const int L = a.L, n = L * L * TB;
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x)
    xs[e] = __fadd_rn(xs[e], __fmul_rn(a.hdt, vs[e]));
  __syncthreads();
  for (int step = 0; step < a.nstep; ++step) {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      sp[e] = sinf(plaq_smem<TB>(xs, e, L));
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int c = e % TB, s = e / TB, i = s / L, j = s - i * L;
      const int im = (i == 0 ? L : i) - 1, jm = (j == 0 ? L : j) - 1;
      const float s0 = sp[e];
      // F0 = beta (sin P - sin P(j-1)), F1 = beta (sin P(i-1) - sin P)
      const float f0 =
          __fmul_rn(a.beta, __fsub_rn(s0, sp[(i * L + jm) * TB + c]));
      const float f1 =
          __fmul_rn(a.beta, __fsub_rn(sp[(im * L + j) * TB + c], s0));
      const float v0 = __fsub_rn(vs[e], __fmul_rn(a.dt, f0));
      const float v1 = __fsub_rn(vs[n + e], __fmul_rn(a.dt, f1));
      vs[e] = v0;
      vs[n + e] = v1;
      xs[e] = __fadd_rn(xs[e], __fmul_rn(a.dt, v0));
      xs[n + e] = __fadd_rn(xs[n + e], __fmul_rn(a.dt, v1));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x)
    xs[e] = __fsub_rn(xs[e], __fmul_rn(a.hdt, vs[e]));
  __syncthreads();
}

// Sums a and b over the block (tree over red[2 blockDim]); every thread
// gets both sums.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int t = threadIdx.x, n = blockDim.x;
  red[t] = a;
  red[n + t] = b;
  __syncthreads();
  for (int h = n / 2; h > 0; h >>= 1) {
    if (t < h) {
      red[t] += red[t + h];
      red[n + t] += red[n + t + h];
    }
    __syncthreads();
  }
  a = red[0];
  b = red[n];
}

// The end of a fused HMC trajectory of chain b (K4, K5; chains-first,
// TB = 1), after leapfrog_smem left (x1, v1) in (xs, vs): delta-form
//   dH = -beta sum(cos P1 - cos P0) + 1/2 sum (v1 - v0)(v1 + v0),
// never a difference of totals; acc = u < exp(-dH); x_new = acc ?
// wrap(x1) : x0. x0b is the chain's start in device memory, v0_of(d, s) its
// starting momentum; xob is where the chain's result goes.
template <class V0>
__device__ void energy_accept(const float* xs, const float* vs, float* red,
                              const float* x0b, V0 v0_of, float u,
                              const TrajArgs& a, int b, float* xob,
                              float* dh_out, float* acc_out) {
  const int L = a.L, LL = L * L;
  float dsw = 0.f, dk = 0.f;
  for (int s = threadIdx.x; s < LL; s += blockDim.x) {
    const int i = s / L, j = s - i * L;
    dsw += __fsub_rn(cosf(plaq_smem<1>(xs, s, L)),
                     cosf(plaq_at(x0b, i, j, L)));
    for (int d = 0; d < 2; ++d) {
      const float v1 = vs[d * LL + s], v0 = v0_of(d, s);
      dk += __fmul_rn(__fsub_rn(v1, v0), __fadd_rn(v1, v0));
    }
  }
  block_sum2(dsw, dk, red);
  const float dh = __fadd_rn(__fmul_rn(-a.beta, dsw), __fmul_rn(0.5f, dk));
  const bool acc = u < expf(-dh);
  if (threadIdx.x == 0) {
    dh_out[b] = dh;
    acc_out[b] = acc ? 1.f : 0.f;
  }
  for (int e = threadIdx.x; e < 2 * LL; e += blockDim.x)
    xob[e] = acc ? wrap_pi(xs[e]) : x0b[e];
}

// Opt in to the block's shared memory and launch; returns the CUDA error.
template <class Kernel, class... Args>
int launch_traj(Kernel kernel, int blocks, int TB, const TrajArgs& a,
                void* stream, Args... args) {
  if (a.L < 2 || a.nstep < 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * traj_smem_floats(a.L, TB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, traj_threads(a.L, TB), bytes,
           static_cast<cudaStream_t>(stream)>>>(args..., a);
  return static_cast<int>(cudaGetLastError());
}

inline TrajArgs traj_args(int B, int L, float beta, float dt, float hdt,
                          int nstep) {
  TrajArgs a;
  a.B = B;
  a.L = L;
  a.nstep = nstep;
  a.beta = beta;
  a.dt = dt;
  a.hdt = hdt;
  return a;
}
