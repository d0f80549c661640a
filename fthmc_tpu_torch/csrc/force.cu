// K1: Wilson gauge force per link, F = beta * (sin P - shifted sin P).
//
// Replaces the TPU kernel fthmc_tpu/ops/pallas_lattice.py::_force_kernel
// (pallas_force). Memory-bound: per site it reads the links it needs and
// writes two floats, a few flops each. One thread per (chain, site); each
// thread recomputes sin P at its own plaquette and at the two neighbours the
// stencil needs, so nothing is staged and no synchronisation is needed. The
// neighbouring reads hit L1/L2.
//   F0(i,j) = beta * (sin P(i,j) - sin P(i,j-1))
//   F1(i,j) = beta * (sin P(i-1,j) - sin P(i,j))
#include "common.cuh"

__global__ void force_kernel(const float* __restrict__ x,
                             float* __restrict__ f, int B, int L,
                             float beta) {
  const int LL = L * L;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * LL) return;
  const int b = static_cast<int>(idx / LL);
  const int s = static_cast<int>(idx % LL);
  const int i = s / L, j = s % L;
  const int im = (i == 0) ? L - 1 : i - 1;
  const int jm = (j == 0) ? L - 1 : j - 1;
  const float* xb = x + static_cast<size_t>(b) * 2 * LL;
  const float sp = sinf(plaq_at(xb, i, j, L));
  const float sp_jm = sinf(plaq_at(xb, i, jm, L));
  const float sp_im = sinf(plaq_at(xb, im, j, L));
  float* fb = f + static_cast<size_t>(b) * 2 * LL;
  fb[s] = beta * (sp - sp_jm);
  fb[LL + s] = beta * (sp_im - sp);
}

// x, f: (B, 2, L, L) fp32 contiguous on the current device.
extern "C" int k1_force(const float* x, float* f, int B, int L, float beta,
                        void* stream) {
  const int threads = 256;
  const long long n = static_cast<long long>(B) * L * L;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  force_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, f, B, L, beta);
  return static_cast<int>(cudaGetLastError());
}
