// Shared device helpers of the port's CUDA kernels: angle wrapping, the
// plaquette of a chains-first link field and the stripe masks.
//
// Fields are chains-first fp32: x[b][d][i][j] with d the link direction,
// i the 0-direction coordinate (rows) and j the 1-direction (columns).
// Plaquette convention of fthmc_tpu_torch/lattice.py:
//   P(i,j) = x0(i,j) + x1(i+1,j) - x0(i,j+1) - x1(i,j)   (periodic).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FT_PI 3.14159265358979323846f
#define FT_TWO_PI 6.28318530717958647692f

// Floor-mod wrap to [-pi, pi): the sign follows the divisor, as
// torch.remainder and jnp.remainder do (fmodf alone keeps the sign of v).
__device__ __forceinline__ float wrap_pi(float v) {
  float r = fmodf(v + FT_PI, FT_TWO_PI);
  if (r < 0.f) r += FT_TWO_PI;
  return r - FT_PI;
}

__device__ __forceinline__ float plaq_at(const float* xb, int i, int j,
                                         int L) {
  const int ip = (i + 1 == L) ? 0 : i + 1;
  const int jp = (j + 1 == L) ? 0 : j + 1;
  const float* x0 = xb;
  const float* x1 = xb + L * L;
  return x0[i * L + j] + x1[ip * L + j] - x0[i * L + jp] - x1[i * L + j];
}

// Stripe of a site in coupling layer (mu, off), L a multiple of 4:
// 0 active, 1 and 2 frozen, 3 passive (fthmc_tpu_torch/models/masks.py).
__device__ __forceinline__ int stripe(int i, int j, int mu, int off) {
  const int coord = (mu == 0) ? j : i;
  return ((coord - off) % 4 + 4) % 4;
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
