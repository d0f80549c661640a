// Shared device helpers of the port's CUDA kernels: angle wrapping, the
// plaquette of a chains-first link field, the stripe masks, the band
// geometry of the cluster kernels (K6-K10) with their launch, cp.async
// helpers, and the C entries every library carries (error strings, the
// shared-memory limit).
//
// Fields are chains-first fp32: x[b][d][i][j] with d the link direction,
// i the 0-direction coordinate (rows) and j the 1-direction (columns).
// Plaquette convention of fthmc_tpu_torch/lattice.py:
//   P(i,j) = x0(i,j) + x1(i+1,j) - x0(i,j+1) - x1(i,j)   (periodic).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <utility>

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

// Band geometry of the cluster kernels. A group of work (a chain, or a
// tile of chains) is one thread-block cluster of C CTAs, C <= MAX_BANDS
// (the portable cluster limit); CTA rank r owns rows [row0[r], row0[r + 1])
// of the lattice, row0[0] = 0, row0[C] = L. The Python wrappers choose the
// plan, so the CPU tests reach it.
constexpr int MAX_BANDS = 8;

struct Bands {
  int C;
  int row0[MAX_BANDS + 1];
};

// Copies a plan (C, row0[C + 1]) into bands and its largest band's rows
// into R; false for a plan that is not a partition of [0, L) into C bands.
__host__ inline bool bands_from(int C, const int* row0, int L, int* R,
                                Bands* bands) {
  if (C < 1 || C > MAX_BANDS || row0[0] != 0 || row0[C] != L) return false;
  bands->C = C;
  *R = 0;
  for (int r = 0; r <= C; ++r) {
    bands->row0[r] = row0[r];
    if (r > 0) {
      const int h = row0[r] - row0[r - 1];
      if (h < 1) return false;
      *R = h > *R ? h : *R;
    }
  }
  return true;
}

// Sets the kernel's dynamic shared-memory opt-in when a launch needs more
// than was set on this device before (not on every launch), and, the first
// time, the largest shared-memory carveout (the default may hold fewer CTAs
// an SM than their shared memory allows).
template <class Kernel>
cudaError_t ensure_smem(Kernel kernel, int bytes, int* set_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= set_bytes[dev]) return cudaSuccess;
  if (set_bytes[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set_bytes[dev] = bytes;
  return err;
}

// A cluster launch of groups * C CTAs of `threads` threads, C a cluster; a
// refused launch returns its error (and clears it from cudaGetLastError).
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int groups, int C,
                            int threads, int bytes, void* stream,
                            Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block may opt in to on the device, or -1.
extern "C" int ft_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
