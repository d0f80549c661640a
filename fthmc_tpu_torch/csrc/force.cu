// K1: Wilson gauge force per link, F = beta * (sin P - shifted sin P).
//
// Replaces the TPU kernel fthmc_tpu/ops/pallas_lattice.py::_force_kernel
// (pallas_force). Bounded by bytes: a site reads its two links and writes
// two forces, ~30 operations between (sinf the most of them).
//   F0(i,j) = beta * (sin P(i,j) - sin P(i,j-1))
//   F1(i,j) = beta * (sin P(i-1,j) - sin P(i,j))
//   P(i,j)  = x0(i,j) + x1(i+1,j) - x0(i,j+1) - x1(i,j)
//
// The band geometry of the trajectory kernels (traj_common.cuh), one force
// a launch: a CTA is a band of R rows of one chain, the grid (bands,
// chains), so nothing is divided by the chain count; the last band may be
// shorter. Thread t owns column j = t % L and a run of S rows from local
// row (t / L) S; T = G L threads, G S >= R. Each link is read from device
// memory once: x1(i+1) comes from the thread's registers inside its run
// and by one load (a neighbouring thread's row, hot in L1/L2) below it;
// x0(j+1) from the neighbouring column through shared memory. sin P is
// computed once a site and published; sin P(j-1) is the neighbouring
// column's, sin P(i-1) the thread's own register, the run above's or, for
// the band's first row, the halo row r0 - 1, which the first run's
// threads recompute (one sinf a column a band): no barrier between CTAs.
// Two __syncthreads a launch. The arithmetic is the twin's op for op (_rn
// intrinsics, the accurate sinf), so K1 can be bit-equal to it. The plan
// (R, T, S) is chosen in Python (ops/lattice_kernels.force_plan).
#include "common.cuh"

constexpr int K1_MAX_THREADS = 1024;
constexpr int K1_MAX_CHAINS = 65535;   // gridDim.y; more chains: more grids

__host__ __device__ inline bool k1_sites_ok(int S) {
  return S == 1 || S == 2 || S == 4 || S == 8;
}

// Bytes of dynamic shared memory a K1 CTA takes: x0 of the band's R rows
// and sin P of the halo row and the R rows, (2 R + 1) L floats; -1 for a
// plan the kernel does not take.
extern "C" int force_smem_bytes(int L, int rows, int threads, int sites) {
  if (L < 2 || rows < 1 || rows > L || !k1_sites_ok(sites) ||
      threads < L || threads % L != 0 || threads > K1_MAX_THREADS ||
      (threads / L) * sites < rows)
    return -1;
  return static_cast<int>(sizeof(float)) * (2 * rows + 1) * L;
}

// FULL: every band has R = G S rows, so every run is whole and the sites
// need no predicate.
template <int S, bool FULL>
__global__ void __launch_bounds__(K1_MAX_THREADS)
    force_band_kernel(const float* __restrict__ x, float* __restrict__ f,
                      int L, int R, float beta) {
  extern __shared__ float4 smem4[];
  float* xs0 = reinterpret_cast<float*>(smem4);   // [local row][column]
  float* sps = xs0 + R * L;   // [local row + 1][column], row 0 the halo
  const int LL = L * L;
  const int r0 = blockIdx.x * R, rows = min(R, L - r0);
  const int t = threadIdx.x, j = t % L, g0 = (t / L) * S;
  const int jp = j + 1 == L ? 0 : j + 1, jm = (j == 0 ? L : j) - 1;
  const int nv = FULL ? S : min(max(rows - g0, 0), S);
  const size_t off = static_cast<size_t>(blockIdx.y) * 2 * LL;
  const float* x0g = x + off;
  const float* x1g = x0g + LL;
  const int s0 = (r0 + g0) * L + j;   // the run's first site
  float x0[S], x1[S], sp[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    x0[k] = x1[k] = 0.f;
    if (FULL || k < nv) {
      x0[k] = x0g[s0 + k * L];
      x1[k] = x1g[s0 + k * L];
      xs0[(g0 + k) * L + j] = x0[k];
    }
  }
  // x1 of the row below the run, and the halo row's sin P
  float below = 0.f;
  if (FULL || nv > 0) {
    const int rb = r0 + g0 + nv == L ? 0 : r0 + g0 + nv;
    below = x1g[rb * L + j];
    if (g0 == 0) {
      const int rh = (r0 == 0 ? L : r0) - 1;
      sps[j] = sinf(x0g[rh * L + j] + x1[0] - x0g[rh * L + jp] -
                    x1g[rh * L + j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < nv) {
      const float xn = (k + 1 < S && (FULL || k + 1 < nv))
                           ? x1[k + 1 < S ? k + 1 : k]
                           : below;
      sp[k] = sinf(x0[k] + xn - xs0[(g0 + k) * L + jp] - x1[k]);
      sps[(g0 + k + 1) * L + j] = sp[k];
    }
  }
  __syncthreads();
  float* f0g = f + off;
  float* f1g = f0g + LL;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (FULL || k < nv) {
      const float sa = k == 0 ? sps[g0 * L + j] : sp[k > 0 ? k - 1 : 0];
      f0g[s0 + k * L] =
          __fmul_rn(beta, __fsub_rn(sp[k], sps[(g0 + k + 1) * L + jm]));
      f1g[s0 + k * L] = __fmul_rn(beta, __fsub_rn(sa, sp[k]));
    }
  }
}

// Opts the instance in to `bytes` of dynamic shared memory once a device
// where it needs more than the default 48 KB (the carveout is left alone:
// K1 reads its neighbour rows through L1).
template <int S, bool FULL>
static cudaError_t k1_opt_in(int bytes) {
  static int set_bytes[64];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= set_bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(force_band_kernel<S, FULL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set_bytes[dev] = bytes;
  return err;
}

template <int S, bool FULL>
static int k1_launch(const float* x, float* f, int B, int L, int R,
                     int threads, int bytes, float beta,
                     cudaStream_t stream) {
  const cudaError_t err = k1_opt_in<S, FULL>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bands = (L + R - 1) / R;
  const size_t chain = static_cast<size_t>(2) * L * L;
  for (int b0 = 0; b0 < B; b0 += K1_MAX_CHAINS) {
    const int n = B - b0 < K1_MAX_CHAINS ? B - b0 : K1_MAX_CHAINS;
    force_band_kernel<S, FULL><<<dim3(bands, n), threads, bytes, stream>>>(
        x + b0 * chain, f + b0 * chain, L, R, beta);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// x, f: (B, 2, L, L) fp32 contiguous on the current device; (rows,
// threads, sites): the band plan.
extern "C" int k1_force(const float* x, float* f, int B, int L, float beta,
                        int rows, int threads, int sites, void* stream) {
  const int bytes = force_smem_bytes(L, rows, threads, sites);
  if (B < 1 || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool full = L % rows == 0 && rows == threads / L * sites;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_CASE(S)                                                       \
  case S:                                                                \
    return full ? k1_launch<S, true>(x, f, B, L, rows, threads, bytes,   \
                                     beta, st)                           \
                : k1_launch<S, false>(x, f, B, L, rows, threads, bytes,  \
                                      beta, st);
  switch (sites) {
    K1_CASE(1)
    K1_CASE(2)
    K1_CASE(4)
    K1_CASE(8)
  }
#undef K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
