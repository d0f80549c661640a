// K9, K10 and K11: the Wilson-Dirac normal operator on packed real planes
// and the CG iteration's vector update.
//
// K9 replaces fthmc_tpu/ops/pallas_fermion.py::_mdagm_kernel (_mdagm_call,
// pallas_mdagm layout 'cf'): chains-first planes p (B, 4, L0, L1)
// [Re s0, Im s0, Re s1, Im s1], links ur, ui (B, 2, L0, L1) with the
// antiperiodic time sign folded in. One block a chain. Where they fit
// (12 L0 L1 floats: L0 L1 <= 4,842 on an H100, so 64^2 at 192 KB) the
// chain's input, hop temporary and links sit in opted-in shared memory and
// device memory sees one read of (p, links) and one write of the result;
// beyond, the two 4-plane buffers go to a scratch buffer the wrapper
// allocates and the links are read from device memory.
// K10 replaces _mdagm_cl_kernel (_mdagm_call_cl): chains-last planes
// (4, L0, L1, B), links (2, L0, L1, B); one thread a (site, chain), chain
// fastest, so a warp reads 32 consecutive chains' values of one site. The
// hops of different sites meet only across the whole grid, so K10 is one
// launch a hop pass (2 or 4), its intermediates in a scratch buffer.
// K11 replaces the body of cg_solve_fused's while_loop: one block a chain,
// both reductions a fixed-order tree inside the block (deterministic, one
// launch an iteration), element e of chain c at e * stride_e + c *
// stride_c, so it serves both layouts.
//
// Operator (fthmc_tpu_torch/ops/fermion_kernels.py, normal_op_planes):
//   eo:  Dhat s = a s - b even * H(odd * H s),  a = m + 2, b = 1 / (4 a)
//   not: D s    = a s - H s / 2
//   out = g5 D g5 D s   (g5 negates planes 2 and 3)
// as hop passes with a barrier between them:
//   eo:  T = odd H(S);  S = g5(a S - b even H(T));  T = odd H(S);
//        out = g5(a S - b even H(T))
//   not: T = g5(a S - H(S) / 2);  out = g5(a T - H(T) / 2)
// H per site is hop_site below, the twins' hop_planes op for op with
// explicit _rn intrinsics (nvcc contracts nothing into an FMA the twins
// lack), so K9 and K10 repeat their twins' arithmetic exactly.
//
// Bounds: K9 and K10 must read p and four link planes and write four
// planes, 48 bytes a site a chain (12.6 MB at 64^2, B=64: 3.8 us at
// 3.35 TB/s); their arithmetic is 112 flops a site (each eo hop pass 44
// on half the sites, each combine 12 on all), 0.44 us at 67 TFLOP/s. K11 reads p, Mp, x, r and writes x, r, p, 112 bytes a site
// a chain (29.4 MB, 8.8 us). All three are bound by bytes; what the design
// does about it is to keep a chain's intermediates on the chip (K9) and to
// make every global access coalesced (K10, K11).
#include "common.cuh"

namespace {

constexpr int K9_MAX_THREADS = 1024;
constexpr int K10_THREADS = 256;
constexpr int K11_THREADS = 1024;

enum PassKind { ODD_HOP = 0, EO_COMBINE = 1, PLAIN_COMBINE = 2 };

// Element (plane k, row i, column j) of one chain's planes, in floats.
struct Idx {
  long long plane, row, col;
  __device__ __forceinline__ long long operator()(int k, int i, int j) const {
    return k * plane + i * row + j * col;
  }
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// h = (H s)(i, j): the four hop directions in hop_planes' order.
__device__ __forceinline__ void hop_site(const float* s, const float* ur,
                                         const float* ui, const Idx& ix,
                                         int i, int j, int L0, int L1,
                                         float h[4]) {
  const int ip = (i + 1 == L0) ? 0 : i + 1, im = (i == 0 ? L0 : i) - 1;
  const int jp = (j + 1 == L1) ? 0 : j + 1, jm = (j == 0 ? L1 : j) - 1;
  // forward 0: u0(n) psi(n + e0), (d, -d), d = t0 - t1
  float dr = sub(s[ix(0, ip, j)], s[ix(2, ip, j)]);
  float di = sub(s[ix(1, ip, j)], s[ix(3, ip, j)]);
  float u_r = ur[ix(0, i, j)], u_i = ui[ix(0, i, j)];
  float mr = sub(mul(u_r, dr), mul(u_i, di));
  float mi = add(mul(u_r, di), mul(u_i, dr));
  float h0r = mr, h0i = mi, h1r = -mr, h1i = -mi;
  // backward 0: conj(u0(n - e0)) psi(n - e0), (e, e), e = s0 + s1
  dr = add(s[ix(0, im, j)], s[ix(2, im, j)]);
  di = add(s[ix(1, im, j)], s[ix(3, im, j)]);
  u_r = ur[ix(0, im, j)];
  u_i = ui[ix(0, im, j)];
  mr = add(mul(u_r, dr), mul(u_i, di));
  mi = sub(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = add(h1r, mr);
  h1i = add(h1i, mi);
  // forward 1: u1(n) psi(n + e1), (w, -i w), w = t0 + i t1
  dr = sub(s[ix(0, i, jp)], s[ix(3, i, jp)]);
  di = add(s[ix(1, i, jp)], s[ix(2, i, jp)]);
  u_r = ur[ix(1, i, j)];
  u_i = ui[ix(1, i, j)];
  mr = sub(mul(u_r, dr), mul(u_i, di));
  mi = add(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = add(h1r, mi);
  h1i = sub(h1i, mr);
  // backward 1: conj(u1(n - e1)) psi(n - e1), (v, i v), v = s0 - i s1
  dr = add(s[ix(0, i, jm)], s[ix(3, i, jm)]);
  di = sub(s[ix(1, i, jm)], s[ix(2, i, jm)]);
  u_r = ur[ix(1, i, jm)];
  u_i = ui[ix(1, i, jm)];
  mr = add(mul(u_r, dr), mul(u_i, di));
  mi = sub(mul(u_r, di), mul(u_i, dr));
  h0r = add(h0r, mr);
  h0i = add(h0i, mi);
  h1r = sub(h1r, mi);
  h1i = add(h1i, mr);
  h[0] = h0r;
  h[1] = h0i;
  h[2] = h1r;
  h[3] = h1i;
}

// One site of a hop pass: hop of hsrc, combined with self per KIND, to dst.
template <int KIND>
__device__ __forceinline__ void pass_site(const float* hsrc, const float* self,
                                          float* dst, const float* ur,
                                          const float* ui, const Idx& ix,
                                          int i, int j, int L0, int L1,
                                          float a, float b) {
  const bool even = ((i + j) & 1) == 0;
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  if (KIND == PLAIN_COMBINE || (KIND == ODD_HOP) != even)
    hop_site(hsrc, ur, ui, ix, i, j, L0, L1, h);
  if (KIND == ODD_HOP) {
    for (int k = 0; k < 4; ++k) dst[ix(k, i, j)] = h[k];
    return;
  }
  const float c = (KIND == EO_COMBINE) ? b : 0.5f;
  for (int k = 0; k < 4; ++k) {
    const float v = sub(mul(a, self[ix(k, i, j)]), mul(c, h[k]));
    dst[ix(k, i, j)] = k < 2 ? v : -v;   // g5
  }
}

// A K9 pass over the chain's sites, then a barrier.
template <int KIND>
__device__ void k9_pass(const float* hsrc, const float* self, float* dst,
                        const float* ur, const float* ui, const Idx& ix,
                        int L0, int L1, float a, float b) {
  const int n = L0 * L1;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int i = s / L1, j = s - i * L1;
    pass_site<KIND>(hsrc, self, dst, ur, ui, ix, i, j, L0, L1, a, b);
  }
  __syncthreads();
}

// scratch == nullptr: the chain's S, T and links in shared memory (12 n
// floats); else S and T at scratch + 8 n c, links read in place.
__global__ void __launch_bounds__(K9_MAX_THREADS)
    k9_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
              const float* __restrict__ p, float* __restrict__ out,
              float* scratch, int L0, int L1, float a, float b, int eo) {
  extern __shared__ float4 smem4[];
  const int n = L0 * L1, c = blockIdx.x;
  const size_t off4 = static_cast<size_t>(c) * 4 * n;
  const size_t off2 = static_cast<size_t>(c) * 2 * n;
  float *S, *T;
  const float *UR, *UI;
  if (scratch == nullptr) {
    float* sm = reinterpret_cast<float*>(smem4);
    S = sm;
    T = sm + 4 * n;
    float* urs = sm + 8 * n;
    float* uis = sm + 10 * n;
    for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
      urs[e] = ur[off2 + e];
      uis[e] = ui[off2 + e];
    }
    UR = urs;
    UI = uis;
  } else {
    S = scratch + static_cast<size_t>(c) * 8 * n;
    T = S + 4 * n;
    UR = ur + off2;
    UI = ui + off2;
  }
  for (int e = threadIdx.x; e < 4 * n; e += blockDim.x) S[e] = p[off4 + e];
  __syncthreads();
  const Idx ix{n, L1, 1};
  float* o = out + off4;
  if (eo) {
    k9_pass<ODD_HOP>(S, nullptr, T, UR, UI, ix, L0, L1, a, b);
    k9_pass<EO_COMBINE>(T, S, S, UR, UI, ix, L0, L1, a, b);  // S in place
    k9_pass<ODD_HOP>(S, nullptr, T, UR, UI, ix, L0, L1, a, b);
    k9_pass<EO_COMBINE>(T, S, o, UR, UI, ix, L0, L1, a, b);
  } else {
    k9_pass<PLAIN_COMBINE>(S, S, T, UR, UI, ix, L0, L1, a, b);
    k9_pass<PLAIN_COMBINE>(T, T, o, UR, UI, ix, L0, L1, a, b);
  }
}

int k9_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < K9_MAX_THREADS ? t : K9_MAX_THREADS;
}

// One K10 pass: thread t is chain t % B of site t / B.
template <int KIND>
__global__ void __launch_bounds__(K10_THREADS)
    k10_pass(const float* hsrc, const float* self, float* dst,
             const float* __restrict__ ur, const float* __restrict__ ui,
             int B, int L0, int L1, float a, float b) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(L0) * L1 * B) return;
  const int c = static_cast<int>(t % B), s = static_cast<int>(t / B);
  const int i = s / L1, j = s - i * L1;
  const Idx ix{static_cast<long long>(L0) * L1 * B,
               static_cast<long long>(L1) * B, B};
  pass_site<KIND>(hsrc + c, self == nullptr ? nullptr : self + c, dst + c,
                  ur + c, ui + c, ix, i, j, L0, L1, a, b);
}

// Sum over the block, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(K11_THREADS)
    k11_kernel(float* p, const float* __restrict__ mp, float* x, float* r,
               float* rsq, const float* __restrict__ stop, int* counters,
               int n_elem, long long stride_e, long long stride_c, int it) {
  __shared__ float red[33];
  const int c = blockIdx.x;
  const long long base = c * stride_c;
  const float rs = rsq[c], st = stop[c];
  const bool active = rs > st;
  float acc = 0.f;
  for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
    const long long g = base + e * stride_e;
    acc = add(acc, mul(p[g], mp[g]));
  }
  const float denom = block_sum(acc, red);
  const float alpha = active ? rs / fmaxf(denom, 1e-30f) : 0.f;
  acc = 0.f;
  for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
    const long long g = base + e * stride_e;
    const float pv = p[g];
    x[g] = add(x[g], mul(alpha, pv));
    const float rv = sub(r[g], mul(alpha, mp[g]));
    r[g] = rv;
    acc = add(acc, mul(rv, rv));
  }
  const float rsq_new = block_sum(acc, red);
  const float beta = active ? rsq_new / fmaxf(rs, 1e-30f) : 0.f;
  for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
    const long long g = base + e * stride_e;
    p[g] = add(r[g], mul(beta, p[g]));
  }
  if (threadIdx.x == 0) {
    rsq[c] = active ? rsq_new : rs;
    if (active) atomicMax(counters, it + 1);
    if (active && rsq_new > st) atomicMax(counters + 1, it + 1);
  }
}

bool sides_ok(int L0, int L1) {
  return L0 >= 4 && L1 >= 4 && L0 % 2 == 0 && L1 % 2 == 0;
}

}  // namespace

// Bytes of dynamic shared memory K9 takes with the chain on the chip, or
// -1 for sides the kernels do not take.
extern "C" int k9_smem_bytes(int L0, int L1) {
  if (!sides_ok(L0, L1)) return -1;
  return static_cast<int>(sizeof(float)) * 12 * L0 * L1;
}

// ur, ui: (B, 2, L0, L1); p, out: (B, 4, L0, L1); fp32 contiguous.
// scratch: nullptr (chain in shared memory, which must fit) or 8 B L0 L1
// floats. a = m + 2, b = 1 / (4 a).
extern "C" int k9_mdagm(const float* ur, const float* ui, const float* p,
                        float* out, float* scratch, int B, int L0, int L1,
                        float a, float b, int eo, void* stream) {
  if (B < 1 || !sides_ok(L0, L1))
    return static_cast<int>(cudaErrorInvalidValue);
  int bytes = 0;
  if (scratch == nullptr) {
    bytes = k9_smem_bytes(L0, L1);
    const cudaError_t err = cudaFuncSetAttribute(
        k9_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k9_kernel<<<B, k9_threads(L0 * L1), bytes,
              static_cast<cudaStream_t>(stream)>>>(ur, ui, p, out, scratch,
                                                   L0, L1, a, b, eo);
  return static_cast<int>(cudaGetLastError());
}

// ur, ui: (2, L0, L1, B); p, out: (4, L0, L1, B); scratch: 8 L0 L1 B
// floats (T, then S); fp32 contiguous. 2 (not eo) or 4 (eo) launches.
extern "C" int k10_mdagm_cl(const float* ur, const float* ui, const float* p,
                            float* out, float* scratch, int B, int L0,
                            int L1, float a, float b, int eo, void* stream) {
  if (B < 1 || !sides_ok(L0, L1) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(L0) * L1 * B;
  const int blocks = static_cast<int>((total + K10_THREADS - 1) / K10_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* T = scratch;
  float* S = scratch + 4 * total;
  if (eo) {
    k10_pass<ODD_HOP><<<blocks, K10_THREADS, 0, st>>>(p, nullptr, T, ur, ui,
                                                      B, L0, L1, a, b);
    k10_pass<EO_COMBINE><<<blocks, K10_THREADS, 0, st>>>(T, p, S, ur, ui, B,
                                                         L0, L1, a, b);
    k10_pass<ODD_HOP><<<blocks, K10_THREADS, 0, st>>>(S, nullptr, T, ur, ui,
                                                      B, L0, L1, a, b);
    k10_pass<EO_COMBINE><<<blocks, K10_THREADS, 0, st>>>(T, S, out, ur, ui,
                                                         B, L0, L1, a, b);
  } else {
    k10_pass<PLAIN_COMBINE><<<blocks, K10_THREADS, 0, st>>>(p, p, T, ur, ui,
                                                            B, L0, L1, a, b);
    k10_pass<PLAIN_COMBINE><<<blocks, K10_THREADS, 0, st>>>(T, T, out, ur, ui,
                                                            B, L0, L1, a, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// One CG iteration's update of B chains in place, after mp = M p. Element e
// of chain c at e * stride_e + c * stride_c (chains-first: 1, n_elem;
// chains-last: B, 1). rsq, stop: (B,); counters: int32 (2,), see
// cg_update_plain.
extern "C" int k11_cg_update(float* p, const float* mp, float* x, float* r,
                             float* rsq, const float* stop, int* counters,
                             int B, int n_elem, int stride_e, int stride_c,
                             int it, void* stream) {
  if (B < 1 || n_elem < 1) return static_cast<int>(cudaErrorInvalidValue);
  k11_kernel<<<B, K11_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, mp, x, r, rsq, stop, counters, n_elem, stride_e, stride_c, it);
  return static_cast<int>(cudaGetLastError());
}
