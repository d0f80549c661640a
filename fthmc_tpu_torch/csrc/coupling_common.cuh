// Device code shared by the coupling-layer kernels K6/K7 (coupling_fwd.cu)
// and K8 (coupling_bwd.cu): the conditioner's circular 3x3 conv, staged
// through shared memory, and the per-site mixture transform of ncp / rncp.
//
// One thread block owns one chain for a whole coupling layer. The conv
// chain streams layer by layer through device memory (the hidden
// pre-activations are K7's residual outputs anyway; K6 and K8 use scratch
// buffers), so any lattice size works: each conv walks the lattice in
// TW x TW tiles, stages the tile plus a one-site halo of every input
// channel in shared memory, and each thread accumulates OC output channels
// of one site in registers. The layer's weights sit in shared memory as
// w_s[(c * 9 + tap) * cpad + o], cpad = Cout rounded up to OC, so a thread
// reads its OC weights of one (c, tap) as two float4 broadcasts.
#pragma once

#include "common.cuh"

constexpr int MAX_CONVS = 8;   // conv layers per conditioner
constexpr int OC = 8;          // output channels per thread work item
constexpr int THREADS = 256;   // threads per block (one chain)
constexpr int TILE = 16;       // largest tile edge
constexpr float HARD_CLIP = 30.f;
constexpr float TINY = 1e-30f;

enum Activation { ACT_RELU = 0, ACT_SILU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

// The conditioner of one coupling layer: widths[0] = 2 (cos, sin),
// widths[n_convs] = Cout of the last conv; w[l] is (Cout, Cin, 3, 3).
struct Net {
  int n_convs;
  int width[MAX_CONVS + 1];
  const float* w[MAX_CONVS];
  const float* b[MAX_CONVS];
};

// Per-conv activation buffers, each (B, width[l + 1], L, L).
struct Bufs {
  float* act[MAX_CONVS];
};

struct Layer {
  int L;        // lattice edge, a multiple of 4
  int TW;       // tile edge, min(L, TILE)
  int rncp;     // 1: rotated mixture, 0: ncp
  int M;        // mixture components
  int act;      // Activation
  int mu, off;  // mask parameters of this layer
  float s_clip; // <= 0: no smooth clip
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

inline int tile_edge(int L) { return L < TILE ? L : TILE; }

__device__ __forceinline__ float act_fn(int a, float v) {
  switch (a) {
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_SILU: return v / (1.f + expf(-v));
    case ACT_LEAKY: return v > 0.f ? v : 0.01f * v;
    default: return tanhf(v);
  }
}

__device__ __forceinline__ float act_grad(int a, float v) {
  switch (a) {
    case ACT_RELU: return v > 0.f ? 1.f : 0.f;
    case ACT_SILU: {
      const float sg = 1.f / (1.f + expf(-v));
      return sg * (1.f + v * (1.f - sg));
    }
    case ACT_LEAKY: return v > 0.f ? 1.f : 0.01f;
    default: {
      const float t = tanhf(v);
      return 1.f - t * t;
    }
  }
}

// Offsets (in floats) of the regions of a block's dynamic shared memory:
// the largest conv's weights and bias, its largest haloed input tile, and
// THREADS floats for the logJ sum. The backward convs run with Cin and Cout
// swapped, so both ways are sized. Used by the launches (size), the device
// (carving) and, through ft_smem_bytes, the Python envelope check, so none
// of them can disagree.
struct SmemLayout {
  int w, b, tile, red, total;
};

__host__ __device__ inline SmemLayout smem_layout(const Net& net, int TW) {
  int wmax = 0, bmax = 0, tmax = 0;
  for (int l = 0; l < net.n_convs; ++l) {
    const int ci = net.width[l], co = net.width[l + 1];
    const int fw = ci * 9 * round_up(co, OC), bw = co * 9 * round_up(ci, OC);
    const int c = ci > co ? ci : co;
    const int tl = c * (TW + 2) * (TW + 2);
    wmax = fw > wmax ? fw : wmax;
    wmax = bw > wmax ? bw : wmax;
    bmax = round_up(c, OC) > bmax ? round_up(c, OC) : bmax;
    tmax = tl > tmax ? tl : tmax;
  }
  SmemLayout s;
  s.w = 0;
  s.b = wmax;
  s.tile = round_up(wmax + bmax, 4);
  s.red = s.tile + round_up(tmax, 4);
  s.total = s.red + THREADS;
  return s;
}

// Bytes of dynamic shared memory one K6/K7/K8 block takes for a conditioner
// of n_convs convs of the given widths (n_convs + 1 ints) at lattice edge L,
// or -1 for a conditioner or lattice the kernels do not take. The Python
// wrappers hold it against ft_smem_limit before they launch.
extern "C" int ft_smem_bytes(int n_convs, const int* widths, int L) {
  if (n_convs < 1 || n_convs > MAX_CONVS || L < 4 || L % 4 != 0) return -1;
  Net net;
  net.n_convs = n_convs;
  for (int l = 0; l <= n_convs; ++l) net.width[l] = widths[l];
  const SmemLayout s = smem_layout(net, tile_edge(L));
  return static_cast<int>(sizeof(float)) * s.total;
}

// Dynamic shared memory one block may opt in to on the device, or -1.
extern "C" int ft_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Stage one conv's weights in shared memory. Forward: routine input
// channel c is the conv's input channel. transpose: the routine runs the
// transposed conv (input cotangents from output cotangents), i.e. a conv
// with w'[c_in][c_out][tap] = w[c_out][c_in][8 - tap]; rin/rout are the
// routine's own channel counts. bias may be null (no bias).
__device__ void stage_weights(const float* __restrict__ W,
                              const float* __restrict__ bias, int rin,
                              int rout, bool transpose, float* w_s,
                              float* b_s) {
  const int cpad = round_up(rout, OC);
  const int n = rin * 9 * cpad;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e / (9 * cpad);
    const int rem = e - c * 9 * cpad;
    const int tap = rem / cpad;
    const int o = rem - tap * cpad;
    float v = 0.f;
    if (o < rout)
      v = transpose ? W[(c * rout + o) * 9 + (8 - tap)]
                    : W[(o * rin + c) * 9 + tap];
    w_s[e] = v;
  }
  for (int o = threadIdx.x; o < cpad; o += blockDim.x)
    b_s[o] = (bias != nullptr && o < rout) ? bias[o] : 0.f;
}

// out[o](i,j) = b[o] + sum_{c,dy,dx} w[o][c][dy][dx] * in[c](i+dy-1, j+dx-1)
// with periodic indices. load(c, i, j) gives an input value (i, j already
// wrapped); store(o0, i, j, acc) takes the OC sums of channels o0..o0+OC-1
// at site (i, j). Every thread of the block must call this.
template <class Load, class Store>
__device__ void conv3x3(int cin, int cout, const float* w_s,
                        const float* b_s, float* tile, const Layer& ly,
                        Load load, Store store) {
  const int L = ly.L, TW = ly.TW, TP = TW + 2;
  const int ntile = (L + TW - 1) / TW;
  const int cpad = round_up(cout, OC);
  const int nitems = (cpad / OC) * TW * TW;
  for (int t = 0; t < ntile * ntile; ++t) {
    const int i0 = (t / ntile) * TW, j0 = (t % ntile) * TW;
    __syncthreads();  // the previous tile (or staged weights) is done with
    for (int e = threadIdx.x; e < cin * TP * TP; e += blockDim.x) {
      const int c = e / (TP * TP);
      const int r = e - c * TP * TP;
      const int i = (i0 + r / TP - 1 + L) % L;
      const int j = (j0 + r % TP - 1 + L) % L;
      tile[e] = load(c, i, j);
    }
    __syncthreads();
    for (int item = threadIdx.x; item < nitems; item += blockDim.x) {
      const int chunk = item / (TW * TW);
      const int s = item - chunk * TW * TW;
      const int a = s / TW, bb = s - (s / TW) * TW;
      const int i = i0 + a, j = j0 + bb;
      if (i >= L || j >= L) continue;
      float acc[OC];
#pragma unroll
      for (int k = 0; k < OC; ++k) acc[k] = b_s[chunk * OC + k];
      for (int c = 0; c < cin; ++c) {
        const float* tc = tile + c * TP * TP + a * TP + bb;
        const float* wc = w_s + c * 9 * cpad + chunk * OC;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float v = tc[dy * TP + dx];
            const float4* w4 =
                reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * cpad);
            const float4 wa = w4[0], wb = w4[1];
            acc[0] += wa.x * v;
            acc[1] += wa.y * v;
            acc[2] += wa.z * v;
            acc[3] += wa.w * v;
            acc[4] += wb.x * v;
            acc[5] += wb.y * v;
            acc[6] += wb.z * v;
            acc[7] += wb.w * v;
          }
        }
      }
      store(chunk * OC, i, j, acc);
    }
  }
}

// Sum of v over the block (THREADS threads), returned to thread 0.
__device__ float block_sum(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (static_cast<int>(threadIdx.x) < h)
      red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  return red[0];
}

// Log-scale of component m after the optional smooth clip.
__device__ __forceinline__ float clipped_s(float raw, float s_clip) {
  return s_clip > 0.f ? s_clip * tanhf(raw / s_clip) : raw;
}

// log h'_s(y), factored by m = |s| so both exponents are <= 0.
__device__ __forceinline__ float tan_logj(float s, float cy, float sy) {
  const float m = fabsf(s);
  const float inner = expf(-s - m) * cy * cy + expf(s - m) * sy * sy;
  return -(m + logf(inner + TINY));
}

// Forward mixture transform of the plaquette p at one site. raw points at
// the site's first conditioner channel, channel stride LL. Returns the
// plaquette change new_p - p and writes the site's log-Jacobian
// contribution (0 off the active stripe).
__device__ float transform_site(const float* raw, int LL, float p,
                                bool active, const Layer& ly, float* lj) {
  if (!active) {
    *lj = 0.f;
    return 0.f;
  }
  const int M = ly.M;
  float hsum = 0.f, mx = -INFINITY, se = 0.f;
  for (int m = 0; m < M; ++m) {
    const float s = clipped_s(raw[m * LL], ly.s_clip);
    const float y = ly.rncp ? wrap_pi(p - raw[(M + m) * LL]) : p;
    const float cy = cosf(0.5f * y), sy = sinf(0.5f * y);
    const float sc = fminf(fmaxf(s, -HARD_CLIP), HARD_CLIP);
    const float h = wrap_pi(2.f * atan2f(expf(sc) * sy, cy));
    hsum += ly.rncp ? h - y : h;
    const float l = tan_logj(s, cy, sy);
    if (l > mx) {
      se = se * expf(mx - l) + 1.f;
      mx = l;
    } else {
      se += expf(l - mx);
    }
  }
  const float t = raw[(ly.rncp ? 2 * M : M) * LL];
  const float f1 = ly.rncp ? p + hsum / M : hsum / M;
  *lj = mx + logf(se) - logf(static_cast<float>(M));
  return wrap_pi(f1 + t) - p;
}
