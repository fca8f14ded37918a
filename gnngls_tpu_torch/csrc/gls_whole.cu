// The whole fixed-budget Guided Local Search for one instance per block.
//
// Replaces the TPU kernel gnngls_tpu/search/pallas_gls.py::_gls_kernel (K1):
// initial local search, then n_iters rounds of guided perturbation and local
// search, best-tour tracking, guide cycling (guide it % G) and per-iteration
// traces of the best cost and the cumulative accepted moves.  The semantics
// are those of gnngls_tpu/search/local_search.py and moves.py; every f32
// expression is evaluated in the order of the plain twin
// (gnngls_tpu_torch/search/local_search.py), so both give the same tours.
//
// Layout: one block of 256 threads per instance, in one of two state
// layouts chosen by the launcher (one kernel body, templated on it):
//  * shared (n <= gls_whole_max_n(), 138 on sm_90): D, the city-space
//    penalties P and the current guide live in shared memory (3 n^2 floats:
//    120 KB at n=100, so one block per SM);
//  * global (n <= kMaxN): D and the current guide are read from global
//    memory where they lie, and P lives in a per-instance global workspace
//    (B n^2 floats) that the caller zeroes before each launch.
// In both, the current tour, a scratch tour, the best tour and the tree-sum
// buffer (the next power of two >= n floats) stay in shared memory.  Only the
// addresses differ: both layouts take the same f32 steps in the same order,
// so they give the same bits.  Deltas are direct gathers
// D[t[p], t[q]]; nothing is rebuilt per move (the TPU kernel's one-hot
// P D P^T products and rolls were Mosaic workarounds).  Argmins and argmaxes
// are block reductions on (value, row-major index), first occurrence wins.
// Moves are applied in place.  Tour costs are block tree sums in a fixed
// order (zero-pad to a power of two, add halves), which the twin repeats.
//
// What bounds it on an H100 SXM: the work depends on the data.  Each local
// search round scans ~(n-2)(n-3)/2 2-opt and ~(n-1)(n-2) relocate deltas
// (3 and 5 adds each); each perturbation round a few n-wide scans.  That is
// ~1e5 operations per round, and the inputs are n^2 floats per matrix, so
// the roofline bound (operations over 67 TFLOP/s, bytes over 3.35 TB/s) is
// far below what the block's chain of dependent, synchronised steps takes:
// latency of the serial search bounds it, not the card's rates.  In the
// global layout every delta's gathers D[t[p] n + t[q]] go to L2 or HBM (at
// n=500 each instance's D is 1 MB, and 128 instances do not fit L2), so the
// latency of those gathers adds to it.
//
// Numerics: the guided weight is D + k*P rounded as multiply, round, add
// (__fmul_rn / __fadd_rn, and the build passes -fmad=false): a contracted
// FMA would flip accept decisions against the twin.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;  // the global layout's range; search/gls_whole.py's MAX_N
constexpr int kSmemCap = 232448;  // bytes a block may use on sm_90
constexpr float kNegEps = -(float)(1e-8 / (1.0 - 1e-5));

enum Layout { kShared = 0, kGlobal = 1 };

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

size_t smem_bytes(int n, bool global) {
  const size_t mats = global ? 0 : 3 * (size_t)n * n;
  const size_t floats = mats + pow2_at_least(n) + (kWarps + 1);
  const size_t ints = (kWarps + 1) + 3 * (size_t)(n + 1) + 1;
  return (floats + ints) * 4;
}

__device__ __forceinline__ bool lex_less(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ bool lex_greater(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Block-wide (value, index) argmin or argmax; every thread gets the result.
template <bool kMax>
__device__ void block_arg(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (kMax ? lex_greater(ov, oi, v, i) : lex_less(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { red_v[w] = v; red_i[w] = i; }
  __syncthreads();
  if (w == 0) {
    v = lane < kWarps ? red_v[lane] : (kMax ? -CUDART_INF_F : CUDART_INF_F);
    i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (kMax ? lex_greater(ov, oi, v, i) : lex_less(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { red_v[kWarps] = v; red_i[kWarps] = i; }
  }
  __syncthreads();
  v = red_v[kWarps];
  i = red_i[kWarps];
}

struct Search {
  int n, nt, p2;
  float k;
  float *D, *P, *G, *buf, *red_v;
  int *red_i, *t, *tmp, *best, *pos;

  __device__ float d(int p, int q) const { return D[t[p] * n + t[q]]; }
  __device__ float dg(int p, int q) const {  // guided weight D + k*P
    const int a = t[p] * n + t[q];
    return __fadd_rn(D[a], __fmul_rn(k, P[a]));
  }

  __device__ float tour_cost() {
    for (int q = threadIdx.x; q < p2; q += blockDim.x) buf[q] = q < n ? d(q, q + 1) : 0.f;
    __syncthreads();
    for (int s = p2 >> 1; s > 0; s >>= 1) {
      for (int q = threadIdx.x; q < s; q += blockDim.x) buf[q] = __fadd_rn(buf[q], buf[q + s]);
      __syncthreads();
    }
    const float c = buf[0];
    __syncthreads();
    return c;
  }

  __device__ void apply_two_opt(int i, int j) {  // reverse positions [i, j-1]
    const int len = j - i;
    for (int p = threadIdx.x; p < len / 2; p += blockDim.x) {
      const int a = t[i + p];
      t[i + p] = t[j - 1 - p];
      t[j - 1 - p] = a;
    }
    __syncthreads();
  }

  __device__ void apply_relocate(int i, int j) {  // pop position i, insert at j
    for (int p = threadIdx.x; p < nt; p += blockDim.x) {
      int src;
      if (i < j) src = p < i ? p : (p < j ? p + 1 : (p == j ? i : p));
      else src = p < j ? p : (p == j ? i : (p <= i ? p - 1 : p));
      tmp[p] = t[src];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < nt; p += blockDim.x) t[p] = tmp[p];
    __syncthreads();
  }

  __device__ void best_two_opt(float& v, int& x) {
    v = CUDART_INF_F;
    x = INT_MAX;
    for (int c = threadIdx.x; c < nt * nt; c += blockDim.x) {
      const int i = c / nt, j = c - i * nt;
      if (i < 1 || j > n - 1 || j - i < 2) continue;
      const float delta =
          __fsub_rn(__fsub_rn(__fadd_rn(d(i, j), d(i - 1, j - 1)), d(i - 1, i)), d(j - 1, j));
      if (delta < kNegEps && lex_less(delta, c, v, x)) { v = delta; x = c; }
    }
    block_arg<false>(v, x, red_v, red_i);
  }

  __device__ void best_relocate(float& v, int& x) {
    v = CUDART_INF_F;
    x = INT_MAX;
    for (int c = threadIdx.x; c < nt * nt; c += blockDim.x) {
      const int i = c / nt, j = c - i * nt;
      if (i < 1 || i > n - 1 || j < 1 || j > n - 1 || i == j || i - j == 1) continue;
      const float rem = __fadd_rn(__fsub_rn(-d(i, i - 1), d(i + 1, i)), d(i + 1, i - 1));
      const float ins = i < j ? __fadd_rn(__fadd_rn(-d(j + 1, j), d(j, i)), d(i, j + 1))
                              : __fadd_rn(__fadd_rn(-d(j, j - 1), d(j - 1, i)), d(i, j));
      const float delta = __fadd_rn(rem, ins);
      if (delta < kNegEps && lex_less(delta, c, v, x)) { v = delta; x = c; }
    }
    block_arg<false>(v, x, red_v, red_i);
  }

  __device__ void local_search(float& cost, int& moves, int& rounds) {
    for (int r = 0; r < 10 * n; ++r) {
      ++rounds;
      float v;
      int x;
      best_two_opt(v, x);
      const bool f1 = x != INT_MAX;
      if (f1) {
        apply_two_opt(x / nt, x % nt);
        cost = __fadd_rn(cost, v);
        ++moves;
      }
      best_relocate(v, x);
      const bool f2 = x != INT_MAX;
      if (f2) {
        apply_relocate(x / nt, x % nt);
        cost = __fadd_rn(cost, v);
        ++moves;
      }
      if (!f1 && !f2) break;
    }
  }

  // o2a 2-opt and then o2a relocate at the endpoint's position, under D + k*P.
  __device__ void endpoint(int node, float& cost, int& moves, int& made) {
    if (node == 0) return;  // the depot is skipped
    for (int p = threadIdx.x; p < nt; p += blockDim.x)
      if (t[p] == node) *pos = p;
    __syncthreads();
    const int i = *pos;

    float v = CUDART_INF_F;
    int j = INT_MAX;
    const float ci = dg(i - 1, i);
    for (int q = 1 + threadIdx.x; q <= n - 1; q += blockDim.x) {
      if (abs(i - q) < 2) continue;
      const float delta =
          __fsub_rn(__fsub_rn(__fadd_rn(dg(i, q), dg(i - 1, q - 1)), ci), dg(q - 1, q));
      if (delta < kNegEps && lex_less(delta, q, v, j)) { v = delta; j = q; }
    }
    block_arg<false>(v, j, red_v, red_i);
    if (j != INT_MAX) {
      apply_two_opt(min(i, j), max(i, j));
      cost = tour_cost();
      ++moves;
      ++made;
    }

    // the reference reuses the position found before the 2-opt
    v = CUDART_INF_F;
    j = INT_MAX;
    const float rem = __fadd_rn(__fsub_rn(-dg(i, i - 1), dg(i + 1, i)), dg(i + 1, i - 1));
    for (int q = 1 + threadIdx.x; q <= n - 1; q += blockDim.x) {
      if (q == i) continue;
      const float ins = q > i ? __fadd_rn(__fadd_rn(-dg(q + 1, q), dg(i, q)), dg(i, q + 1))
                              : __fadd_rn(__fadd_rn(-dg(q, q - 1), dg(i, q - 1)), dg(i, q));
      const float delta = __fadd_rn(rem, ins);
      if (delta < kNegEps && lex_less(delta, q, v, j)) { v = delta; j = q; }
    }
    block_arg<false>(v, j, red_v, red_i);
    if (j != INT_MAX) {
      apply_relocate(i, j);
      cost = tour_cost();
      ++moves;
      ++made;
    }
  }

  __device__ void perturbation(int pm, float& cost, int& moves, int& rounds) {
    int made = 0;
    for (int r = 0; r < 3 * pm && made < pm; ++r) {
      ++rounds;
      float v = -CUDART_INF_F;
      int q_best = INT_MAX;
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        const int a = t[q] * n + t[q + 1];
        const float util = __fdiv_rn(G[a], __fadd_rn(1.f, P[a]));
        if (lex_greater(util, q, v, q_best)) { v = util; q_best = q; }
      }
      block_arg<true>(v, q_best, red_v, red_i);
      const int u = t[q_best], w = t[q_best + 1];
      if (threadIdx.x == 0) {
        P[u * n + w] = __fadd_rn(P[u * n + w], 1.f);
        P[w * n + u] = __fadd_rn(P[w * n + u], 1.f);
      }
      __syncthreads();
      endpoint(u, cost, moves, made);
      endpoint(w, cost, moves, made);
    }
  }
};

template <Layout kLayout>
__global__ void __launch_bounds__(kThreads)
gls_whole_kernel(const float* __restrict__ Ds, const float* __restrict__ guides,
                 const int* __restrict__ init, int n, int n_guides, int n_iters, int pm,
                 float* penalties, int* __restrict__ best_out,
                 float* __restrict__ best_cost_out, int* __restrict__ moves_out,
                 float* __restrict__ trace_c, int* __restrict__ trace_m,
                 int* __restrict__ work_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, nt = n + 1, nn = n * n;
  Search s;
  s.n = n;
  s.nt = nt;
  s.p2 = 1;
  while (s.p2 < n) s.p2 <<= 1;
  float* rest = smem;
  if (kLayout == kShared) {
    s.D = smem;
    s.P = s.D + nn;
    s.G = s.P + nn;
    rest = s.G + nn;
  }
  s.buf = rest;
  s.red_v = s.buf + s.p2;
  s.red_i = reinterpret_cast<int*>(s.red_v + kWarps + 1);
  s.t = s.red_i + kWarps + 1;
  s.tmp = s.t + nt;
  s.best = s.tmp + nt;
  s.pos = s.best + nt;

  const float* D = Ds + (size_t)b * nn;
  const float* Gb = guides + (size_t)b * n_guides * nn;
  if (kLayout == kShared) {
    for (int x = threadIdx.x; x < nn; x += blockDim.x) {
      s.D[x] = D[x];
      s.P[x] = 0.f;
      s.G[x] = Gb[x];
    }
  } else {  // read in place; the caller zeroed this instance's penalties
    s.D = const_cast<float*>(D);
    s.P = penalties + (size_t)b * nn;
    s.G = const_cast<float*>(Gb);
  }
  for (int p = threadIdx.x; p < nt; p += blockDim.x) s.t[p] = init[(size_t)b * nt + p];
  __syncthreads();

  float cost = s.tour_cost();
  s.k = __fdiv_rn(__fmul_rn(0.1f, cost), (float)n);  // k from the cost before the first LS
  int moves = 0, ls_rounds = 0, pert_rounds = 0;
  s.local_search(cost, moves, ls_rounds);
  for (int p = threadIdx.x; p < nt; p += blockDim.x) s.best[p] = s.t[p];
  float best_cost = cost;
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    if (n_guides > 1) {
      const float* Gi = Gb + (size_t)(it % n_guides) * nn;
      if (kLayout == kShared) {
        for (int x = threadIdx.x; x < nn; x += blockDim.x) s.G[x] = Gi[x];
        __syncthreads();
      } else {
        s.G = const_cast<float*>(Gi);
      }
    }
    s.perturbation(pm, cost, moves, pert_rounds);
    s.local_search(cost, moves, ls_rounds);
    if (cost < best_cost) {
      best_cost = cost;
      for (int p = threadIdx.x; p < nt; p += blockDim.x) s.best[p] = s.t[p];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      trace_c[(size_t)b * n_iters + it] = best_cost;
      trace_m[(size_t)b * n_iters + it] = moves;
    }
  }
  for (int p = threadIdx.x; p < nt; p += blockDim.x) best_out[(size_t)b * nt + p] = s.best[p];
  if (threadIdx.x == 0) {
    best_cost_out[b] = best_cost;
    moves_out[b] = moves;
    work_out[2 * b] = ls_rounds;
    work_out[2 * b + 1] = pert_rounds;
  }
}

}  // namespace

// Largest n whose whole state fits one block's shared memory (the shared layout).
extern "C" int gls_whole_max_n() {
  int n = 3;
  while (smem_bytes(n + 1, false) <= (size_t)kSmemCap) ++n;
  return n;
}

// layout: 0 shared (n <= gls_whole_max_n()), 1 global (n <= kMaxN; penalties is a
// zeroed (B, n, n) f32 workspace).  Anything else is refused.
extern "C" cudaError_t gls_whole_launch(const float* Ds, const float* guides, const int* init,
                                        int B, int n, int n_guides, int n_iters, int pm,
                                        int layout, float* penalties,
                                        int* best, float* best_cost, int* moves,
                                        float* trace_c, int* trace_m, int* work, int device,
                                        cudaStream_t stream) {
  const bool global = layout == kGlobal;
  if (n < 3 || n_guides < 1 || (layout != kShared && layout != kGlobal)) {
    return cudaErrorInvalidValue;
  }
  if (global ? (n > kMaxN || penalties == nullptr) : n > gls_whole_max_n()) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(n, global);
  auto kernel = global ? gls_whole_kernel<kGlobal> : gls_whole_kernel<kShared>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(Ds, guides, init, n, n_guides, n_iters, pm, penalties,
                                        best, best_cost, moves, trace_c, trace_m, work);
  return cudaGetLastError();
}
