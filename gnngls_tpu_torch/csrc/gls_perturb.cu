// The perturbation phase of one outer iteration of the per-move engine's
// Guided Local Search, for a whole batch in one launch: one block an instance.
//
// It replaces no TPU kernel.  Its JAX counterpart is the vmapped
// `lax.while_loop` of gnngls_tpu/search/local_search.py:129 (`_perturbation`);
// its plain twin is `_perturbation` in gnngls_tpu_torch/search/local_search.py,
// which runs the batch's rounds in lock step, each round a few hundred small
// tensor ops over (B, n+1, n+1) gathers and a host sync.  Here every block
// loops over its own instance's rounds, so nothing waits for the batch.
//
// Per round, the twin's semantics exactly: the first tour edge (u, v) of
// largest guide / (1 + penalty), the penalties read before the bump; the
// symmetric bump; then for u and then v, skipping the depot, the one-to-all
// 2-opt at the endpoint's position under D + k P, then the one-to-all
// relocate at that same, now stale, position.  Rounds run while fewer than pm
// moves were accepted and fewer than max_iters rounds ran.  After every
// accepted move the tour is re-costed on D in search/moves.tree_sum's
// zero-padded halving order, and with a trace buffer that cost is written at
// row min(count, cap - 1); every move counts in the trace either way.
//
// What bounds it: latency.  A round is a chain of dependent n-wide scans (the
// guide's argmax, then two per endpoint), each ended by a block reduction, and
// a rebuild of the tour for each accepted move: some 10^3 operations a scan at
// n = 100, far below any rate of the card.  So the design keeps each step one
// pass over the block's threads and one barrier:
//  * the block is as wide as the tour, min(1024, ceil((n + 1) / 32) * 32)
//    threads (4 warps at n = 100); past 1024 cities the threads stride.  Up
//    to 256 threads the kernel is built for at most 256 (255 registers a
//    thread, no spills), past that for 1024 (64 registers);
//  * D, the penalties P and the iteration's guide are read in place from
//    device memory at the strides they are given (a scan reads O(n) entries
//    of a few rows); P, the caller's tensor, is bumped in place by one thread;
//  * the tour state: two tour buffers (a move writes the other one, then
//    they swap), the inverse tour pos[] (a city's position without a scan)
//    and the true edge weights fwd[p] = D(t[p-1], t[p]) that a move rebuilds
//    only where it changed the tour, about 16 n bytes.  It lives in shared
//    memory up to gls_perturb_max_n(0) cities (14,495 on sm_90), and past
//    that in a global workspace, one slice an instance, up to
//    gls_perturb_max_n(1) = 131,072 cities (D, P and the guide alone then
//    take 192 GiB, past the card);
//  * a reduction is redux.sync within each warp, then each warp reduces the
//    warps' partials itself, from two buffers that alternate: one barrier;
//  * warp 0 alone re-costs the tour from fwd[] while the other warps go on.
//
// Argmins and argmaxes are lexicographic on (value, position), the first
// occurrence winning; with first_improvement a scan takes the first improving
// position.  A move is accepted only if its delta is below -EPS_CLOSE in f32.
// Every expression is evaluated in the order of search/moves.py, the guided
// weight as multiply, round, add (__fmul_rn / __fadd_rn; the build passes
// -fmad=false), so the kernel and the twin give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;  // 32: one warp reduces the warps' partials
constexpr int kCostLevels = 12;           // warp_tour_cost's stack: n up to 32 << 12
constexpr int kSmemCap = 232448;          // bytes a block may use on sm_90
constexpr float kNegEps = -(float)(1e-8 / (1.0 - 1e-5));
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxN = 32 << kCostLevels;  // the global layout's range

// an instance's tour state: two tour buffers, pos and fwd, in 4-byte words
__host__ __device__ constexpr size_t state_words(int n) {
  return 2 * (size_t)(n + 1) + n + (n + 1);
}

// two buffers of warp partials (value, index), then the shared layout's state
constexpr size_t smem_bytes(int n, bool global) {
  return (4 * kWarps + (global ? 0 : state_words(n))) * 4;
}

constexpr int max_n_shared() {
  int n = 1;
  while (smem_bytes(n + 1, false) <= (size_t)kSmemCap) ++n;
  return n;
}
static_assert(max_n_shared() >= 8192, "the shared layout must cover the whole-GLS kernel's");

__device__ __forceinline__ bool lex_less(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ bool lex_greater(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// An unsigned key in the order of the floats (-0 taken as +0, as the float
// comparisons take them), and back.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// Warp-wide (value, index) argmin or argmax, the first index among equal
// values; every lane gets the result.
template <bool kMax>
__device__ __forceinline__ void warp_arg(float& v, int& i) {
  const unsigned k = order_key(v);
  const unsigned best = kMax ? __reduce_max_sync(kFull, k) : __reduce_min_sync(kFull, k);
  i = (int)__reduce_min_sync(kFull, k == best ? (unsigned)i : 0xffffffffu);
  v = key_value(best);
}

struct Perturb {
  int n, nt, p2, nthr;
  bool first;  // first-improvement
  float k;
  const float* D;
  int64_t dsi, dsj;
  const float* G;
  int64_t gsi, gsj;
  float* P;
  int64_t psi, psj;
  int *t, *tn, *pos, *red_i;
  float *fwd, *red_v;
  int par;  // which of the two reduction buffers is next
  // the trace: cost rows (null: count only), and in thread 0 the count
  float* trace_c;
  int cap, count;
  float cost;  // the last re-cost, kept by warp 0
  int made;    // accepted moves, in every thread

  __device__ float dd(int a, int c) const { return D[a * dsi + c * dsj]; }  // cities
  __device__ float pp(int a, int c) const { return P[a * psi + c * psj]; }
  __device__ float dg(int p, int q) const {  // guided weight D + k*P, positions
    const int a = t[p], c = t[q];
    return __fadd_rn(dd(a, c), __fmul_rn(k, pp(a, c)));
  }

  // (value, index) argmin or argmax over the block with one barrier; every
  // thread gets the result.  The buffers alternate, so a warp still reading
  // one never meets the next reduction's writes: another barrier lies between.
  template <bool kMax>
  __device__ void block_arg(float& v, int& i) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = nthr >> 5;
    warp_arg<kMax>(v, i);
    float* rv = red_v + par * kWarps;
    int* ri = red_i + par * kWarps;
    par ^= 1;
    if (lane == 0) { rv[w] = v; ri[w] = i; }
    __syncthreads();
    v = lane < nw ? rv[lane] : (kMax ? -CUDART_INF_F : CUDART_INF_F);
    i = lane < nw ? ri[lane] : INT_MAX;
    warp_arg<kMax>(v, i);
  }

  // The tour's cost on D, summed by one warp: moves.tree_sum's halving tree
  // over fwd[q + 1] = d(q, q+1), zero-padded to p2.  Lane l first reduces its
  // column q = l (mod 32), where the tree's strides >= 32 pair entries,
  // walking it in bit-reversed order with a stack of partial sums (one level
  // per stride); strides 16..1 then run in shuffles.  All lanes get the sum.
  __device__ float warp_tour_cost() const {
    const int lane = threadIdx.x & 31;
    auto val = [&](int q) { return q < n ? fwd[q + 1] : 0.f; };
    float x;
    if (p2 <= 32) {
      x = lane < p2 ? val(lane) : 0.f;
    } else {
      const int M = p2 >> 5, lm = 31 - __clz(M);
      float st[kCostLevels];
      for (int kk = 0; kk < M; ++kk) {
        x = val(lane + 32 * (int)(__brev(kk) >> (32 - lm)));
#pragma unroll
        for (int lv = 0; lv < kCostLevels; ++lv) {
          if (!((kk >> lv) & 1)) { st[lv] = x; break; }
          x = __fadd_rn(st[lv], x);
        }
      }
    }
    for (int off = min(16, p2 >> 1); off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(kFull, x, off));
    return __shfl_sync(kFull, x, 0);
  }

  // The next tour is tn[p] = t[src(p)]; positions lo..hi change.  Rebuilds
  // pos[] there and the edge weights next to it, then swaps the buffers.
  template <class Src>
  __device__ void rebuild(int lo, int hi, Src src) {
    for (int p = threadIdx.x; p < nt; p += nthr) {
      const int c = t[src(p)];
      tn[p] = c;
      if (p >= lo && p <= hi && p >= 1 && p < n) pos[c] = p;
      if (p >= 1 && p >= lo && p <= hi + 1) fwd[p] = dd(t[src(p - 1)], c);
    }
    __syncthreads();
    int* s = t;
    t = tn;
    tn = s;
  }

  // One accepted move: re-cost on D (warp 0) and trace it, when the trace
  // keeps costs; count it.
  __device__ void accepted() {
    ++made;
    if (trace_c != nullptr && threadIdx.x < 32) {
      cost = warp_tour_cost();
      if (threadIdx.x == 0) trace_c[min(count, cap - 1)] = cost;
    }
    if (threadIdx.x == 0) ++count;
  }

  // The candidate (delta, q) of a scan, in the improvement mode's order.
  __device__ void offer(float delta, int q, float& v, int& j) const {
    if (!(delta < kNegEps)) return;
    if (first) {
      if (q < j) { v = 0.f; j = q; }  // the first improving position
    } else if (lex_less(delta, q, v, j)) {
      v = delta;
      j = q;
    }
  }

  // o2a 2-opt and then o2a relocate at the endpoint's position, under D + k*P.
  __device__ void endpoint(int node) {
    if (node == 0) return;  // the depot is skipped
    const int i = pos[node];

    float v = CUDART_INF_F;
    int j = INT_MAX;
    const float ci = dg(i - 1, i);
    for (int q = 1 + threadIdx.x; q <= n - 1; q += nthr) {
      if (abs(i - q) < 2) continue;
      offer(__fsub_rn(__fsub_rn(__fadd_rn(dg(i, q), dg(i - 1, q - 1)), ci), dg(q - 1, q)),
            q, v, j);
    }
    block_arg<false>(v, j);
    if (j != INT_MAX) {
      const int lo = min(i, j), hi = max(i, j);  // reverse positions [lo, hi-1]
      rebuild(lo, hi - 1, [=](int p) { return p >= lo && p < hi ? lo + hi - 1 - p : p; });
      accepted();
    }

    // the reference reuses the position found before the 2-opt
    v = CUDART_INF_F;
    j = INT_MAX;
    const float rm = __fadd_rn(__fsub_rn(-dg(i, i - 1), dg(i + 1, i)), dg(i + 1, i - 1));
    for (int q = 1 + threadIdx.x; q <= n - 1; q += nthr) {
      if (q == i) continue;
      const float ins = q > i ? __fadd_rn(__fadd_rn(-dg(q + 1, q), dg(i, q)), dg(i, q + 1))
                              : __fadd_rn(__fadd_rn(-dg(q, q - 1), dg(i, q - 1)), dg(i, q));
      offer(__fadd_rn(rm, ins), q, v, j);
    }
    block_arg<false>(v, j);
    if (j != INT_MAX) {  // pop position i, insert it at j
      rebuild(min(i, j), max(i, j), [=](int p) {
        if (i < j) return p < i ? p : (p < j ? p + 1 : (p == j ? i : p));
        return p < j ? p : (p == j ? i : (p <= i ? p - 1 : p));
      });
      accepted();
    }
  }

  // The rounds; returns how many ran.
  __device__ int run(int pm, int max_iters) {
    int rounds = 0;
    for (; rounds < max_iters && made < pm; ++rounds) {
      float v = -CUDART_INF_F;
      int q_best = INT_MAX;
      for (int q = threadIdx.x; q < n; q += nthr) {
        const int a = t[q], c = t[q + 1];
        const float util = __fdiv_rn(G[a * gsi + c * gsj], __fadd_rn(1.f, pp(a, c)));
        if (lex_greater(util, q, v, q_best)) { v = util; q_best = q; }
      }
      block_arg<true>(v, q_best);
      const int u = t[q_best], w = t[q_best + 1];
      if (threadIdx.x == 0) {
        float* puw = P + u * psi + w * psj;
        *puw = __fadd_rn(*puw, 1.f);
        float* pwu = P + w * psi + u * psj;
        *pwu = __fadd_rn(*pwu, 1.f);
      }
      __syncthreads();
      endpoint(u);
      endpoint(w);
    }
    return rounds;
  }
};

// The tour state in shared memory when ws is null, else in ws's slice b.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
gls_perturb_kernel(const float* __restrict__ D, int64_t dsb, int64_t dsi, int64_t dsj,
                   const float* __restrict__ G, int64_t gsb, int64_t gsi, int64_t gsj,
                   float* P, int64_t psb, int64_t psi, int64_t psj,
                   const float* __restrict__ k, const int64_t* __restrict__ tour_in,
                   const float* __restrict__ cost_in, int64_t* __restrict__ tour_out,
                   float* __restrict__ cost_out, float* trace_c, int cap, int* trace_n,
                   int* work, int* __restrict__ rounds_out, int* ws, int n, int pm,
                   int max_iters, int first_improvement) {
  extern __shared__ int smem_i[];
  const int b = blockIdx.x, nt = n + 1;
  Perturb s;
  s.n = n;
  s.nt = nt;
  s.p2 = 1;
  while (s.p2 < n) s.p2 <<= 1;
  s.nthr = blockDim.x;
  s.first = first_improvement != 0;
  s.k = k[b];
  s.D = D + b * dsb;
  s.dsi = dsi;
  s.dsj = dsj;
  s.G = G + b * gsb;
  s.gsi = gsi;
  s.gsj = gsj;
  s.P = P + b * psb;
  s.psi = psi;
  s.psj = psj;
  s.red_i = smem_i;
  s.red_v = reinterpret_cast<float*>(smem_i + 2 * kWarps);
  s.t = ws == nullptr ? smem_i + 4 * kWarps : ws + (size_t)b * state_words(n);
  s.tn = s.t + nt;
  s.pos = s.tn + nt;
  s.fwd = reinterpret_cast<float*>(s.pos + n);
  s.par = 0;
  s.trace_c = trace_c == nullptr ? nullptr : trace_c + (size_t)b * cap;
  s.cap = cap;
  s.count = trace_n[b];
  s.cost = cost_in[b];
  s.made = 0;

  const int64_t* tin = tour_in + (size_t)b * nt;
  for (int p = threadIdx.x; p < nt; p += blockDim.x) s.t[p] = (int)tin[p];
  __syncthreads();
  s.rebuild(0, n, [](int p) { return p; });

  const int rounds = s.run(pm, max_iters);
  // without cost rows only the last re-cost is read: take it once, here
  if (s.trace_c == nullptr && s.made > 0 && threadIdx.x < 32) s.cost = s.warp_tour_cost();

  int64_t* tout = tour_out + (size_t)b * nt;
  for (int p = threadIdx.x; p < nt; p += blockDim.x) tout[p] = s.t[p];
  if (threadIdx.x == 0) {
    cost_out[b] = s.cost;
    trace_n[b] = s.count;
    work[2 * b + 1] += rounds;
    rounds_out[b] = rounds;
  }
}

}  // namespace

// Largest n of the shared layout (global_layout 0: the tour state in one
// block's shared memory) or of the global one (1).
extern "C" int gls_perturb_max_n(int global_layout) {
  return global_layout ? kMaxN : max_n_shared();
}

// Bytes of the global layout's workspace for B instances of n cities.
extern "C" int64_t gls_perturb_workspace_bytes(int B, int n) {
  return (int64_t)B * (int64_t)state_words(n) * 4;
}

// One launch for the batch's perturbation phase.  D, G (the iteration's
// guide) and P are (B, n, n) f32 at the given strides (elements); P is
// updated in place.  k, cost_in (B,) f32, tour_in (B, n+1) int64, all
// contiguous; the kernel writes tour_out and cost_out (the last re-cost, or
// cost_in where no move was accepted).  trace_c: null (count only) or a
// (B, cap) f32 buffer; trace_n (B,) int32 and work (B, 2) int32 are updated in
// place (work[:, 1] += each instance's rounds); rounds_out (B,) int32 gets
// each instance's rounds.  ws: null (the shared layout) or
// gls_perturb_workspace_bytes(B, n) of device memory (the global one).  n
// outside [1, gls_perturb_max_n(ws != null)] is refused.
extern "C" cudaError_t gls_perturb_launch(
    const float* D, int64_t dsb, int64_t dsi, int64_t dsj, const float* G, int64_t gsb,
    int64_t gsi, int64_t gsj, float* P, int64_t psb, int64_t psi, int64_t psj, const float* k,
    const int64_t* tour_in, const float* cost_in, int64_t* tour_out, float* cost_out,
    float* trace_c, int cap, int* trace_n, int* work, int* rounds_out, int* ws, int B, int n,
    int pm, int max_iters, int first_improvement, int device, cudaStream_t stream) {
  const bool global = ws != nullptr;
  if (n < 1 || n > gls_perturb_max_n(global) || (trace_c != nullptr && cap < 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(n, global);
  const int wide = (n + 1 + 31) / 32 * 32;
  const int threads = wide < kMaxThreads ? wide : kMaxThreads;
  using Kernel = decltype(&gls_perturb_kernel<256>);
  const Kernel kernel =
      threads <= 256 ? &gls_perturb_kernel<256> : &gls_perturb_kernel<kMaxThreads>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(
      D, dsb, dsi, dsj, G, gsb, gsi, gsj, P, psb, psi, psj, k, tour_in, cost_in, tour_out,
      cost_out, trace_c, cap, trace_n, work, rounds_out, ws, n, pm, max_iters,
      first_improvement);
  return cudaGetLastError();
}
