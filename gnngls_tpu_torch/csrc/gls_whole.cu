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
// Layout: one block of 1024 threads per instance, in one of two state
// layouts chosen by the launcher (one kernel body, templated on it):
//  * shared (n <= gls_whole_max_n(), 138 on sm_90): D, the city-space
//    penalties P and the current guide live in shared memory (3 n^2 floats:
//    120 KB at n=100, so one block per SM);
//  * global (n <= kMaxN): D and the current guide are read from global
//    memory where they lie; P and a transposed copy of D live in a
//    per-instance global workspace (B, 2, n, n) that the caller zeroes
//    before each launch and the block fills with D^T first.
// In both, two tour buffers, the inverse tour pos[] and the tour's edge
// terms (fwd[p] = d(p-1, p), bwd[p] = d(p, p-1) and relocate's removal
// term rem[p]) stay in shared memory.  Only the addresses differ: both
// layouts take the same f32 steps in the same order, so they give the same
// bits.
//
// What bounds it on an H100 SXM: the work depends on the data.  Each local
// search round scans (n-2)(n-3)/2 2-opt and about (n-1)^2 relocate deltas
// (3 and 5 adds each); each perturbation round a few n-wide scans.  That is
// about 1e5 operations per round at n=100, and the inputs are n^2 floats
// per matrix, so the roofline bound (operations over 67 TFLOP/s, bytes over
// 3.35 TB/s) is far below what the block's chain of dependent gathers and
// barriers takes: latency and the gathers' shared-memory and L1 traffic
// bound it, not the card's rates.  Measured per phase with clock64() on an
// H100 (PERF.md), the first design (256 threads, candidates by divide over
// the whole nt^2 square, tens of barriers per perturbation round) spent 91%
// of its time in the local search at n=500 (68% in relocate, whose d(j, i)
// gathers walk a column of D) and 66% in the perturbation at n=100.  So:
//  * 1024 threads (32 warps) per block give the gathers four times the
//    warps to hide behind; the block is alone on its SM in both layouts.
//  * The local search walks only valid candidates, flattened over all
//    threads with no divide: 2-opt's triangle folded into a rectangle (row
//    i beside row n-2-i, n-2 cells a row), relocate's (n-1)^2 square;
//    consecutive lanes take consecutive j, so a warp's gathers fall in one
//    or two rows of D.  The per-row terms come from the edge arrays, which
//    a move rebuilds only where it changed the tour.  In the global layout
//    relocate's d(j, i) is read from the row of D^T, not a column of D.
//  * The perturbation's scans are n wide, so it runs on the warps that
//    cover the tour (4 at n=100) with a named barrier, and the rest of the
//    block waits for it at one barrier.  A move writes the other tour
//    buffer (one barrier), a city's position comes from pos[] (no scan),
//    every reduction takes one barrier (redux.sync within a warp, then each
//    warp reduces the warps' partials itself, from buffers that alternate),
//    and the tour is re-costed once per perturbation, after its last
//    accepted move (the only re-cost the search reads), by warp 0 alone in
//    moves.tree_sum's order.
// The cost of the search (its running total, the best cost) is kept by
// warp 0, which also copies the best tour straight to the output.
//
// Argmins and argmaxes are lexicographic on (value, row-major index c =
// i*(n+1) + j), first occurrence wins, whichever thread evaluated a
// candidate.  Numerics: the guided weight is D + k*P rounded as multiply,
// round, add (__fmul_rn / __fadd_rn, and the build passes -fmad=false): a
// contracted FMA would flip accept decisions against the twin.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one warp reduces the warps' partials
constexpr int kMaxN = 1024;  // the global layout's range; search/gls_whole.py's MAX_N
constexpr int kSmemCap = 232448;  // bytes a block may use on sm_90
constexpr float kNegEps = -(float)(1e-8 / (1.0 - 1e-5));
constexpr unsigned kFull = 0xffffffffu;

enum Layout { kShared = 0, kGlobal = 1 };

size_t smem_bytes(int n, bool global) {
  const size_t nt = n + 1;
  const size_t mats = global ? 0 : 3 * (size_t)n * n;
  const size_t floats = mats + 3 * nt + 2 * kWarps + 1;  // D P G, fwd bwd rem, red_v, slot
  const size_t ints = 2 * nt + n + 2 * kWarps + 1;       // two tours, pos, red_i, cur
  return (floats + ints) * 4;
}

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
// values; every lane gets the result.  Two redux.sync steps, not a ladder
// of shuffles.
template <bool kMax>
__device__ __forceinline__ void warp_arg(float& v, int& i) {
  const unsigned k = order_key(v);
  const unsigned best = kMax ? __reduce_max_sync(kFull, k) : __reduce_min_sync(kFull, k);
  i = (int)__reduce_min_sync(kFull, k == best ? (unsigned)i : 0xffffffffu);
  v = key_value(best);
}

template <Layout kLayout>
struct Search {
  int n, nt, p2;
  float k;
  const float *D, *DT, *G;  // DT: the global layout's D^T
  float* P;
  float *fwd, *bwd, *rem, *red_v, *slot;
  int *t, *tn, *pos, *red_i;
  int *buf0, *buf1, *cur;  // the two tour buffers; which one is current
  int par;   // which of the two reduction buffers is next
  int nthr;  // threads taking part in this phase: the first nthr of the block

  __device__ void sync() const {
    if (nthr == kThreads) {
      __syncthreads();
    } else {
      asm volatile("bar.sync 1, %0;" ::"r"(nthr) : "memory");
    }
  }

  __device__ float dd(int a, int b) const { return D[a * n + b]; }  // city indices
  __device__ float dcol(int a, int b) const {                       // D(b, a)
    return kLayout == kShared ? D[b * n + a] : DT[a * n + b];
  }
  __device__ float dg(int p, int q) const {  // guided weight D + k*P, positions
    const int a = t[p] * n + t[q];
    return __fadd_rn(D[a], __fmul_rn(k, P[a]));
  }

  // (value, index) argmin or argmax over the phase's threads with one
  // barrier; each of them gets the result.  The buffers alternate, so a warp
  // still reading one never meets the next reduction's writes: another
  // barrier lies between.
  template <bool kMax>
  __device__ void block_arg(float& v, int& i) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = nthr >> 5;
    warp_arg<kMax>(v, i);
    float* rv = red_v + par * kWarps;
    int* ri = red_i + par * kWarps;
    par ^= 1;
    if (lane == 0) { rv[w] = v; ri[w] = i; }
    sync();
    v = lane < nw ? rv[lane] : (kMax ? -CUDART_INF_F : CUDART_INF_F);
    i = lane < nw ? ri[lane] : INT_MAX;
    warp_arg<kMax>(v, i);
  }

  // The tour's cost on D, summed by warp 0 alone (the other warps go on):
  // moves.tree_sum's halving tree over d(q, q+1), zero-padded to p2.  Lane l
  // first reduces its column q = l (mod 32), where the tree's strides >= 32
  // pair entries, walking it in bit-reversed order with a stack of partial
  // sums; strides 16..1 then run in shuffles.  Returns the sum in all lanes.
  __device__ float warp_tour_cost() const {
    const int lane = threadIdx.x & 31;
    auto val = [&](int q) { return q < n ? fwd[q + 1] : 0.f; };
    float x;
    if (p2 <= 32) {
      x = lane < p2 ? val(lane) : 0.f;
    } else {
      const int M = p2 >> 5, lm = 31 - __clz(M);
      float st[5];
      for (int kk = 0; kk < M; ++kk) {
        x = val(lane + 32 * (int)(__brev(kk) >> (32 - lm)));
#pragma unroll
        for (int lv = 0; lv < 5; ++lv) {
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
  // pos[] there and the edge terms next to it, then swaps the buffers.
  template <class Src>
  __device__ void rebuild(int lo, int hi, Src src) {
    for (int p = threadIdx.x; p < nt; p += nthr) {
      const int c = t[src(p)];
      tn[p] = c;
      if (p >= lo && p <= hi && p >= 1 && p < n) pos[c] = p;
      if (p >= 1 && p >= lo - 1 && p <= hi + 1) {
        const int a = t[src(p - 1)];
        fwd[p] = dd(a, c);
        bwd[p] = dd(c, a);
        if (p < n) {
          const int e = t[src(p + 1)];
          rem[p] = __fadd_rn(__fsub_rn(-dd(c, a), dd(e, c)), dd(e, a));
        }
      }
    }
    sync();
    int* s = t;
    t = tn;
    tn = s;
  }

  __device__ void apply_two_opt(int i, int j) {  // reverse positions [i, j-1]
    rebuild(i, j - 1, [=](int p) { return p >= i && p < j ? i + j - 1 - p : p; });
  }

  __device__ void apply_relocate(int i, int j) {  // pop position i, insert at j
    rebuild(min(i, j), max(i, j), [=](int p) {
      if (i < j) return p < i ? p : (p < j ? p + 1 : (p == j ? i : p));
      return p < j ? p : (p == j ? i : (p <= i ? p - 1 : p));
    });
  }

  // 2-opt over the triangle 1 <= i, i+2 <= j <= n-1, folded: row r of the
  // rectangle (1 <= r <= ceil((m-1)/2), m = n-2) holds row i = r (m-r cells)
  // and then row i = m-r (r cells), m cells in all; the thread steps 1024
  // cells at a time without a divide.
  __device__ void best_two_opt(float& v, int& x) {
    v = CUDART_INF_F;
    x = INT_MAX;
    const int m = n - 2, cells = m / 2 * m;  // ceil((m-1)/2) rows
    const int qs = nthr / m, rs = nthr - qs * m;
    int r = 1 + (int)threadIdx.x / m, col = (int)threadIdx.x - (r - 1) * m;
    for (int c = threadIdx.x; c < cells; c += nthr) {
      const bool first = col < m - r;
      const int i = first ? r : m - r, j = first ? r + 2 + col : col + 2;
      if (first || i != r) {
        const int ti = t[i], tim1 = t[i - 1];
        const float delta = __fsub_rn(
            __fsub_rn(__fadd_rn(dd(ti, t[j]), dd(tim1, t[j - 1])), fwd[i]), fwd[j]);
        const int ci = i * nt + j;
        if (delta < kNegEps && lex_less(delta, ci, v, x)) { v = delta; x = ci; }
      }
      col += rs;
      r += qs;
      if (col >= m) { col -= m; ++r; }
    }
    block_arg<false>(v, x);
  }

  // relocate over 1 <= i, j <= n-1, skipping j == i and j == i-1.
  __device__ void best_relocate(float& v, int& x) {
    v = CUDART_INF_F;
    x = INT_MAX;
    const int m = n - 1, cells = m * m;
    const int qs = nthr / m, rs = nthr - qs * m;
    int i = 1 + (int)threadIdx.x / m, j = 1 + (int)threadIdx.x - (i - 1) * m;
    for (int c = threadIdx.x; c < cells; c += nthr) {
      if (i != j && i - j != 1) {
        const int ti = t[i], tj = t[j];
        const float ins = i < j
            ? __fadd_rn(__fadd_rn(-bwd[j + 1], dcol(ti, tj)), dd(ti, t[j + 1]))
            : __fadd_rn(__fadd_rn(-bwd[j], dcol(ti, t[j - 1])), dd(ti, tj));
        const float delta = __fadd_rn(rem[i], ins);
        const int ci = i * nt + j;
        if (delta < kNegEps && lex_less(delta, ci, v, x)) { v = delta; x = ci; }
      }
      j += rs;
      i += qs;
      if (j > m) { j -= m; ++i; }
    }
    block_arg<false>(v, x);
  }

  __device__ void local_search(float& cost, int& moves, int& rounds) {
    for (int r = 0; r < 10 * n; ++r) {
      ++rounds;
      float v;
      int x;
      best_two_opt(v, x);
      const bool f1 = x != INT_MAX;
      if (f1) {
        const int i = x / nt;
        apply_two_opt(i, x - i * nt);
        cost = __fadd_rn(cost, v);
        ++moves;
      }
      best_relocate(v, x);
      const bool f2 = x != INT_MAX;
      if (f2) {
        const int i = x / nt;
        apply_relocate(i, x - i * nt);
        cost = __fadd_rn(cost, v);
        ++moves;
      }
      if (!f1 && !f2) break;
    }
  }

  // o2a 2-opt and then o2a relocate at the endpoint's position, under D + k*P.
  __device__ void endpoint(int node, int& moves, int& made) {
    if (node == 0) return;  // the depot is skipped
    const int i = pos[node];

    float v = CUDART_INF_F;
    int j = INT_MAX;
    const float ci = dg(i - 1, i);
    for (int q = 1 + threadIdx.x; q <= n - 1; q += nthr) {
      if (abs(i - q) < 2) continue;
      const float delta =
          __fsub_rn(__fsub_rn(__fadd_rn(dg(i, q), dg(i - 1, q - 1)), ci), dg(q - 1, q));
      if (delta < kNegEps && lex_less(delta, q, v, j)) { v = delta; j = q; }
    }
    block_arg<false>(v, j);
    if (j != INT_MAX) {
      apply_two_opt(min(i, j), max(i, j));
      ++moves;
      ++made;
    }

    // the reference reuses the position found before the 2-opt
    v = CUDART_INF_F;
    j = INT_MAX;
    const float rm = __fadd_rn(__fsub_rn(-dg(i, i - 1), dg(i + 1, i)), dg(i + 1, i - 1));
    for (int q = 1 + threadIdx.x; q <= n - 1; q += nthr) {
      if (q == i) continue;
      const float ins = q > i ? __fadd_rn(__fadd_rn(-dg(q + 1, q), dg(i, q)), dg(i, q + 1))
                              : __fadd_rn(__fadd_rn(-dg(q, q - 1), dg(i, q - 1)), dg(i, q));
      const float delta = __fadd_rn(rm, ins);
      if (delta < kNegEps && lex_less(delta, q, v, j)) { v = delta; j = q; }
    }
    block_arg<false>(v, j);
    if (j != INT_MAX) {
      apply_relocate(i, j);
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
      for (int q = threadIdx.x; q < n; q += nthr) {
        const int a = t[q] * n + t[q + 1];
        const float util = __fdiv_rn(G[a], __fadd_rn(1.f, P[a]));
        if (lex_greater(util, q, v, q_best)) { v = util; q_best = q; }
      }
      block_arg<true>(v, q_best);
      const int u = t[q_best], w = t[q_best + 1];
      if (threadIdx.x == 0) {
        P[u * n + w] = __fadd_rn(P[u * n + w], 1.f);
        P[w * n + u] = __fadd_rn(P[w * n + u], 1.f);
      }
      sync();
      endpoint(u, moves, made);
      endpoint(w, moves, made);
    }
    // the reference re-costs the tour after every accepted move; only the
    // last of those costs is ever read, so it is taken once, here
    if (made > 0 && threadIdx.x < 32) cost = warp_tour_cost();
  }
};

template <Layout kLayout>
__global__ void __launch_bounds__(kThreads)
gls_whole_kernel(const float* __restrict__ Ds, const float* __restrict__ guides,
                 const int* __restrict__ init, const float* __restrict__ k_in, int n,
                 int n_guides, int n_iters, int pm, float* workspace, int* __restrict__ best_out,
                 float* __restrict__ best_cost_out, int* __restrict__ moves_out,
                 float* __restrict__ trace_c, int* __restrict__ trace_m,
                 int* __restrict__ work_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, nt = n + 1, nn = n * n;
  const bool w0 = threadIdx.x < 32;
  Search<kLayout> s;
  s.n = n;
  s.nt = nt;
  s.p2 = 1;
  while (s.p2 < n) s.p2 <<= 1;
  s.par = 0;
  float* rest = smem;
  const float* D = Ds + (size_t)b * nn;
  const float* Gb = guides + (size_t)b * n_guides * nn;
  if (kLayout == kShared) {
    float* sD = smem;
    s.P = sD + nn;
    float* sG = s.P + nn;
    for (int x = threadIdx.x; x < nn; x += blockDim.x) {
      sD[x] = D[x];
      s.P[x] = 0.f;
      sG[x] = Gb[x];
    }
    s.D = sD;
    s.DT = nullptr;
    s.G = sG;
    rest = sG + nn;
  } else {  // read in place; the caller zeroed this instance's workspace
    s.D = D;
    s.G = Gb;
    s.P = workspace + (size_t)b * 2 * nn;
    float* DT = s.P + nn;
    for (int a = threadIdx.x >> 5; a < n; a += kWarps)
      for (int c = threadIdx.x & 31; c < n; c += 32) DT[a * n + c] = D[c * n + a];
    s.DT = DT;
  }
  s.fwd = rest;
  s.bwd = s.fwd + nt;
  s.rem = s.bwd + nt;
  s.red_v = s.rem + nt;
  s.slot = s.red_v + 2 * kWarps;
  s.buf0 = reinterpret_cast<int*>(s.slot + 1);
  s.buf1 = s.buf0 + nt;
  s.pos = s.buf1 + nt;
  s.red_i = s.pos + n;
  s.cur = s.red_i + 2 * kWarps;
  s.t = s.buf0;
  s.tn = s.buf1;
  s.nthr = kThreads;
  // the perturbation's scans are n wide: it runs on the warps that cover the
  // tour, and the rest of the block waits for it at one barrier
  const int pert_nthr = min(kThreads, (nt + 31) / 32 * 32);

  for (int p = threadIdx.x; p < nt; p += blockDim.x) s.t[p] = init[(size_t)b * nt + p];
  __syncthreads();
  s.rebuild(0, n, [](int p) { return p; });
  if (w0) {
    const float c = s.warp_tour_cost();
    if (threadIdx.x == 0) *s.slot = c;
  }
  __syncthreads();
  float cost = *s.slot;  // every thread: k comes from the cost before the first LS
  s.k = k_in != nullptr ? k_in[b] : __fdiv_rn(__fmul_rn(0.1f, cost), (float)n);
  int moves = 0, ls_rounds = 0, pert_rounds = 0;
  int* best = best_out + (size_t)b * nt;
  s.local_search(cost, moves, ls_rounds);
  float best_cost = cost;  // meaningful in warp 0, which keeps the cost
  if (w0)
    for (int p = threadIdx.x; p < nt; p += 32) best[p] = s.t[p];

  for (int it = 0; it < n_iters; ++it) {
    if (n_guides > 1) {
      const float* Gi = Gb + (size_t)(it % n_guides) * nn;
      if (kLayout == kShared) {
        float* sG = const_cast<float*>(s.G);
        for (int x = threadIdx.x; x < nn; x += blockDim.x) sG[x] = Gi[x];
        __syncthreads();
      } else {
        s.G = Gi;
      }
    }
    if ((int)threadIdx.x < pert_nthr) {
      s.nthr = pert_nthr;
      s.perturbation(pm, cost, moves, pert_rounds);
      if (threadIdx.x == 0) *s.cur = s.t == s.buf1;
    }
    __syncthreads();
    s.nthr = kThreads;
    s.par = 0;
    s.t = *s.cur ? s.buf1 : s.buf0;
    s.tn = *s.cur ? s.buf0 : s.buf1;
    s.local_search(cost, moves, ls_rounds);
    if (w0) {
      if (cost < best_cost) {
        best_cost = cost;
        for (int p = threadIdx.x; p < nt; p += 32) best[p] = s.t[p];
      }
      if (threadIdx.x == 0) {
        trace_c[(size_t)b * n_iters + it] = best_cost;
        trace_m[(size_t)b * n_iters + it] = moves;
      }
    }
  }
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

// layout: 0 shared (n <= gls_whole_max_n()), 1 global (n <= kMaxN; workspace
// is a zeroed (B, 2, n, n) f32 buffer: the penalties, then room for D^T).
// Anything else is refused.  k: null, or a (B,) f32 penalty scale per
// instance in place of 0.1 * (the initial tour's cost on Ds) / n (the
// forced-edge label oracles search a big-M-reduced Ds and take k from the
// unreduced tour).  With n_iters = 0 the traces are empty and may be null.
extern "C" cudaError_t gls_whole_launch(const float* Ds, const float* guides, const int* init,
                                        const float* k, int B, int n, int n_guides,
                                        int n_iters, int pm,
                                        int layout, float* workspace,
                                        int* best, float* best_cost, int* moves,
                                        float* trace_c, int* trace_m, int* work, int device,
                                        cudaStream_t stream) {
  const bool global = layout == kGlobal;
  if (n < 3 || n_guides < 1 || (layout != kShared && layout != kGlobal)) {
    return cudaErrorInvalidValue;
  }
  if (global ? (n > kMaxN || workspace == nullptr) : n > gls_whole_max_n()) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(n, global);
  auto kernel = global ? gls_whole_kernel<kGlobal> : gls_whole_kernel<kShared>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(Ds, guides, init, k, n, n_guides, n_iters, pm, workspace,
                                        best, best_cost, moves, trace_c, trace_m, work);
  return cudaGetLastError();
}
