// GAT group partials by sorted prefix sums, one block per (city u, head, batch b).
//
// Replaces two TPU kernels that compute the same partials:
// gnngls_tpu/ops/pallas_gat.py::_group_kernel_chunked (K3, f32) and
// gnngls_tpu/ops/pallas_gat_sep.py::_sep_kernel (K5, f32 or bf16 payloads).
// For the K = n-1 edges of the group S_u and one head, target i and source j,
//   s_ij = leaky(el_j + er_i, 0.2), j != i
//   m_i = max_j s_ij,  z_i = sum_j exp(s_ij - m_i),  num_i = sum_j exp(s_ij - m_i) h_j.
// exp(leaky(el_j + er_i)) splits on the sign of el_j + er_i, and
// el_j + er_i > 0 <=> el_j > -er_i, so each target's sums split at a
// threshold in el (gnngls_tpu/ops/gat_sep.py):
//   M = max_j el_j, j* its FIRST argmax, M2 = max_{j != j*} el_j
//   m_i = leaky((i == j* ? M2 : M) + er_i)          (bit for bit K3's m)
//   A_j = e^(el_j - M),  C_j = e^(0.2 (el_j - M))
//   B_i = e^(er_i + M - m_i),  D_i = e^(0.2 (er_i + M) - m_i)
//   z_i   = B_i sum_{el_j > -er_i, j != i} A_j     + D_i sum_{el_j <= -er_i, j != i} C_j
//   num_i = B_i sum_{el_j > -er_i, j != i} A_j h_j + D_i sum_{el_j <= -er_i, j != i} C_j h_j
// The block sorts the group's el once; the suffix sums of A and Ah and the
// prefix sums of C and Ch in sorted order then give every target's two sums
// at pos_i = #{el_j <= -er_i} (a binary search): the suffix at pos_i, the
// prefix at pos_i - 1.  The suffix is summed directly, never as total minus
// prefix.  The target's own term is taken out in the linear domain as the
// value the scan holds (A_i <= 1 against a sum that holds the row max's
// term, 1).  The one row i = j* per (group, head) has B_i up to e^(M - M2)
// and is computed directly: in f32 as p_j = e^(leaky(el_j + er_j*) - m_j*),
// K3's numerics for any logit spread; with bf16 payloads from the payloads
// times B_j* and D_j*, K5's numerics and K5's envelope (M - M2 < ~80).
// Payloads: f32 Ah = A h, or (fast mode) h in bf16 and
// Ah = bf16(bf16(A) h), as pallas_gat_sep.py:95-96 rounds them; every sum
// is f32, and z uses the f32 A and C in both modes.
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32 or bf16; city_edges (n, K) int32.
// Outputs: m, z (B, n, K, H) f32; num (B, n, K, H, F) f32.
// Plain twin: ops/gat_sorted.py::gat_sorted_partials_plain.
//
// What bounds it on an H100 SXM: per group and head a sort (K log2 K
// compares), O(K F) payload and scan operations and one binary search per
// target; at B=16, n=500, H=8, F=16 that is 0.08 ms at 67 TFLOP/s.  The
// bytes bound it: el, er, h in and m, z, num out, 3.4 GB, 1.03 ms at
// 3.35 TB/s.  Each edge's h row is read by its two groups.
//
// Design.  The block gathers el, er and the edge ids through city_edges
// into shared memory; one block reduction of (max, first argmax, max of the
// rest) gives M, j* and M2, so tied maxima behave as in K5.  A bitonic sort
// of the (el, index) pairs, padded with +inf to a power of two (at least
// 64), orders the group: pair distances of 64 and more through shared
// memory, a barrier each, shorter ones inside a warp's 64-entry chunk with
// shuffles.  cp.async then gathers the h rows in sorted order into shared
// memory with 16-byte copies, while the block forms A and C, scans them
// (each warp its rows in 32-row chunks, then the other warps' totals added)
// and binary-searches every target's threshold.  The payloads are scanned
// down their columns in segments: thread (segment, column) forms and sums
// its segment, the segment totals give each its carry, and a second walk
// writes the running sums in place.  Then one thread per (target, 4
// columns) reads a piece of one suffix row and one prefix row (16-byte
// shared loads), takes its own payload out (its h row read again, from L2)
// and writes num with 16-byte stores, so that a warp's stores cover whole
// 64-byte pieces of 8 targets' rows.  Shared memory holds the keys, the
// per-source and per-target scalars and two (K, FS) f32 payload scans (plus
// the bf16 staging in the fast mode): 90 KB at n=500, FS=F=16 in f32, 106
// KB with bf16 payloads, so two blocks share an SM.  Where a (K, F) pair
// does not fit, the features are scanned in column slices of FS = F/2,
// F/4, ... down to 4; past that the launcher returns kSmemExceeded.
// Narrower slices to fit more blocks on an SM, or 512 threads a block, did
// not make it faster on the card.  No tensor cores: after the sort the
// work is O(K F) adds, and a triangular-matmul scan would bring back K^2
// work.  What holds it above its bound is each block's chain of short
// phases, the sort's shuffles and barriers first (PERF.md section 7).
// Numerics: expf (not __expf), no fast-math, no flush to zero (el_j > -er_i
// must be the same test as el_j + er_i > 0), no FMA contraction (the build
// passes -fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "smem.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float leaky(float s) { return s > 0.f ? s : kSlope * s; }

// The payload A_j * h_jf: an f32 product, or bf16(bf16(A_j) * h_jf), as an f32 value.
__device__ __forceinline__ float payload(float a, float hv) { return __fmul_rn(a, hv); }
__device__ __forceinline__ float payload(float a, __nv_bfloat16 hv) {
  return __bfloat162float(__float2bfloat16_rn(
      __fmul_rn(__bfloat162float(__float2bfloat16_rn(a)), __bfloat162float(hv))));
}

// The group's maximum, its first argmax and the maximum of the others.
struct Top2 {
  float m1;
  int i1;
  float m2;
};

__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  const bool b_first = b.m1 > a.m1 || (b.m1 == a.m1 && b.i1 < a.i1);
  return b_first ? Top2{b.m1, b.i1, fmaxf(a.m1, b.m2)} : Top2{a.m1, a.i1, fmaxf(b.m1, a.m2)};
}

__device__ __forceinline__ Top2 warp_top2(Top2 v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = top2_merge(v, Top2{__shfl_xor_sync(0xffffffffu, v.m1, o),
                           __shfl_xor_sync(0xffffffffu, v.i1, o),
                           __shfl_xor_sync(0xffffffffu, v.m2, o)});
  return v;
}

// Block-wide reductions; every thread of the block calls them and gets the
// result.  red holds 64 floats and redi 32 ints.
__device__ Top2 block_top2(Top2 v, float* red, int* redi) {
  v = warp_top2(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();  // an earlier reduction's reads of red are done
  if (lane == 0) {
    red[warp] = v.m1;
    redi[warp] = v.i1;
    red[32 + warp] = v.m2;
  }
  __syncthreads();
  v = lane < nw ? Top2{red[lane], redi[lane], red[32 + lane]}
                : Top2{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
  return warp_top2(v);
}

__device__ float2 block_sum2(float2 v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) {
    red[warp] = v.x;
    red[32 + warp] = v.y;
  }
  __syncthreads();
  v = lane < nw ? make_float2(red[lane], red[32 + lane]) : make_float2(0.f, 0.f);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// One step of the bitonic network inside a warp: the element at position
// pos and its partner pos ^ j, held by lane ^ j in the same register, end
// in order (ascending where pos & k is 0); equal keys stay where they are.
__device__ __forceinline__ void bitonic_shfl(float& v, int& iv, int pos, int j, int k) {
  const float o = __shfl_xor_sync(0xffffffffu, v, j);
  const int io = __shfl_xor_sync(0xffffffffu, iv, j);
  const bool keep_min = ((pos & j) == 0) == ((pos & k) == 0);
  if (keep_min ? o < v : o > v) {
    v = o;
    iv = io;
  }
}

// Ascending bitonic sort of (key, idx) over Kp >= 64 entries, a power of
// two, in shared memory; every thread of the block calls it.  Pair
// distances of 64 and more go through shared memory, a barrier each;
// shorter ones stay in a warp's 64-entry chunk (lane and lane + 32), in
// registers and shuffles.  Ties end in any order.
__device__ void bitonic_sort(float* key, int* idx, int Kp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int k = 2; k <= Kp; k <<= 1) {
    if (k >= 128) {
      for (int j = k >> 1; j >= 64; j >>= 1) {
        __syncthreads();
        for (int t = threadIdx.x; t < Kp / 2; t += blockDim.x) {
          const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1)), hi = lo + j;
          const float a = key[lo], c = key[hi];
          if ((a > c) == ((lo & k) == 0)) {
            key[lo] = c;
            key[hi] = a;
            const int x = idx[lo];
            idx[lo] = idx[hi];
            idx[hi] = x;
          }
        }
      }
      __syncthreads();
    }
    for (int c = warp; c < Kp / 64; c += nw) {
      const int p = c * 64 + lane;
      float a = key[p], b = key[p + 32];
      int ia = idx[p], ib = idx[p + 32];
      for (int j = k >> 1 < 32 ? k >> 1 : 32; j >= 1; j >>= 1) {
        if (j == 32) {  // both entries are this thread's; p & k is theirs alike
          if ((a > b) == ((p & k) == 0)) {
            const float x = a;
            a = b;
            b = x;
            const int y = ia;
            ia = ib;
            ib = y;
          }
        } else {
          bitonic_shfl(a, ia, p, j, k);
          bitonic_shfl(b, ib, p + 32, j, k);
        }
      }
      key[p] = a;
      key[p + 32] = b;
      idx[p] = ia;
      idx[p + 32] = ib;
    }
    __syncwarp();
  }
  __syncthreads();
}

template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(CB));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 consecutive values of T from global memory, in one 16-byte (f32) or
// 8-byte (bf16) load.
__device__ __forceinline__ void load_quad(float (&dst)[4], const float* src) {
  reinterpret_cast<uint4*>(dst)[0] = __ldg(reinterpret_cast<const uint4*>(src));
}
__device__ __forceinline__ void load_quad(__nv_bfloat16 (&dst)[4], const __nv_bfloat16* src) {
  reinterpret_cast<uint2*>(dst)[0] = __ldg(reinterpret_cast<const uint2*>(src));
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// The sort's length: a power of two, at least one warp's chunk of 64.
__host__ __device__ inline int sort_length(int k) {
  int p = 64;
  while (p < k) p <<= 1;
  return p;
}

// The block's shared memory, in bytes from the start: computed once, here,
// for the kernel's carving and the launcher's size.
struct Layout {
  size_t ah, ch, stage, key, idx, el, er, as, cs, sa, pc, p, pos, own, edge, tot, red, redi, bytes;
  __host__ __device__ Layout(int K, int FS, int tsize, int threads) {
    const size_t pay = (size_t)K * FS * 4, kp = (size_t)sort_length(K) * 4, k4 = (size_t)K * 4;
    ah = 0;
    ch = ah + pay;
    stage = ch + pay;  // bf16 h rows; f32 rows are staged in place in ah
    size_t o = align16(stage + (tsize == 4 ? 0 : (size_t)K * FS * tsize));
    key = o;
    idx = key + kp;
    el = idx + kp;
    er = el + k4;
    as = er + k4;
    cs = as + k4;
    sa = cs + k4;
    pc = sa + k4;
    p = pc + k4;
    pos = p + k4;
    own = pos + k4;
    edge = own + k4;
    tot = edge + k4;  // 4 (threads) segment totals and row-j* sums
    red = tot + 4 * (size_t)threads * 4;
    redi = red + 64 * 4;
    bytes = redi + 32 * 4;
  }
};

template <int FS, typename T>
__global__ void __launch_bounds__(kMaxThreads)
gat_sorted_kernel(const float* __restrict__ el, const float* __restrict__ er,
                  const T* __restrict__ h, const int* __restrict__ city, int n, int E, int H,
                  int F, float* __restrict__ m_out, float* __restrict__ z_out,
                  float* __restrict__ num_out) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kCB = FS * sizeof(T) < 16 ? FS * sizeof(T) : 16;  // bytes per cp.async
  constexpr int kCE = kCB / sizeof(T);                              // elements per cp.async
  const int u = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int K = n - 1, Kp = sort_length(K), tid = threadIdx.x, nt = blockDim.x;
  const Layout L(K, FS, sizeof(T), nt);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* s_ah = reinterpret_cast<float*>(base + L.ah);  // (K, FS): payloads, then suffix sums
  float* s_ch = reinterpret_cast<float*>(base + L.ch);  // (K, FS): payloads, then prefix sums
  T* s_stage = reinterpret_cast<T*>(base + (kF32 ? L.ah : L.stage));  // (K, FS) h rows, sorted
  float* s_key = reinterpret_cast<float*>(base + L.key);  // (Kp) el, sorted
  int* s_idx = reinterpret_cast<int*>(base + L.idx);      // (Kp) source index, sorted
  float* s_el = reinterpret_cast<float*>(base + L.el);    // (K) by source index, then B_i
  float* s_er = reinterpret_cast<float*>(base + L.er);    // (K) by source index, then D_i
  float* s_as = reinterpret_cast<float*>(base + L.as);  // (K) A, C in sorted order
  float* s_cs = reinterpret_cast<float*>(base + L.cs);
  float* s_sa = reinterpret_cast<float*>(base + L.sa);  // (K) suffix sums of A, prefix of C
  float* s_pc = reinterpret_cast<float*>(base + L.pc);
  float* s_p = reinterpret_cast<float*>(base + L.p);    // (K) f32 row j*'s weights, sorted
  int* s_pos = reinterpret_cast<int*>(base + L.pos);    // (K) thresholds by target
  float* s_own = reinterpret_cast<float*>(base + L.own);  // (K) own factor A_i, or -C_i
  int* s_edge = reinterpret_cast<int*>(base + L.edge);    // (K) edge ids by source index
  float* s_tota = reinterpret_cast<float*>(base + L.tot);  // (nt) per (segment, column)
  float* s_totc = s_tota + nt;
  float* s_stx = s_totc + nt;
  float* s_sty = s_stx + nt;
  float* s_red = reinterpret_cast<float*>(base + L.red);
  int* s_redi = reinterpret_cast<int*>(base + L.redi);

  const int* ce = city + (size_t)u * K;
  Top2 top{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
  for (int j = tid; j < Kp; j += nt) {
    if (j < K) {
      const int ej = __ldg(ce + j);
      const size_t e = (size_t)b * E + ej;
      const float v = el[e * H + head];
      s_edge[j] = ej;
      s_el[j] = v;
      s_er[j] = er[e * H + head];
      s_key[j] = v;
      top = top2_merge(top, Top2{v, j, -CUDART_INF_F});
    } else {
      s_key[j] = CUDART_INF_F;
    }
    s_idx[j] = j;
  }
  top = block_top2(top, s_red, s_redi);
  const float M = top.m1, M2 = top.m2;
  const int star = top.i1;
  const float er_star = s_er[star];
  const float m_star = leaky(M2 + er_star);

  bitonic_sort(s_key, s_idx, Kp);

  const int n_slices = F / FS;
  auto stage_rows = [&](int s0) {  // the h rows of columns [s0, s0 + FS), sorted
    constexpr int kPerRow = FS / kCE;
    for (int x = tid; x < K * kPerRow; x += nt) {
      const int r = x / kPerRow, q = x - r * kPerRow;
      const size_t e = (size_t)b * E + s_edge[s_idx[r]];
      cp_async<kCB>(s_stage + r * FS + q * kCE, h + (e * H + head) * F + s0 + q * kCE);
    }
  };
  stage_rows(0);

  // A and C in sorted order and their scans: warp w takes the rows
  // [w * WL, w * WL + WL) in 32-row chunks (prefix of C forwards, suffix of
  // A backwards, a carry across chunks), then adds the other warps' totals
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int WL = (K + nw * 32 - 1) / (nw * 32) * 32;
  const int w0 = min(K, warp * WL), w1 = min(K, w0 + WL);
  float zs = 0.f;  // f32 row j*'s z, this thread's share
  float carry = 0.f;
  for (int c0 = w0; c0 < w1; c0 += 32) {
    const int r = c0 + lane;
    float v = 0.f;
    if (r < w1) {
      const float d = s_key[r] - M;
      const float a = expf(d);
      v = expf(kSlope * d);
      s_as[r] = a;
      s_cs[r] = v;
      if (kF32) {
        const float pr = s_idx[r] == star ? 0.f : expf(leaky(s_key[r] + er_star) - m_star);
        s_p[r] = pr;
        zs += pr;
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    v += carry;
    if (r < w1) s_pc[r] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  const float tot_c = carry;
  carry = 0.f;
  __syncwarp();  // s_as of the warp's rows, written by its other lanes
  for (int c1 = w1 - 1; c1 >= w0; c1 -= 32) {
    const int r = c1 - lane;
    float v = r >= w0 ? s_as[r] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    v += carry;
    if (r >= w0) s_sa[r] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) {
    s_tota[warp] = carry;
    s_totc[warp] = tot_c;
  }
  for (int i = tid; i < K; i += nt) {  // pos_i = #{el_j <= -er_i}
    const float t = -s_er[i];
    int lo = 0, hi = K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_key[mid] <= t) lo = mid + 1;
      else hi = mid;
    }
    s_pos[i] = lo;
  }
  __syncthreads();
  float carry_c = 0.f, carry_a = 0.f;
  for (int w = 0; w < warp; ++w) carry_c += s_totc[w];
  for (int w = nw - 1; w > warp; --w) carry_a += s_tota[w];
  for (int r = w0 + lane; r < w1; r += 32) {
    s_pc[r] += carry_c;
    s_sa[r] += carry_a;
  }
  const int pos_star = s_pos[star];
  // row j*'s z directly: f32 from p, bf16 payloads from B*, D* and the factors
  float zp = 0.f, zn = 0.f;
  if (!kF32) {
    for (int r = tid; r < K; r += nt) {
      if (s_idx[r] != star) {
        if (r >= pos_star) zp += s_as[r];
        else zn += s_cs[r];
      }
    }
  }
  const float B_star = expf(er_star + M - m_star);
  const float D_star = expf(kSlope * (er_star + M) - m_star);
  const float2 zsum = block_sum2(kF32 ? make_float2(zs, 0.f) : make_float2(zp, zn), s_red);
  zs = kF32 ? zsum.x : B_star * zsum.x + D_star * zsum.y;

  for (int i = tid; i < K; i += nt) {
    const float eli = s_el[i], eri = s_er[i];
    const float mi = leaky((i == star ? M2 : M) + eri);
    const size_t row = ((size_t)b * n + u) * K + i;
    m_out[row * H + head] = mi;
    if (i == star) {
      z_out[row * H + head] = zs;
      continue;
    }
    const int pos = s_pos[i];
    const bool self_pos = eli > -eri;
    const float d = eli - M;
    const float own = self_pos ? expf(d) : expf(kSlope * d);
    const float sp = (pos < K ? s_sa[pos] : 0.f) - (self_pos ? own : 0.f);
    const float sn = (pos > 0 ? s_pc[pos - 1] : 0.f) - (self_pos ? 0.f : own);
    const float Bi = expf(eri + M - mi), Di = expf(kSlope * (eri + M) - mi);
    z_out[row * H + head] = Bi * sp + Di * sn;
    s_el[i] = Bi;  // from here on s_el and s_er hold B and D by target
    s_er[i] = Di;
    s_own[i] = self_pos ? own : -own;
  }

  // the payloads, a column slice at a time: thread (segment, column) owns
  // rows [seg * SL, seg * SL + SL) of column c; SL odd keeps the segments of
  // one warp on distinct banks
  const int c = tid % FS, seg = tid / FS, nseg = nt / FS;
  const int SL = ((K + nseg - 1) / nseg) | 1;
  const int r0 = min(K, seg * SL), r1 = min(K, r0 + SL);
  for (int sl = 0; sl < n_slices; ++sl) {
    const int s0 = sl * FS;
    if (sl > 0) stage_rows(s0);
    cp_async_wait_all();
    __syncthreads();
    float ta = 0.f, tc = 0.f, sx = 0.f, sy = 0.f;
    for (int r = r0; r < r1; ++r) {
      const T hv = s_stage[r * FS + c];
      const float ah = payload(s_as[r], hv), ch = payload(s_cs[r], hv);
      if constexpr (kF32) {
        sx += __fmul_rn(s_p[r], hv);
      } else if (s_idx[r] != star) {
        if (r >= pos_star) sx += ah;
        else sy += ch;
      }
      s_ah[r * FS + c] = ah;  // in f32 mode over the staged h this thread just read
      s_ch[r * FS + c] = ch;
      ta += ah;
      tc += ch;
    }
    s_tota[tid] = ta;
    s_totc[tid] = tc;
    s_stx[tid] = sx;
    s_sty[tid] = sy;
    __syncthreads();
    float carry_c = 0.f, carry_a = 0.f;
    for (int q = 0; q < seg; ++q) carry_c += s_totc[q * FS + c];
    for (int q = nseg - 1; q > seg; --q) carry_a += s_tota[q * FS + c];
    for (int r = r0; r < r1; ++r) {
      carry_c += s_ch[r * FS + c];
      s_ch[r * FS + c] = carry_c;
    }
    for (int r = r1 - 1; r >= r0; --r) {
      carry_a += s_ah[r * FS + c];
      s_ah[r * FS + c] = carry_a;
    }
    __syncthreads();

    // one thread per (target, 4 columns): neighbouring threads read and
    // write neighbouring 16-byte pieces of a target's row; each thread
    // starts the h loads of kUnroll pieces before it uses them
    constexpr int kQuads = FS / 4, kUnroll = 2;
    for (int x0 = tid; x0 < K * kQuads; x0 += kUnroll * nt) {
      alignas(16) T hq[kUnroll][4];
#pragma unroll
      for (int v = 0; v < kUnroll; ++v) {
        const int x = x0 + v * nt, i = x / kQuads, q = x - i * kQuads;
        if (x < K * kQuads)
          load_quad(hq[v], h + (((size_t)b * E + s_edge[i]) * H + head) * F + s0 + 4 * q);
      }
#pragma unroll
      for (int v = 0; v < kUnroll; ++v) {
        const int x = x0 + v * nt, i = x / kQuads, q = x - i * kQuads;
        if (x >= K * kQuads) break;
        float out[4];
        if (i == star) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float sxk = 0.f, syk = 0.f;
            for (int g = 0; g < nseg; ++g) {
              sxk += s_stx[g * FS + 4 * q + k];
              syk += s_sty[g * FS + 4 * q + k];
            }
            out[k] = kF32 ? sxk : B_star * sxk + D_star * syk;
          }
        } else {
          const float Bi = s_el[i], Di = s_er[i], own_f = s_own[i];
          const bool self_pos = own_f > 0.f;
          const float self_f = fabsf(own_f);
          const int pos = s_pos[i];
          const float4 vp = pos < K ? reinterpret_cast<const float4*>(s_ah + pos * FS)[q]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 vn = pos > 0 ? reinterpret_cast<const float4*>(s_ch + (pos - 1) * FS)[q]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          const float pv[4] = {vp.x, vp.y, vp.z, vp.w}, nv[4] = {vn.x, vn.y, vn.z, vn.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float own = payload(self_f, hq[v][k]);
            const float np = self_pos ? pv[k] - own : pv[k];
            const float nn = self_pos ? nv[k] : nv[k] - own;
            out[k] = Bi * np + Di * nn;
          }
        }
        const size_t row = ((size_t)b * n + u) * K + i;
        reinterpret_cast<float4*>(num_out + (row * H + head) * F + s0)[q] =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();  // the next slice overwrites the scans
  }
}

__host__ __device__ inline int block_threads(int K) {
  return K >= kMaxThreads ? kMaxThreads : ((K + 31) / 32) * 32;
}

template <int FS, typename T>
cudaError_t launch(const float* el, const float* er, const void* h, const int* city, int B,
                   int n, int E, int H, int F, float* m, float* z, float* num,
                   cudaStream_t stream) {
  const int K = n - 1, threads = block_threads(K);
  const Layout L(K, FS, sizeof(T), threads);
  cudaError_t err = grant_smem(gat_sorted_kernel<FS, T>, L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(n, H, B);
  gat_sorted_kernel<FS, T><<<grid, threads, L.bytes, stream>>>(
      el, er, static_cast<const T*>(h), city, n, E, H, F, m, z, num);
  return cudaGetLastError();
}

// The widest column slice FS (F, F/2, ... 4) whose block fits the device.
template <typename T>
cudaError_t launch_f(const float* el, const float* er, const void* h, const int* city, int B,
                     int n, int E, int H, int F, float* m, float* z, float* num,
                     cudaStream_t stream) {
  if (F != 8 && F != 16 && F != 32) return cudaErrorInvalidValue;
  for (int fs = F; fs >= 4; fs >>= 1) {
    cudaError_t err;
    switch (fs) {
      case 32: err = launch<32, T>(el, er, h, city, B, n, E, H, F, m, z, num, stream); break;
      case 16: err = launch<16, T>(el, er, h, city, B, n, E, H, F, m, z, num, stream); break;
      case 8: err = launch<8, T>(el, er, h, city, B, n, E, H, F, m, z, num, stream); break;
      default: err = launch<4, T>(el, er, h, city, B, n, E, H, F, m, z, num, stream); break;
    }
    if (err != static_cast<cudaError_t>(kSmemExceeded)) return err;
  }
  return static_cast<cudaError_t>(kSmemExceeded);
}

}  // namespace

// fast = 0: h is f32 and the payloads are f32; fast = 1: h is bf16 and so are the payloads.
extern "C" cudaError_t gat_sorted_launch(const float* el, const float* er, const void* h,
                                         const int* city, int B, int n, int E, int H, int F,
                                         int fast, float* m, float* z, float* num, int device,
                                         cudaStream_t stream) {
  if (n < 3) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return fast ? launch_f<__nv_bfloat16>(el, er, h, city, B, n, E, H, F, m, z, num, stream)
              : launch_f<float>(el, er, h, city, B, n, E, H, F, m, z, num, stream);
}

// The largest n whose block, in 4-column slices, fits the device's shared
// memory (fast as in gat_sorted_launch), or -1 when the device cannot be asked.
extern "C" int gat_sorted_max_n(int fast, int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  const int tsize = fast ? 2 : 4;
  int K = 2;
  while (Layout(K, 4, tsize, block_threads(K)).bytes <= (size_t)limit) ++K;
  return K;  // K = n - 1 cities' group no longer fits: n = K is the last that does
}
