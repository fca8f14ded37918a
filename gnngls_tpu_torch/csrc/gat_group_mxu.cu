// GAT group partials with the aggregation on the tensor cores, one block per
// (city u, batch b) and slice of heads.
//
// Replaces the TPU kernel gnngls_tpu/ops/pallas_gat.py::_group_kernel_mxu (K4).
// The same partials as csrc/gat_group.cu (K2): for the g = n-1 edges of the
// group S_u and each head, target i and source j,
//   s_ij = leaky(el_j + er_i, 0.2), s_ii = -3.0e38
//   m_i  = max_j s_ij,  p_ij = exp(s_ij - m_i),  z_i = sum_j p_ij
// and the aggregation as one (g x g) @ (g x F) product per head:
//   num = p @ h_group.
// The plain twin is ops/gat_group.py::gat_group_partials_mxu_plain.
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32; city_edges (n, g) int32.
// Outputs: m, z (B, n, g, H) f32; num (B, n, g, H, F) f32.
//
// What bounds it on an H100 SXM: the function is K2's, so its bound is: the
// sorted prefix sums of ops/gat_sep.py give the partials in 0.012 ms of
// operations at B=64, n=100, H=8, F=16, and it moves 0.55 GB (h, el, er in;
// m, z, num out), 0.16 ms at 3.35 TB/s.  The bytes bound the function.  This
// dense form computes B*n*H*104^2 = 5.5e8 exponentials (g=99 padded to 104),
// and its products on the tensor cores, 53 GFLOP of TF32 with the padding and
// the three passes below (0.11 ms at 495 TFLOP/s).  It is bound by issuing
// the per-pair work on the CUDA cores, about 18 instructions a pair (add,
// leaky, subtract, expf's 8, z, the split of p) and about 24 with the splits
// of h and the loop: 4.2e8 warp instructions, 0.45 ms at full issue.
//
// Design: the block takes a slice of Hs heads (all H where three such blocks
// fit an SM's shared memory: up to n=111 at H=8 F=16; fewer heads, halving,
// past that) and gathers its g edges' el, er and h rows of Hs*F floats through
// city_edges into shared memory, 16 bytes a thread, so each row of h is read
// once per group.  The rows sit at a stride of Hs*F (+8 where that is a
// multiple of 16 floats), so the fragments a warp reads fall in 32 banks.
// Sources and targets are padded to gp, a multiple of 8 (el = -inf and h = 0
// there: p = 0).  No score tile is built: one warp per head finds el's two
// largest values, and since leaky and f32 rounding are monotone,
// max_{j != i} leaky(el_j + er_i) = leaky(er_i + max_{j != i} el_j), the top
// value or, where it sits at j = i, the second: the dense maximum bit for
// bit.  The product runs transposed, num^T = h^T @ p^T, on mma.sync m16n8k8
// (TF32 in, f32 accumulate): A is h^T, 16 features by 8 sources, B is p^T, 8
// sources by 8 targets.  A warp takes one unit at a time, a head and a run of
// up to 4 tiles of 8 targets (13 tiles at n=100: runs of 3, 3, 3, 4; one
// template per run length, so no tile is guarded), and walks the sources 8
// at a step: it splits the A fragment once for the run, computes each
// p = expf(leaky(el_j + er_i) - m_i) straight into its B fragment registers
// (the self pair set to 0, in the one step that holds it), and issues the
// run's products interleaved, so that consecutive mma are independent.  TF32
// keeps 10 mantissa bits, too few for the f32 bar the JAX package holds this
// path to, so each operand is split into big + small, both rounded as
// cvt.rna.tf32.f32 rounds, and each step accumulates p small x h big, p big x
// h small and big x big (3xTF32, within about 2e-6 of the scale on the card).
// z sums the same registers: each thread its two sources a step, then a
// quad's four partial sums by shuffles.  num leaves from the accumulators,
// each 32-byte sector whole; m and z are staged in shared memory and leave as
// whole rows.  The block has units/rounds warps (rounds = ceil(units / 8)):
// at n=100, 32 units, 256 threads in four rounds, three blocks on an SM (by
// shared memory, 69,664 bytes a block, and registers).  The TPU kernel's lane
// replication of m and z is not needed here.
// Numerics: expf (not __expf); z in f32 on CUDA cores; num in 3xTF32 on the
// tensor cores, within 1e-5 of the largest value of the f32 product.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "smem.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kBlocksPerSm = 3;
constexpr int kTiles = 4;  // the most n8 target tiles a unit holds

// s > 0 ? s : 0.2f * s, in two instructions and with the same bits
__device__ __forceinline__ float leaky(float s) { return fmaxf(s, 0.2f * s); }

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero), without its guard for NaN and infinity: two integer
// instructions in place of four
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a @ b for a 16x8 A, an 8x8 B and a 16x8 f32 D, TF32 operands
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's shared memory, offsets in 4-byte words.
struct Layout {
  int g, gp, nt, ld;  // edges, padded to gp = 8 nt, a row of h
  int el, er, m, z, top, words;
  __host__ __device__ Layout(int n, int Hs, int F) {
    g = n - 1;
    gp = (g + 7) / 8 * 8;
    nt = gp / 8;
    ld = Hs * F + (Hs * F % 16 ? 0 : 8);  // = 8 or 24 mod 32
    el = gp * ld;       // h (gp, ld), then el (Hs, gp)
    er = el + Hs * gp;  // (Hs, gp)
    m = er + Hs * gp;   // (g, Hs)
    z = m + g * Hs;     // (g, Hs)
    top = z + g * Hs;   // per head: largest el, second largest, index of the largest
    words = top + 3 * Hs;
  }
};

// What a warp needs to compute one unit: shared arrays, sizes, the output.
struct Ctx {
  const float *h, *el, *er;
  float *m, *z, *num;
  int ld, gp, g, H, Hs, h0;
  size_t row0;   // the group's first output row
  int gid, tig;  // lane / 4, lane % 4
};

// One unit: T n8 tiles of targets (from tile0) of head hl, all sources.  The
// thread's group gid holds features gid and gid + 8 of A and target
// 8 tile + gid of B; its place tig holds sources j0 = k0 + tig and j1 = j0 + 4.
template <int F, int T>
struct Unit {
  static constexpr int kFt = (F + 15) / 16;  // m16 tiles of a head's features (F=8: half padding)
  float er_i[T], m_i[T], z[T], acc[T][kFt][4];

  // One step of 8 sources; kDiag where a tile's self pairs lie in it (tile td).
  template <bool kDiag>
  __device__ __forceinline__ void step(const Ctx& c, const float* h_h, const float* el_h, int k0,
                                       int td) {
    const int j0 = k0 + c.tig, j1 = j0 + 4;
    const float el0 = el_h[j0], el1 = el_h[j1];
    // A fragment: a0 (feature f, j0), a1 (f + 8, j0), a2 (f, j1), a3 (f + 8, j1)
    uint32_t a_big[kFt][4], a_small[kFt][4];
#pragma unroll
    for (int q = 0; q < kFt; ++q) {
      const float* col = h_h + 16 * q;
      split(col[j0 * c.ld], a_big[q][0], a_small[q][0]);
      split(col[j1 * c.ld], a_big[q][2], a_small[q][2]);
      if (F >= 16) {
        split(col[j0 * c.ld + 8], a_big[q][1], a_small[q][1]);
        split(col[j1 * c.ld + 8], a_big[q][3], a_small[q][3]);
      } else {
        a_big[q][1] = a_small[q][1] = a_big[q][3] = a_small[q][3] = 0u;
      }
    }
    // B fragments: b0 (j0, target i), b1 (j1, target i)
    uint32_t b_big[T][2], b_small[T][2];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float p0 = expf(leaky(el0 + er_i[t]) - m_i[t]);
      float p1 = expf(leaky(el1 + er_i[t]) - m_i[t]);
      if (kDiag && t == td) {  // target i = k0 + gid: its self pair
        if (j0 == k0 + c.gid) p0 = 0.f;
        if (j1 == k0 + c.gid) p1 = 0.f;
      }
      z[t] += p0;
      z[t] += p1;
      split(p0, b_big[t][0], b_small[t][0]);
      split(p1, b_big[t][1], b_small[t][1]);
    }
    // p small x h big, p big x h small, big x big; the tiles' products
    // interleaved so that consecutive mma are independent
#pragma unroll
    for (int q = 0; q < kFt; ++q)
#pragma unroll
      for (int t = 0; t < T; ++t) mma(acc[t][q], a_big[q], b_small[t]);
#pragma unroll
    for (int q = 0; q < kFt; ++q)
#pragma unroll
      for (int t = 0; t < T; ++t) mma(acc[t][q], a_small[q], b_big[t]);
#pragma unroll
    for (int q = 0; q < kFt; ++q)
#pragma unroll
      for (int t = 0; t < T; ++t) mma(acc[t][q], a_big[q], b_big[t]);
  }

  __device__ __forceinline__ void run(const Ctx& c, int hl, int tile0, float top1, float top2,
                                      int ti) {
    const float* el_h = c.el + hl * c.gp;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = (tile0 + t) * 8 + c.gid;
      er_i[t] = c.er[hl * c.gp + i];
      m_i[t] = leaky((i == ti ? top2 : top1) + er_i[t]);
      z[t] = 0.f;
#pragma unroll
      for (int q = 0; q < kFt; ++q) acc[t][q][0] = acc[t][q][1] = acc[t][q][2] = acc[t][q][3] = 0.f;
    }
    const float* h_h = c.h + hl * F + c.gid;
    const int d0 = 8 * tile0, d1 = d0 + 8 * T;
    int k0 = 0;
    for (; k0 < d0; k0 += 8) this->template step<false>(c, h_h, el_h, k0, 0);
    for (; k0 < d1; k0 += 8) this->template step<true>(c, h_h, el_h, k0, k0 / 8 - tile0);
    for (; k0 < c.gp; k0 += 8) this->template step<false>(c, h_h, el_h, k0, 0);

    // z: the quad's four partial sums; D fragment: d0 (feature f, target
    // 8 tile + 2 tig), d1 (f, that target + 1), d2 and d3 (f + 8, the same)
#pragma unroll
    for (int t = 0; t < T; ++t) {
      z[t] += __shfl_xor_sync(0xffffffffu, z[t], 1);
      z[t] += __shfl_xor_sync(0xffffffffu, z[t], 2);
      const int i = (tile0 + t) * 8 + c.gid;
      if (c.tig == 0 && i < c.g) {
        c.m[i * c.Hs + hl] = m_i[t];
        c.z[i * c.Hs + hl] = z[t];
      }
      const int ic = (tile0 + t) * 8 + 2 * c.tig;
#pragma unroll
      for (int q = 0; q < kFt; ++q) {
        float* dst = c.num + ((c.row0 + ic) * c.H + c.h0 + hl) * F + 16 * q + c.gid;
        if (ic < c.g) {
          dst[0] = acc[t][q][0];
          if (F >= 16) dst[8] = acc[t][q][2];
        }
        if (ic + 1 < c.g) {
          dst[c.H * F] = acc[t][q][1];
          if (F >= 16) dst[c.H * F + 8] = acc[t][q][3];
        }
      }
    }
  }
};

// Unit<F, count>::run for count = 1..T (count is the same across the warp).
template <int F, int T>
__device__ __forceinline__ void dispatch(int count, const Ctx& c, int hl, int tile0, float top1,
                                         float top2, int ti) {
  if constexpr (T > 1) {
    if (count < T) {
      dispatch<F, T - 1>(count, c, hl, tile0, top1, top2, ti);
      return;
    }
  }
  Unit<F, T>().run(c, hl, tile0, top1, top2, ti);
}

template <int F>
__global__ void __launch_bounds__(kMaxWarps * 32)
gat_group_mxu_kernel(const float* __restrict__ el, const float* __restrict__ er,
                     const float* __restrict__ h, const int* __restrict__ city,
                     int n, int E, int H, int Hs,
                     float* __restrict__ m_out, float* __restrict__ z_out,
                     float* __restrict__ num_out) {
  const Layout L(n, Hs, F);
  const int u = blockIdx.x, h0 = blockIdx.y * Hs, b = blockIdx.z;
  const int g = L.g, gp = L.gp;
  extern __shared__ float4 smem4[];
  float* s_h = reinterpret_cast<float*>(smem4);
  float* s_el = s_h + L.el;
  float* s_er = s_h + L.er;
  float* s_m = s_h + L.m;
  float* s_z = s_h + L.z;
  float* s_t1 = s_h + L.top;
  float* s_t2 = s_t1 + Hs;
  int* s_ti = reinterpret_cast<int*>(s_t2 + Hs);

  const int* ce = city + (size_t)u * g;
  for (int x = threadIdx.x; x < gp * Hs; x += blockDim.x) {
    const int j = x / Hs, hl = x - j * Hs;
    float vl = -CUDART_INF_F, vr = 0.f;
    if (j < g) {
      const size_t e = ((size_t)b * E + ce[j]) * H + h0 + hl;
      vl = el[e];
      vr = er[e];
    }
    s_el[hl * gp + j] = vl;
    s_er[hl * gp + j] = vr;
  }
  const int pieces = Hs * F / 4;  // float4 pieces of a row of h
  for (int x = threadIdx.x; x < gp * pieces; x += blockDim.x) {
    const int j = x / pieces, c = x - j * pieces;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < g) v = reinterpret_cast<const float4*>(h + (((size_t)b * E + ce[j]) * H + h0) * F)[c];
    reinterpret_cast<float4*>(s_h + j * L.ld)[c] = v;
  }
  __syncthreads();

  // Each head's two largest el values (equal where the top value repeats)
  // and the smallest index of the largest.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int hl = warp; hl < Hs; hl += n_warps) {
    float t1 = -CUDART_INF_F, t2 = -CUDART_INF_F;
    int ti = INT_MAX;
    for (int j = lane; j < g; j += 32) {
      const float v = s_el[hl * gp + j];
      if (v > t1) {
        t2 = t1;
        t1 = v;
        ti = j;
      } else {
        t2 = fmaxf(t2, v);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, t1, o);
      const float o2 = __shfl_xor_sync(0xffffffffu, t2, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ti, o);
      t2 = fmaxf(fminf(t1, o1), fmaxf(t2, o2));
      if (o1 > t1 || (o1 == t1 && oi < ti)) {
        t1 = o1;
        ti = oi;
      }
    }
    if (lane == 0) {
      s_t1[hl] = t1;
      s_t2[hl] = t2;
      s_ti[hl] = ti;
    }
  }
  __syncthreads();

  // num^T = h^T @ p^T: A is h^T (16 features x 8 sources), B is p^T (8
  // sources x 8 targets).  A unit is one head and a run of 1..kTiles n8
  // tiles of targets (a template per count, so no tile is guarded).
  const int groups = (L.nt + kTiles - 1) / kTiles;
  const Ctx c{s_h, s_el, s_er, s_m, s_z, num_out, L.ld, gp, g, H, Hs, h0,
              ((size_t)b * n + u) * g, lane >> 2, lane & 3};
  for (int unit = warp; unit < groups * Hs; unit += n_warps) {
    const int grp = unit / Hs, hl = unit - grp * Hs;
    const int tile0 = grp * L.nt / groups, count = (grp + 1) * L.nt / groups - tile0;
    dispatch<F, kTiles>(count, c, hl, tile0, s_t1[hl], s_t2[hl], s_ti[hl]);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < g * Hs; x += blockDim.x) {
    const int i = x / Hs, hl = x - i * Hs;
    const size_t slot = (c.row0 + i) * H + h0 + hl;
    m_out[slot] = s_m[x];
    z_out[slot] = s_z[x];
  }
}

size_t smem_bytes(int n, int Hs, int F) { return (size_t)Layout(n, Hs, F).words * sizeof(float); }

// The widest slice of heads (H, then halves of it) of which kBlocksPerSm
// blocks fit an SM's shared memory, down to one head.
template <int F>
cudaError_t launch(const float* el, const float* er, const float* h, const int* city,
                   int B, int n, int E, int H, float* m, float* z, float* num,
                   cudaStream_t stream) {
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int Hs = H;
  while (Hs % 2 == 0 && kBlocksPerSm * smem_bytes(n, Hs, F) > limit) Hs /= 2;
  err = grant_smem(gat_group_mxu_kernel<F>, smem_bytes(n, Hs, F));
  if (err != cudaSuccess) return err;
  const int nt = Layout(n, Hs, F).nt;
  const int units = (nt + kTiles - 1) / kTiles * Hs;
  const int rounds = (units + kMaxWarps - 1) / kMaxWarps;
  const int warps = (units + rounds - 1) / rounds;
  dim3 grid(n, H / Hs, B);
  gat_group_mxu_kernel<F><<<grid, warps * 32, smem_bytes(n, Hs, F), stream>>>(
      el, er, h, city, n, E, H, Hs, m, z, num);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t gat_group_mxu_launch(const float* el, const float* er, const float* h,
                                            const int* city, int B, int n, int E, int H,
                                            int F, float* m, float* z, float* num,
                                            int device, cudaStream_t stream) {
  if (n < 3) return cudaErrorInvalidValue;
  // h moves in 16-byte pieces
  if (reinterpret_cast<uintptr_t>(h) % 16) {
    return cudaErrorMisalignedAddress;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (F) {
    case 8: return launch<8>(el, er, h, city, B, n, E, H, m, z, num, stream);
    case 16: return launch<16>(el, er, h, city, B, n, E, H, m, z, num, stream);
    case 32: return launch<32>(el, er, h, city, B, n, E, H, m, z, num, stream);
    default: return cudaErrorInvalidValue;
  }
}
