// GAT group partials with per-head matrix products, one block per (city u, head, batch b).
//
// Replaces the TPU kernel gnngls_tpu/ops/pallas_gat.py::_group_kernel_mxu (K4).
// The same partials as csrc/gat_group.cu (K2): for the g = n-1 edges of the
// group S_u and one head, target i and source j,
//   s_ij = leaky(el_j + er_i, 0.2), s_ii = -3.0e38
//   m_i  = max_j s_ij,  p_ij = exp(s_ij - m_i),  z_i = sum_j p_ij
// and the aggregation as one (g x g) @ (g x F) product per head:
//   num = p @ h_group.
// The plain twin is ops/gat_group.py::gat_group_partials_mxu_plain.
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32; city_edges (n, g) int32.
// Outputs: m, z (B, n, g, H) f32; num (B, n, g, H, F) f32.
//
// What bounds it on an H100 SXM: the same function as K2, so the same bound:
// at B=64, n=100, H=8, F=16 the product alone is 8.0e9 FMA, 0.24 ms at
// 67 TFLOP/s f32, but the sorted prefix sums of ops/gat_sep.py give the same
// partials in 0.012 ms of operations; 0.55 GB moved, 0.16 ms at 3.35 TB/s.
// The bytes bound the function.
//
// Design: the block gathers its group's el, er and the head's (g, F) slice of
// h through city_edges into shared memory, then builds the g x g score tile
// there, rows padded to an odd stride so that a warp's threads on different
// rows hit different banks.  One warp per row masks the self pair, takes the
// row max (a shuffle reduction: exact), turns the row into p in place and sums
// z.  The product then runs as a SIMT matmul out of shared memory: each thread
// owns a 4-row x 4-feature output tile and accumulates it over the sources
// with explicit f32 FMAs (the build passes -fmad=false), so it reads 8 shared
// words for 16 FMAs.  The tile is g*(g|1)*4 bytes, 39 KB at n=100 and 48.4 KB
// at n=111 (the largest n the route reaches at H*F=128), so the launcher
// raises the dynamic shared-memory limit.  The TPU kernel's lane replication
// of m and z is not needed here.
// Numerics: expf (not __expf), f32 FMAs on CUDA cores, no TF32: the JAX
// package holds this path f32-exact.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // output rows per thread in the product
constexpr int kCols = 4;  // output features per thread in the product
constexpr float kMasked = -3.0e38f;

__device__ __forceinline__ float leaky(float s) { return s > 0.f ? s : 0.2f * s; }

template <int F>
__global__ void __launch_bounds__(kThreads)
gat_group_mxu_kernel(const float* __restrict__ el, const float* __restrict__ er,
                     const float* __restrict__ h, const int* __restrict__ city,
                     int n, int E, int H,
                     float* __restrict__ m_out, float* __restrict__ z_out,
                     float* __restrict__ num_out) {
  const int u = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = n - 1, ld = g | 1;
  extern __shared__ float4 smem4[];
  float* s_h = reinterpret_cast<float*>(smem4);  // (g, F), 16-byte aligned
  float* s_p = s_h + g * F;                      // (g, ld): scores, then p
  float* s_el = s_p + g * ld;
  float* s_er = s_el + g;

  const int* ce = city + (size_t)u * g;
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    const size_t e = (size_t)b * E + ce[j];
    s_el[j] = el[e * H + head];
    s_er[j] = er[e * H + head];
  }
  for (int x = threadIdx.x; x < g * F; x += blockDim.x) {
    const int j = x / F, f = x - j * F;
    const size_t e = (size_t)b * E + ce[j];
    s_h[x] = h[(e * H + head) * F + f];
  }
  __syncthreads();

  // Score tile, row max, p and z: one warp per target row.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = warp; i < g; i += n_warps) {
    float* row = s_p + (size_t)i * ld;
    const float eri = s_er[i];
    float mx = -CUDART_INF_F;
    for (int j = lane; j < g; j += 32) {
      const float s = j == i ? kMasked : leaky(s_el[j] + eri);
      row[j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float zs = 0.f;
    for (int j = lane; j < g; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      zs += p;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) zs += __shfl_xor_sync(0xffffffffu, zs, o);
    if (lane == 0) {
      const size_t r = ((size_t)b * n + u) * g + i;
      m_out[r * H + head] = mx;
      z_out[r * H + head] = zs;
    }
  }
  __syncthreads();

  // num = p @ h: each thread a (kRows x kCols) tile of the (g, F) output.
  constexpr int kColTiles = F / kCols;
  const int n_tiles = (g + kRows - 1) / kRows * kColTiles;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int i0 = t / kColTiles * kRows, f0 = t % kColTiles * kCols;
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    const float* prow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) prow[r] = s_p + (size_t)min(i0 + r, g - 1) * ld;
    for (int j = 0; j < g; ++j) {
      const float4 hv = *reinterpret_cast<const float4*>(s_h + j * F + f0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = prow[r][j];
        acc[r][0] = __fmaf_rn(p, hv.x, acc[r][0]);
        acc[r][1] = __fmaf_rn(p, hv.y, acc[r][1]);
        acc[r][2] = __fmaf_rn(p, hv.z, acc[r][2]);
        acc[r][3] = __fmaf_rn(p, hv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= g) break;
      const size_t row = ((size_t)b * n + u) * g + i;
      float4* dst = reinterpret_cast<float4*>(num_out + (row * H + head) * F + f0);
      *dst = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

template <int F>
cudaError_t launch(const float* el, const float* er, const float* h, const int* city,
                   int B, int n, int E, int H, float* m, float* z, float* num,
                   cudaStream_t stream) {
  const size_t g = n - 1;
  const size_t smem = (g * (g | 1) + g * (F + 2)) * sizeof(float);
  cudaError_t err = grant_smem(gat_group_mxu_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, H, B);
  gat_group_mxu_kernel<F><<<grid, kThreads, smem, stream>>>(el, er, h, city, n, E, H, m, z,
                                                            num);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t gat_group_mxu_launch(const float* el, const float* er, const float* h,
                                            const int* city, int B, int n, int E, int H,
                                            int F, float* m, float* z, float* num,
                                            int device, cudaStream_t stream) {
  if (n < 3) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (F) {
    case 8: return launch<8>(el, er, h, city, B, n, E, H, m, z, num, stream);
    case 16: return launch<16>(el, er, h, city, B, n, E, H, m, z, num, stream);
    case 32: return launch<32>(el, er, h, city, B, n, E, H, m, z, num, stream);
    default: return cudaErrorInvalidValue;
  }
}
