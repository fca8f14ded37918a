// GAT group partials for the K_n line graph, one block per (city u, batch b)
// and slice of heads.
//
// Replaces the TPU kernel gnngls_tpu/ops/pallas_gat.py::_group_kernel (K2).
// For the g = n-1 edges of the group S_u and each head, target i and source j:
//   s_ij = leaky(el_j + er_i, 0.2), j != i
//   m_i  = max_j s_ij,  z_i = sum_j exp(s_ij - m_i),  num_i = sum_j exp(s_ij - m_i) h_j
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32; city_edges (n, g) int32.
// Outputs: m, z (B, n, g, H) f32; num (B, n, g, H, F) f32.
//
// What bounds it on an H100 SXM: at B=64, n=100, H=8, F=16 this kernel's
// pairwise sums take B*n*g*g*H*F = 8.0e9 FMA (16 GFLOP) on CUDA cores,
// 0.24 ms at 67 TFLOP/s f32, beside 0.5e9 expf; the sorted prefix sums of
// ops/gat_sep.py give the same partials in 0.012 ms of operations.  It reads
// h (162 MB), el and er (20 MB) and writes num (324 MB), m and z (40 MB):
// 0.55 GB, 0.16 ms at 3.35 TB/s.  The bytes bound the function; this dense
// form is bound by issuing its own FMAs and exponentials and by the
// shared-memory reads that feed them.
//
// Design: the block takes a slice of Hs heads (all H where three such
// blocks fit the device's shared memory: up to n=111 at H=8 F=16; fewer
// heads, halving, past that) and gathers its g edges' el and er values and their h rows of
// Hs*F floats through city_edges into shared memory, 16 bytes a thread.
// Each head's F floats sit at a stride of F+4, so the 8 heads a warp reads
// at once fall in different banks.  A thread takes two targets of one head,
// i and i + ceil(g/2), so that each source's h row, read once, feeds both;
// the items run head fastest, so a warp's stores write whole rows of m, z
// and num (512 bytes a row of num at H=8 F=16).  The block has
// items/rounds threads (rounds = ceil(items / 256)), rounded to warps: at
// n=100, 224 threads in two rounds, and three blocks on an SM.  Each target
// runs two passes over the sources, j ascending: the exact row max, then the
// exponentials and sums with the F accumulators in registers.  The
// arithmetic of a target is that of the first kernel (one block per head,
// one target a thread), so m, z and num keep its bits.  The TPU kernel's
// lane replication (every per-head scalar copied across F lanes for Mosaic)
// is not needed here.
// Numerics: expf (not __expf), f32 FMAs on CUDA cores, no TF32.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "smem.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSm = 3;

__device__ __forceinline__ float leaky(float s) { return s > 0.f ? s : 0.2f * s; }

template <int F>
__device__ __forceinline__ void store(float* m_out, float* z_out, float* num_out, size_t slot,
                                      float m, float z, const float* acc) {
  m_out[slot] = m;
  z_out[slot] = z;
  float4* dst = reinterpret_cast<float4*>(num_out + slot * F);
#pragma unroll
  for (int c = 0; c < F / 4; ++c)
    dst[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
}

template <int F>
__global__ void __launch_bounds__(kMaxThreads)
gat_group_kernel(const float* __restrict__ el, const float* __restrict__ er,
                 const float* __restrict__ h, const int* __restrict__ city,
                 int n, int E, int H, int Hs,
                 float* __restrict__ m_out, float* __restrict__ z_out,
                 float* __restrict__ num_out) {
  constexpr int kLd = F + 4;  // a head's features in shared memory, padded
  const int u = blockIdx.x, h0 = blockIdx.y * Hs, b = blockIdx.z;
  const int g = n - 1, row_ld = Hs * kLd, items = g * Hs;
  extern __shared__ float4 smem4[];
  float* s_h = reinterpret_cast<float*>(smem4);  // (g, Hs, kLd)
  float* s_el = s_h + (size_t)g * row_ld;        // (g, Hs)
  float* s_er = s_el + items;                    // (g, Hs)

  const int* ce = city + (size_t)u * g;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    const int j = x / Hs, hl = x - j * Hs;
    const size_t e = (size_t)b * E + ce[j];
    s_el[x] = el[e * H + h0 + hl];
    s_er[x] = er[e * H + h0 + hl];
  }
  constexpr int kChunks = F / 4;  // float4 pieces of one head's features
  for (int x = threadIdx.x; x < items * kChunks; x += blockDim.x) {
    const int jh = x / kChunks, c = x - jh * kChunks;
    const int j = jh / Hs, hl = jh - j * Hs;
    const size_t e = (size_t)b * E + ce[j];
    const float4 v = reinterpret_cast<const float4*>(h + (e * H + h0 + hl) * F)[c];
    reinterpret_cast<float4*>(s_h + j * row_ld + hl * kLd)[c] = v;
  }
  __syncthreads();

  const int half = (g + 1) / 2;
  for (int x = threadIdx.x; x < half * Hs; x += blockDim.x) {
    const int i1 = x / Hs, hl = x - i1 * Hs, i2 = i1 + half;
    const bool two = i2 < g;
    const float er1 = s_er[i1 * Hs + hl], er2 = two ? s_er[i2 * Hs + hl] : 0.f;
    float mx1 = -CUDART_INF_F, mx2 = -CUDART_INF_F;
    for (int j = 0; j < g; ++j) {
      const float elj = s_el[j * Hs + hl];
      if (j != i1) mx1 = fmaxf(mx1, leaky(elj + er1));
      if (j != i2) mx2 = fmaxf(mx2, leaky(elj + er2));
    }
    float z1 = 0.f, z2 = 0.f;
    float acc1[F], acc2[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc1[f] = acc2[f] = 0.f;
    const float* hcol = s_h + hl * kLd;
    for (int j = 0; j < g; ++j) {
      const float elj = s_el[j * Hs + hl];
      float hv[F];
      const float4* hj = reinterpret_cast<const float4*>(hcol + j * row_ld);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 v = hj[c];
        hv[4 * c] = v.x;
        hv[4 * c + 1] = v.y;
        hv[4 * c + 2] = v.z;
        hv[4 * c + 3] = v.w;
      }
      if (j != i1) {
        const float p = expf(leaky(elj + er1) - mx1);
        z1 += p;
#pragma unroll
        for (int f = 0; f < F; ++f) acc1[f] = __fmaf_rn(p, hv[f], acc1[f]);
      }
      if (j != i2) {
        const float p = expf(leaky(elj + er2) - mx2);
        z2 += p;
#pragma unroll
        for (int f = 0; f < F; ++f) acc2[f] = __fmaf_rn(p, hv[f], acc2[f]);
      }
    }
    store<F>(m_out, z_out, num_out, (((size_t)b * n + u) * g + i1) * H + h0 + hl, mx1, z1, acc1);
    if (two)
      store<F>(m_out, z_out, num_out, (((size_t)b * n + u) * g + i2) * H + h0 + hl, mx2, z2, acc2);
  }
}

size_t smem_bytes(int n, int Hs, int F) {
  return (size_t)(n - 1) * Hs * (F + 4 + 2) * sizeof(float);
}

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
  err = grant_smem(gat_group_kernel<F>, smem_bytes(n, Hs, F));
  if (err != cudaSuccess) return err;
  const int items = n / 2 * Hs;  // threads' items: pairs of targets of one head
  const int rounds = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  dim3 grid(n, H / Hs, B);
  gat_group_kernel<F><<<grid, threads, smem_bytes(n, Hs, F), stream>>>(
      el, er, h, city, n, E, H, Hs, m, z, num);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t gat_group_launch(const float* el, const float* er, const float* h,
                                        const int* city, int B, int n, int E, int H, int F,
                                        float* m, float* z, float* num, int device,
                                        cudaStream_t stream) {
  // h and num move in 16-byte pieces
  if (reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(num) % 16) {
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

extern "C" const char* gnngls_cuda_error_string(int err) {
  if (err == kSmemExceeded) return "a block needs more shared memory than the device allows";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
