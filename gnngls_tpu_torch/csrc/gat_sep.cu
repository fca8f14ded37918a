// Separable GAT partials through threshold masks, one block per (city u, head, batch b).
//
// Replaces the TPU kernel gnngls_tpu/ops/pallas_gat_sep.py::_sep_kernel (K5).
// For the K = n-1 edges of the group S_u and one head, target i and source j,
// exp(leaky(el_j + er_i)) splits on the sign of X_ij = el_j + er_i into a
// product of a source factor and a target factor, so no score is formed:
//   M  = max_j el_j, j* its FIRST argmax, M2 = max_{j != j*} el_j
//   m_i = leaky((i == j* ? M2 : M) + er_i)          (the exact row max)
//   A_j = e^(el_j - M),  C_j = e^(0.2 (el_j - M))
//   B_i = e^(er_i + M - m_i),  D_i = e^(0.2 (er_i + M) - m_i)
//   P_ij = [X_ij > 0, j != i],  N_ij = [X_ij <= 0, j != i]
//   z_i   = B_i sum_j P_ij A_j     + D_i sum_j N_ij C_j
//   num_i = B_i sum_j P_ij A_j h_j + D_i sum_j N_ij C_j h_j
// The payloads Ah_j = A_j h_j and Ch_j = C_j h_j are f32, or in the fast mode
// bf16: h arrives in bf16 and Ah_j = bf16(bf16(A_j) h_j), as the TPU kernel
// rounds them (pallas_gat_sep.py:95-96).  Every sum accumulates in f32; z
// uses the f32 A and C in both modes.  The plain twin is
// ops/gat_group_sep.py::gat_sep_partials_plain.
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32 or bf16; city_edges (n, K) int32.
// Outputs: m, z (B, n, K, H) f32; num (B, n, K, H, F) f32.
//
// What bounds it on an H100 SXM: at B=4, n=500, H=8, F=16 this kernel's
// masks take B*n*K*(K-1)*H = 4.0e9 (target, source, head) pairs of F+3 f32
// operations (the threshold add and compare, the z add, F payload adds),
// 1.1 ms at 67 TFLOP/s.  The function needs far fewer: sorting el once per
// group turns each mask sum into a prefix sum (ops/gat_sep.py), 0.02 ms of
// operations.  It moves 0.86 GB with f32 features (num is 0.51 GB), 0.26 ms
// at 3.35 TB/s, and 0.74 GB with bf16 ones, 0.22 ms.  The bytes bound the
// function; this mask kernel is bounded by its own operations.
//
// Design: the block gathers el and er through city_edges into shared memory;
// block reductions (warp shuffles, exact) give M, the first argmax and M2.
// A and C, then the two payloads of the group's (K, F) features, go to shared
// memory: K*(4 + 2F)*4 bytes in f32, 72 KB at n=500 and F=16, half the
// payload bytes in bf16, so the launcher raises the dynamic shared-memory
// limit.  Each thread then owns target rows i: for every source j != i it
// adds A_j and Ah_j, or C_j and Ch_j, into f32 registers by the sign of
// el_j + er_i, and writes m, z and num.  Every thread of a warp reads the same
// source j, so the shared reads are broadcasts.  No K x K object exists.
// Numerics: expf (not __expf), no fast-math, no FMA contraction (the build
// passes -fmad=false), the branch test X > 0 as the TPU kernel writes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "smem.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr float kNeg = -3.0e38f;
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float leaky(float s) { return s > 0.f ? s : kSlope * s; }

// The payload A_j * h_jf: an f32 product, or bf16(bf16(A_j) * h_jf).
__device__ __forceinline__ float payload(float a, float hv) { return __fmul_rn(a, hv); }
__device__ __forceinline__ __nv_bfloat16 payload(float a, __nv_bfloat16 hv) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(__float2bfloat16_rn(a)), __bfloat162float(hv)));
}

template <int F>
__device__ __forceinline__ void add_row(float (&acc)[F], const float* p) {
#pragma unroll
  for (int f = 0; f < F; f += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + f);
    acc[f] += v.x;
    acc[f + 1] += v.y;
    acc[f + 2] += v.z;
    acc[f + 3] += v.w;
  }
}

template <int F>
__device__ __forceinline__ void add_row(float (&acc)[F], const __nv_bfloat16* p) {
#pragma unroll
  for (int f = 0; f < F; f += 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + f));
    acc[f] += v.x;
    acc[f + 1] += v.y;
  }
}

// Block-wide max / min; every thread of the block calls it and gets the result.
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();  // an earlier reduction's reads of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : -CUDART_INF_F;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ int block_min(int v, int* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : INT_MAX;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int F, typename T>
__global__ void __launch_bounds__(kMaxThreads)
gat_sep_kernel(const float* __restrict__ el, const float* __restrict__ er,
               const T* __restrict__ h, const int* __restrict__ city, int n, int E, int H,
               float* __restrict__ m_out, float* __restrict__ z_out,
               float* __restrict__ num_out) {
  const int u = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int K = n - 1;
  extern __shared__ float4 smem4[];
  T* s_ah = reinterpret_cast<T*>(smem4);  // (K, F)
  T* s_ch = s_ah + K * F;                 // (K, F)
  float* s_el = reinterpret_cast<float*>(s_ch + K * F);
  float* s_er = s_el + K;
  float* s_a = s_er + K;
  float* s_c = s_a + K;
  float* s_red = s_c + K;                              // 32 floats
  int* s_redi = reinterpret_cast<int*>(s_red + 32);    // 32 ints

  const int* ce = city + (size_t)u * K;
  float mx = -CUDART_INF_F;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const size_t e = (size_t)b * E + ce[j];
    const float v = el[e * H + head];
    s_el[j] = v;
    s_er[j] = er[e * H + head];
    mx = fmaxf(mx, v);
  }
  const float M = block_max(mx, s_red);
  int first = K;  // this thread's first j with el_j == M (it wrote those s_el)
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    if (s_el[j] == M) first = min(first, j);
  const int star = block_min(first, s_redi);
  float mx2 = -CUDART_INF_F;
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    mx2 = fmaxf(mx2, j == star ? kNeg : s_el[j]);
  const float M2 = block_max(mx2, s_red);
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float d = s_el[j] - M;
    s_a[j] = expf(d);
    s_c[j] = expf(kSlope * d);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < K * F; x += blockDim.x) {
    const int j = x / F, f = x - j * F;
    const T hv = h[((size_t)((size_t)b * E + ce[j]) * H + head) * F + f];
    s_ah[x] = payload(s_a[j], hv);
    s_ch[x] = payload(s_c[j], hv);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float eri = s_er[i];
    const float mi = leaky((i == star ? M2 : M) + eri);
    const float Bi = expf(eri + M - mi);
    const float Di = expf(kSlope * (eri + M) - mi);
    float zp = 0.f, zn = 0.f, np[F], nn[F];
#pragma unroll
    for (int f = 0; f < F; ++f) np[f] = nn[f] = 0.f;
    for (int j = 0; j < K; ++j) {
      if (j == i) continue;
      if (s_el[j] + eri > 0.f) {
        zp += s_a[j];
        add_row<F>(np, s_ah + j * F);
      } else {
        zn += s_c[j];
        add_row<F>(nn, s_ch + j * F);
      }
    }
    const size_t row = ((size_t)b * n + u) * K + i;
    m_out[row * H + head] = mi;
    z_out[row * H + head] = Bi * zp + Di * zn;
    float4* dst = reinterpret_cast<float4*>(num_out + (row * H + head) * F);
#pragma unroll
    for (int f = 0; f < F; f += 4)
      dst[f / 4] = make_float4(Bi * np[f] + Di * nn[f], Bi * np[f + 1] + Di * nn[f + 1],
                               Bi * np[f + 2] + Di * nn[f + 2], Bi * np[f + 3] + Di * nn[f + 3]);
  }
}

template <int F, typename T>
cudaError_t launch(const float* el, const float* er, const void* h, const int* city, int B,
                   int n, int E, int H, float* m, float* z, float* num, cudaStream_t stream) {
  const int K = n - 1;
  const int threads = K >= kMaxThreads ? kMaxThreads : ((K + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)K * F * sizeof(T) + 4 * (size_t)K * sizeof(float) +
                      32 * sizeof(float) + 32 * sizeof(int);
  cudaError_t err = grant_smem(gat_sep_kernel<F, T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, H, B);
  gat_sep_kernel<F, T><<<grid, threads, smem, stream>>>(
      el, er, static_cast<const T*>(h), city, n, E, H, m, z, num);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f(const float* el, const float* er, const void* h, const int* city, int B,
                     int n, int E, int H, int F, float* m, float* z, float* num,
                     cudaStream_t stream) {
  switch (F) {
    case 8: return launch<8, T>(el, er, h, city, B, n, E, H, m, z, num, stream);
    case 16: return launch<16, T>(el, er, h, city, B, n, E, H, m, z, num, stream);
    case 32: return launch<32, T>(el, er, h, city, B, n, E, H, m, z, num, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fast = 0: h is f32 and the payloads are f32; fast = 1: h is bf16 and so are the payloads.
extern "C" cudaError_t gat_sep_launch(const float* el, const float* er, const void* h,
                                      const int* city, int B, int n, int E, int H, int F,
                                      int fast, float* m, float* z, float* num, int device,
                                      cudaStream_t stream) {
  if (n < 3) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return fast ? launch_f<__nv_bfloat16>(el, er, h, city, B, n, E, H, F, m, z, num, stream)
              : launch_f<float>(el, er, h, city, B, n, E, H, F, m, z, num, stream);
}
