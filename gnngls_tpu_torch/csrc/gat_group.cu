// GAT group partials for the K_n line graph, one block per (city u, head, batch b).
//
// Replaces the TPU kernel gnngls_tpu/ops/pallas_gat.py::_group_kernel (K2).
// For the g = n-1 edges of the group S_u and one head, target i and source j:
//   s_ij = leaky(el_j + er_i, 0.2), j != i
//   m_i  = max_j s_ij,  z_i = sum_j exp(s_ij - m_i),  num_i = sum_j exp(s_ij - m_i) h_j
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32; city_edges (n, g) int32.
// Outputs: m, z (B, n, g, H) f32; num (B, n, g, H, F) f32.
//
// What bounds it on an H100 SXM: at B=64, n=100, H=8, F=16 the sums take
// B*n*g*g*H*F = 8.0e9 FMA (16 GFLOP) on CUDA cores, 0.24 ms at 67 TFLOP/s f32;
// it reads h (162 MB), el and er (20 MB) and writes num (324 MB), m and z
// (40 MB): 0.55 GB, 0.16 ms at 3.35 TB/s.  Compute bounds it.
//
// Design: the block gathers its group's el, er and h rows through city_edges
// into shared memory (g*(F+2)*4 B, 7 KB at n=100), then each thread owns
// target rows i.  Two passes over the sources: the exact row max, then the
// exponentials and sums with the F accumulators in registers.  The second
// recomputation of s costs two operations against an exp and F FMAs, and keeps
// m equal to the plain twin's max.  The TPU kernel's lane replication (every
// per-head scalar copied across F lanes for Mosaic) is not needed here.
// Numerics: expf (not __expf), f32 FMAs on CUDA cores, no TF32.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float leaky(float s) { return s > 0.f ? s : 0.2f * s; }

template <int F>
__global__ void __launch_bounds__(kThreads)
gat_group_kernel(const float* __restrict__ el, const float* __restrict__ er,
                 const float* __restrict__ h, const int* __restrict__ city,
                 int n, int E, int H,
                 float* __restrict__ m_out, float* __restrict__ z_out,
                 float* __restrict__ num_out) {
  const int u = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = n - 1;
  extern __shared__ float smem[];
  float* s_el = smem;
  float* s_er = smem + g;
  float* s_h = smem + 2 * g;  // (g, F)

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

  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    const float eri = s_er[i];
    float mx = -CUDART_INF_F;
    for (int j = 0; j < g; ++j) {
      if (j == i) continue;
      mx = fmaxf(mx, leaky(s_el[j] + eri));
    }
    float zs = 0.f;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    for (int j = 0; j < g; ++j) {
      if (j == i) continue;
      const float p = expf(leaky(s_el[j] + eri) - mx);
      zs += p;
      const float* hj = s_h + j * F;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fmaf_rn(p, hj[f], acc[f]);
    }
    const size_t row = ((size_t)b * n + u) * g + i;
    m_out[row * H + head] = mx;
    z_out[row * H + head] = zs;
    float* dst = num_out + (row * H + head) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) dst[f] = acc[f];
  }
}

template <int F>
cudaError_t launch(const float* el, const float* er, const float* h, const int* city,
                   int B, int n, int E, int H, float* m, float* z, float* num,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(n - 1) * (F + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gat_group_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, H, B);
  gat_group_kernel<F><<<grid, kThreads, smem, stream>>>(el, er, h, city, n, E, H, m, z, num);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t gat_group_launch(const float* el, const float* er, const float* h,
                                        const int* city, int B, int n, int E, int H, int F,
                                        float* m, float* z, float* num, int device,
                                        cudaStream_t stream) {
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
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
