// Source-chunked GAT group partials, one block per (city u, head, batch b).
//
// Replaces the TPU kernel gnngls_tpu/ops/pallas_gat.py::_group_kernel_chunked
// (K3).  The same partials as csrc/gat_group.cu (K2): for the g = n-1 edges of
// the group S_u and one head, target i and source j,
//   s_ij = leaky(el_j + er_i, 0.2), j != i
//   m_i  = max_j s_ij,  z_i = sum_j exp(s_ij - m_i),  num_i = sum_j exp(s_ij - m_i) h_j
// but with the sources taken in chunks of gs and merged online, flash-style,
// exactly as the TPU kernel does (and the plain twin
// ops/gat_group.py::gat_group_partials_chunked_plain):
//   * the source axis is padded to gp = ceil(g/gs)*gs: a padded source has
//     el = -3.0e38 and h = 0;
//   * the self pair is masked to -3.0e38 at the global source index
//     k*gs + j == i, after leaky;
//   * per chunk k: m_k = max, z_k = sum exp(s - m_k), num_k = sum exp(s - m_k) h;
//   * chunk 0 sets the running (m, z, num); a later chunk merges into it:
//     m' = max(m, m_k), z' = z e^(m-m') + z_k e^(m_k-m'), num likewise.
//   A chunk whose only real source is the target itself gets a finite m_k
//   from its padded lanes (leaky(er - 3e38)); the merge weighs it by
//   e^(m_k - m') = 0.
// Inputs: el, er (B, E, H) f32; h (B, E, H, F) f32; city_edges (n, g) int32.
// Outputs: m, z (B, n, g, H) f32; num (B, n, g, H, F) f32.
//
// Design: each thread owns one target of the current tile of blockDim targets
// and keeps its er and its running (m, z, num[F]) in registers.  For each
// chunk the block gathers the chunk's el and h rows through city_edges into
// shared memory (gs*(F+1)*4 bytes: 1 KB at gs=16, F=16), so shared memory does
// not grow with n, which is what lets K3 run past K2's g*(F+2)*4 bytes.  Per
// chunk two passes over its sources: the exact chunk max, then the
// exponentials and sums.  The merge is written as multiply, multiply, add
// (the build passes -fmad=false) as the twin computes it.
//
// What bounds it on an H100 SXM: at B=16, n=500, H=8, F=16, gs=16 the block
// does B*n*g*gp*H = 1.6e10 (target, source, head) pairs of ~(2F+6) f32
// operations on CUDA cores, 9.0 ms at 67 TFLOP/s; it moves 3.4 GB (num is
// 2 GB), 1.0 ms at 3.35 TB/s.  Compute bounds it.
// Numerics: expf (not __expf), f32 FMAs on CUDA cores for the chunk sums, no
// fast-math.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGs = 256;  // ops/gat_group.py's CHUNKED_MAX_GS
constexpr float kMasked = -3.0e38f;

__device__ __forceinline__ float leaky(float s) { return s > 0.f ? s : 0.2f * s; }

template <int F>
__global__ void __launch_bounds__(kMaxThreads)
gat_group_chunked_kernel(const float* __restrict__ el, const float* __restrict__ er,
                         const float* __restrict__ h, const int* __restrict__ city,
                         int n, int E, int H, int gs,
                         float* __restrict__ m_out, float* __restrict__ z_out,
                         float* __restrict__ num_out) {
  const int u = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = n - 1;
  const int K = (g + gs - 1) / gs;
  extern __shared__ float smem[];
  float* s_el = smem;       // (gs)
  float* s_h = smem + gs;   // (gs, F)
  const int* ce = city + (size_t)u * g;

  for (int i0 = 0; i0 < g; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool active = i < g;
    const float eri = active ? er[((size_t)b * E + ce[i]) * H + head] : 0.f;
    float m = 0.f, z = 0.f, num[F];
#pragma unroll
    for (int f = 0; f < F; ++f) num[f] = 0.f;

    for (int k = 0; k < K; ++k) {
      const int j0 = k * gs;
      __syncthreads();  // the previous chunk is no longer read
      for (int j = threadIdx.x; j < gs; j += blockDim.x) {
        const int gj = j0 + j;
        s_el[j] = gj < g ? el[((size_t)b * E + ce[gj]) * H + head] : kMasked;
      }
      for (int x = threadIdx.x; x < gs * F; x += blockDim.x) {
        const int j = x / F, f = x - j * F, gj = j0 + j;
        s_h[x] = gj < g ? h[(((size_t)b * E + ce[gj]) * H + head) * F + f] : 0.f;
      }
      __syncthreads();
      if (!active) continue;

      float mk = -CUDART_INF_F;
      for (int j = 0; j < gs; ++j) {
        const float s = j0 + j == i ? kMasked : leaky(s_el[j] + eri);
        mk = fmaxf(mk, s);
      }
      float zk = 0.f, numk[F];
#pragma unroll
      for (int f = 0; f < F; ++f) numk[f] = 0.f;
      for (int j = 0; j < gs; ++j) {
        const float s = j0 + j == i ? kMasked : leaky(s_el[j] + eri);
        const float p = expf(s - mk);
        zk += p;
        const float* hj = s_h + j * F;
#pragma unroll
        for (int f = 0; f < F; ++f) numk[f] = __fmaf_rn(p, hj[f], numk[f]);
      }
      if (k == 0) {
        m = mk;
        z = zk;
#pragma unroll
        for (int f = 0; f < F; ++f) num[f] = numk[f];
      } else {
        const float mn = fmaxf(m, mk);
        const float so = expf(m - mn), sk = expf(mk - mn);
        m = mn;
        z = __fadd_rn(__fmul_rn(z, so), __fmul_rn(zk, sk));
#pragma unroll
        for (int f = 0; f < F; ++f) num[f] = __fadd_rn(__fmul_rn(num[f], so), __fmul_rn(numk[f], sk));
      }
    }
    if (active) {
      const size_t row = ((size_t)b * n + u) * g + i;
      m_out[row * H + head] = m;
      z_out[row * H + head] = z;
      float* dst = num_out + (row * H + head) * F;
#pragma unroll
      for (int f = 0; f < F; ++f) dst[f] = num[f];
    }
  }
}

template <int F>
cudaError_t launch(const float* el, const float* er, const float* h, const int* city,
                   int B, int n, int E, int H, int gs, float* m, float* z, float* num,
                   cudaStream_t stream) {
  const int g = n - 1;
  const int threads = g >= kMaxThreads ? kMaxThreads : ((g + 31) / 32) * 32;
  const size_t smem = (size_t)gs * (F + 1) * sizeof(float);
  dim3 grid(n, H, B);
  gat_group_chunked_kernel<F><<<grid, threads, smem, stream>>>(el, er, h, city, n, E, H, gs,
                                                               m, z, num);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t gat_group_chunked_launch(const float* el, const float* er,
                                                const float* h, const int* city, int B, int n,
                                                int E, int H, int F, int gs, float* m,
                                                float* z, float* num, int device,
                                                cudaStream_t stream) {
  if (n < 3 || gs < 1 || gs > kMaxGs) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (F) {
    case 8: return launch<8>(el, er, h, city, B, n, E, H, gs, m, z, num, stream);
    case 16: return launch<16>(el, er, h, city, B, n, E, H, gs, m, z, num, stream);
    case 32: return launch<32>(el, er, h, city, B, n, E, H, gs, m, z, num, stream);
    default: return cudaErrorInvalidValue;
  }
}
