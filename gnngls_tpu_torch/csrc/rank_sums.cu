// Rank sums: the adjoint of the sorted-prefix route's reads at rank
// (gnngls_tpu_torch/ops/gat_sep.py, `_AtRank`), in a fixed order.
//
// For each row r (one (batch, city) group) the forward read a sum s (K, H) and
// a payload sh (K, H, F) at the ranks idx (K, H) of the group's K targets,
// many targets to a rank.  The adjoint adds each target's cotangent into its
// rank:
//
//   gs[r, k, h]     = sum over i with idx[r, i, h] == k of g[r, i, h]
//   gsh[r, k, h, f] = sum over i with idx[r, i, h] == k of gh[r, i, h, f]
//
// in increasing i: the order of torch's scatter-add on the CPU (the plain
// twin, `rank_sums_plain`), so the two agree bit for bit.  On the card
// torch's scatter-add accumulates with atomics, in no fixed order.
//
// A block takes one row and a slice of its H * (F + 1) columns; a thread takes
// one column.  The row's ranks are staged in shared memory; each thread walks
// the targets in order, adds each value into its rank's accumulator (shared
// memory, one column per thread, so no two threads touch one), then writes
// its K accumulators out.  Reads and writes of a target row are contiguous
// across the threads.  Ranks must lie in [0, K): the route clamps them so.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kMaxThreads = 128;

__host__ __device__ inline size_t ranks_bytes(int K, int H) {
  return ((size_t)K * H * sizeof(int) + 15) / 16 * 16;
}

template <typename T>
__global__ void rank_sums_kernel(const int64_t* __restrict__ idx, const T* __restrict__ g,
                                 const T* __restrict__ gh, int K, int H, int F,
                                 T* __restrict__ gs, T* __restrict__ gsh) {
  extern __shared__ unsigned char smem[];
  int* rank = reinterpret_cast<int*>(smem);                        // (K, H)
  T* acc = reinterpret_cast<T*>(smem + ranks_bytes(K, H)) + threadIdx.x;  // (K, width)
  const int width = blockDim.x;
  const int64_t r = blockIdx.x;
  for (int e = threadIdx.x; e < K * H; e += width) rank[e] = (int)idx[r * K * H + e];
  for (int k = 0; k < K; ++k) acc[k * width] = T(0);
  __syncthreads();
  const int c = blockIdx.y * width + threadIdx.x;  // the column
  if (c >= H * (F + 1)) return;
  // columns 0 .. HF-1 are the payload's (h, f), the last H the sum's h
  const bool payload = c < H * F;
  const int h = payload ? c / F : c - H * F;
  const int64_t step = payload ? (int64_t)H * F : H;
  const T* src = payload ? gh + r * K * step + c : g + r * K * step + h;
  T* dst = payload ? gsh + r * K * step + c : gs + r * K * step + h;
  for (int i = 0; i < K; ++i) acc[rank[i * H + h] * width] += src[i * step];
  for (int k = 0; k < K; ++k) dst[k * step] = acc[k * width];
}

template <typename T>
cudaError_t launch(const int64_t* idx, const void* g, const void* gh, int R, int K, int H,
                   int F, void* gs, void* gsh, cudaStream_t stream) {
  const int cols = H * (F + 1);
  int width = (cols + (cols + kMaxThreads - 1) / kMaxThreads - 1) /
              ((cols + kMaxThreads - 1) / kMaxThreads);  // even slices of at most 128
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  while (width > 1 && ranks_bytes(K, H) + (size_t)K * width * sizeof(T) > limit)
    width = (width + 1) / 2;
  const size_t bytes = ranks_bytes(K, H) + (size_t)K * width * sizeof(T);
  err = grant_smem(rank_sums_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (cols + width - 1) / width);
  rank_sums_kernel<T><<<grid, width, bytes, stream>>>(
      idx, static_cast<const T*>(g), static_cast<const T*>(gh), K, H, F,
      static_cast<T*>(gs), static_cast<T*>(gsh));
  return cudaGetLastError();
}

}  // namespace

// idx (R, K, H) int64, g and gs (R, K, H), gh and gsh (R, K, H, F), all
// contiguous; f64 when dbl, else f32.
extern "C" cudaError_t rank_sums_launch(const int64_t* idx, const void* g, const void* gh,
                                        int R, int K, int H, int F, int dbl, void* gs,
                                        void* gsh, int device, cudaStream_t stream) {
  if (R < 0 || K < 1 || H < 1 || F < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || R == 0) return err;
  return dbl ? launch<double>(idx, g, gh, R, K, H, F, gs, gsh, stream)
             : launch<float>(idx, g, gh, R, K, H, F, gs, gsh, stream);
}
