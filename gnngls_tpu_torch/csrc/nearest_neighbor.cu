// Nearest-neighbour construction (gnngls_tpu_torch/search/construct.py): from
// the depot, always to the unvisited city of least guide value, the lowest id
// on ties, then back to the depot.  One launch builds a batch's tours.
//
// One warp builds one instance's tour, kWarps instances a block.  Lane l owns
// cities l, l + 32, l + 64, ...  Up to kMaxWords * 1024 cities a lane keeps its
// cities' visited flags as bits in registers (bit k of word w flags city
// l + 32 * (32 * w + k)); past that, as bytes in a (B, n) workspace that the
// kernel clears first.  No shared memory, no block barrier.
//
// Each step every lane reads its entries of row `cur` (coalesced when the row
// is contiguous), a chunk of 64 bytes of loads in flight before the first is
// used, keeps its first strict minimum over its unvisited cities in ascending
// order, and the warp picks its least (value, id): the smaller value, the
// lower id on equal values.  f32 takes two `redux.sync` minima, of the value
// as an ordered key and then of the ids that hold it; f64 five shuffle
// rounds.  Lane 0 writes the city.
//
// Comparisons are the type's < and ==, as the plain twin's min and eq: +0.0
// and -0.0 tie, and when every unvisited entry of a row is +inf the pick is
// the lowest id of all cities, visited ones included (each lane starts from
// +inf at its first city), as `torch.where(row == row.min())` and jnp.argmin
// pick it.
//
// The steps are a chain of dependent row reads, so a launch is bound by
// latency, not by bytes: a step costs a round trip to L2 or device memory for
// each chunk (512 f32 or 256 f64 cities) and the warp's minimum.  On an H100
// a step took 0.54 us at n = 100 and 0.77 us at n = 500 (f32).
// It replaces no TPU kernel: JAX's construction is a `lax.scan`.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 4;     // instances a block
constexpr int kMaxWords = 8;  // flags in registers up to n = 32 * 32 * kMaxWords = 8192
// A lane's loads in flight: one chunk, 64 bytes.  Larger chunks read no faster
// and made the f64 steps slower.
template <typename T>
constexpr int kChunk = 64 / sizeof(T);

__host__ __device__ constexpr int register_max_n() { return 32 * 32 * kMaxWords; }

// The warp's least (value, id), ties to the lower id; every lane gets the id.
template <typename T>
__device__ inline int warp_argmin(T best, int at) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T v = __shfl_xor_sync(0xffffffffu, best, o);
    const int j = __shfl_xor_sync(0xffffffffu, at, o);
    if (v < best || (v == best && j < at)) best = v, at = j;
  }
  return at;
}

__device__ inline int warp_argmin(float best, int at) {
  // a key whose unsigned order is the floats' order; both zeros map to one key
  const unsigned u = best == 0.0f ? 0u : __float_as_uint(best);
  const unsigned key = (u & 0x80000000u) ? ~u : u | 0x80000000u;
  const unsigned least = __reduce_min_sync(0xffffffffu, key);
  return (int)__reduce_min_sync(0xffffffffu, key == least ? (unsigned)at : 0xffffffffu);
}

// kWords 32-bit words of flags a lane, in registers; 0: bytes in `seen`.
template <typename T, int kWords>
__global__ void __launch_bounds__(kWarps * 32)
nearest_neighbor_kernel(const T* __restrict__ W, int64_t sb, int64_t si, int64_t sj, int B,
                        int n, int depot, unsigned char* __restrict__ seen,
                        int* __restrict__ tours) {
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= B) return;  // the whole warp: b is the warp's
  const T* Wb = W + b * sb;
  int* tour = tours + (int64_t)b * (n + 1);
  unsigned bits[kWords > 0 ? kWords : 1];
#pragma unroll
  for (int w = 0; w < (kWords > 0 ? kWords : 1); ++w) bits[w] = 0u;
  if constexpr (kWords == 0) {
    seen += (int64_t)b * n;
    for (int j = lane; j < n; j += 32) seen[j] = 0;
  }
  if (lane == 0) tour[0] = tour[n] = depot;
  int cur = depot;
  for (int t = 1; t < n; ++t) {
    if ((cur & 31) == lane) {  // the owner flags the city it left
      if constexpr (kWords == 0) {
        seen[cur] = 1;
      } else {
        const int k = cur >> 5;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          if (w == k >> 5) bits[w] |= 1u << (k & 31);
      }
    }
    const T* row = Wb + cur * si;
    T best = T(INFINITY);
    int at = lane < n ? lane : INT_MAX;
    for (int first = 0; first < n; first += 32 * kChunk<T>) {  // the chunk's first city
      // Every load is issued, unpredicated, before the first is used: a lane
      // past the last city reads it again and ignores it.
      T v[kChunk<T>];
#pragma unroll
      for (int k = 0; k < kChunk<T>; ++k) v[k] = row[min(first + lane + 32 * k, n - 1) * sj];
      unsigned flags = 0u;  // bit k: city first + lane + 32 * k visited
      if constexpr (kWords == 0) {
#pragma unroll
        for (int k = 0; k < kChunk<T>; ++k) {
          if (seen[min(first + lane + 32 * k, n - 1)]) flags |= 1u << k;
        }
      } else {
        const int w = first >> 10;
        unsigned word = bits[0];
#pragma unroll
        for (int i = 1; i < kWords; ++i)
          if (i == w) word = bits[i];
        flags = word >> ((first >> 5) & 31);
      }
#pragma unroll
      for (int k = 0; k < kChunk<T>; ++k) {
        const int j = first + lane + 32 * k;
        if (j < n && !((flags >> k) & 1u) && v[k] < best) best = v[k], at = j;
      }
    }
    cur = warp_argmin(best, at);
    if (lane == 0) tour[t] = cur;
  }
}

template <typename T>
cudaError_t launch(const void* W, int64_t sb, int64_t si, int64_t sj, int B, int n, int depot,
                   unsigned char* seen, int* tours, cudaStream_t stream) {
  const T* w = static_cast<const T*>(W);
  const dim3 grid((B + kWarps - 1) / kWarps), block(kWarps * 32);
  // One word of flags to n = 1024 (every cell's n), eight to 8192, bytes past.
  auto kernel = n <= 1024              ? nearest_neighbor_kernel<T, 1>
                : n <= register_max_n() ? nearest_neighbor_kernel<T, kMaxWords>
                                        : nearest_neighbor_kernel<T, 0>;
  kernel<<<grid, block, 0, stream>>>(w, sb, si, sj, B, n, depot, seen, tours);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace a launch at (B, n) needs: 0 while the flags fit in
// registers, else a byte a city.
extern "C" int64_t nearest_neighbor_workspace_bytes(int B, int n) {
  return n <= register_max_n() ? 0 : (int64_t)B * n;
}

// W (B, n, n) f64 when dbl, else f32, at element strides (sb, si, sj); seen
// nearest_neighbor_workspace_bytes(B, n) bytes; tours (B, n + 1) int32,
// contiguous, written whole.  0 <= depot < n.
extern "C" cudaError_t nearest_neighbor_launch(const void* W, int64_t sb, int64_t si, int64_t sj,
                                               int B, int n, int depot, int dbl,
                                               unsigned char* seen, int* tours, int device,
                                               cudaStream_t stream) {
  if (B < 0 || n < 1 || depot < 0 || depot >= n) return cudaErrorInvalidValue;
  if (n > register_max_n() && seen == nullptr && B > 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || B == 0) return err;
  return dbl ? launch<double>(W, sb, si, sj, B, n, depot, seen, tours, stream)
             : launch<float>(W, sb, si, sj, B, n, depot, seen, tours, stream);
}
