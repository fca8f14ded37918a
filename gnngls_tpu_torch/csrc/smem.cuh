// Dynamic shared memory for a kernel launch: checked against the device's
// opt-in limit, then granted.
//
// A launcher returns kSmemExceeded (outside cudaError_t's values; mirrored by
// kernels.SMEM_EXCEEDED) when a block needs more shared memory than the
// device allows, so the Python wrapper can raise ValueError for the shape
// instead of reporting a failed launch.  Each launcher computes its layout's
// size once, here passed as `bytes`; no other copy of the formula exists.

#pragma once

#include <cuda_runtime.h>

constexpr int kSmemExceeded = 9000;  // in the enum's range, above cudaErrorUnknown (999)

// The current device's opt-in limit of a block's shared memory, in bytes.
inline cudaError_t smem_limit(size_t* bytes) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = (size_t)limit;
  return err;
}

template <typename Kernel>
inline cudaError_t grant_smem(Kernel kernel, size_t bytes) {
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (bytes > limit) return static_cast<cudaError_t>(kSmemExceeded);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
