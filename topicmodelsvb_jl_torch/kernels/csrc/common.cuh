// Helpers shared by the LDA kernels: block layout and block-wide sums.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tmvb {

// One block per document.  128 threads cover K = 100 topics in one
// pass; larger K loops.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The reference's EPSILON = eps(1e-14) (utils.jl:3), as f32.
constexpr float kEps = 1.6033346880071782e-30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread.  Every thread adds
// the per-warp partials in the same order, so all see the same bits and
// a loop that branches on the result stays uniform.  `red` holds
// kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Clears a failed setup call's error so the next launch check does not
// report it again.
inline int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

// Dynamic shared memory of `bytes` for `kernel`: above the 48 KB default
// only after opting in, and never past the device's opt-in limit.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tmvb
