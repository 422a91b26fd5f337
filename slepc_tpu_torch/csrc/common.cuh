// Shared helpers for the slepc_tpu_torch Hopper kernels.
//
// Every C entry point takes a dtype code (0 = float32, 1 = float64), raw
// device pointers, sizes and the CUDA stream to launch on, launches on that
// stream, allocates nothing, never synchronizes, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace slepc {

enum DType : int { kF32 = 0, kF64 = 1 };

// Dynamic shared memory above the default 48 KB must be opted into per
// kernel before the launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Asynchronous copy of BYTES (16, 8 or 4) from device to shared memory;
// only src_bytes of them are read, the rest is filled with zeros (0 reads
// nothing: gmem must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes) : "memory");
  else if (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

}  // namespace slepc
