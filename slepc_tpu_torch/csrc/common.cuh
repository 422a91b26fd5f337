// Shared helpers for the slepc_tpu_torch Hopper kernels.
//
// Every C entry point takes a dtype code (0 = float32, 1 = float64,
// 2 = complex64, 3 = complex128), raw device pointers, sizes and the CUDA stream to launch on, launches on that
// stream, allocates nothing, never synchronizes, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace slepc {

enum DType : int { kF32 = 0, kF64 = 1, kC64 = 2, kC128 = 3 };

// Bytes of one element of a dtype code (0 for an unknown code).
inline int elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kF64 || dtype == kC64 ? 8
         : dtype == kC128 ? 16 : 0;
}

// A complex number laid out as PyTorch's complex64 / complex128 (re, im),
// aligned to its size so that one c128 or two c64 are one 16-byte access.
// Trivially default-constructible, so it may live in __shared__ arrays;
// T(0) is a real zero, as for float and double.
template <typename R>
struct alignas(2 * sizeof(R)) Complex {
  R re, im;
  Complex() = default;
  __host__ __device__ constexpr Complex(R r) : re(r), im(R(0)) {}
  __host__ __device__ constexpr Complex(R r, R i) : re(r), im(i) {}
  __host__ __device__ Complex& operator+=(const Complex& b) {
    re += b.re;
    im += b.im;
    return *this;
  }
  __host__ __device__ Complex& operator-=(const Complex& b) {
    re -= b.re;
    im -= b.im;
    return *this;
  }
};

template <typename R>
__host__ __device__ __forceinline__ Complex<R> operator+(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re + b.re, a.im + b.im);
}
template <typename R>
__host__ __device__ __forceinline__ Complex<R> operator-(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re - b.re, a.im - b.im);
}
template <typename R>
__host__ __device__ __forceinline__ Complex<R> operator*(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

using c64 = Complex<float>;
using c128 = Complex<double>;

// conj(a) * b: the term of an inner product <a, b> (a * b for real types).
template <typename T>
__device__ __forceinline__ T conj_mul(T a, T b) { return a * b; }
template <typename R>
__device__ __forceinline__ Complex<R> conj_mul(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re);
}

// The load intrinsics, also for the complex types (one 8- or 16-byte load).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ c64 ldg(const c64* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return c64(v.x, v.y);
}
__device__ __forceinline__ c128 ldg(const c128* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return c128(v.x, v.y);
}
__device__ __forceinline__ float ldcs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ldcs(const double* p) { return __ldcs(p); }
__device__ __forceinline__ c64 ldcs(const c64* p) {
  const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
  return c64(v.x, v.y);
}
__device__ __forceinline__ c128 ldcs(const c128* p) {
  const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
  return c128(v.x, v.y);
}
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ c64 ldcg(const c64* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return c64(v.x, v.y);
}
__device__ __forceinline__ c128 ldcg(const c128* p) {
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
  return c128(v.x, v.y);
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int s, int width = 32) {
  return __shfl_down_sync(0xffffffffu, v, s, width);
}
template <typename R>
__device__ __forceinline__ Complex<R> shfl_down(Complex<R> v, int s, int width = 32) {
  return Complex<R>(__shfl_down_sync(0xffffffffu, v.re, s, width),
                    __shfl_down_sync(0xffffffffu, v.im, s, width));
}

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
  for (int s = 16; s > 0; s >>= 1) v += shfl_down(v, s);
  return v;
}

}  // namespace slepc
