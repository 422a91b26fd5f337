// K7: the stream yardstick, y[i] = sum_{k < nd} d[k, i] * x[i] -- a DIA SpMV
// with every offset zero, so it moves exactly the bytes an ideal SpMV of nd
// diagonals must move ((nd + 2) * n * sizeof(T): every diagonal once, x once,
// y once) and does nothing else.  Its measured rate is the bandwidth a
// kernel of this shape can reach on the card at hand, the figure the SpMV
// kernels' times are held against.
//
// Replaces the Pallas kernel of the JAX package's bench.py: _stream_kernel
// inside stream_loop_impl (f32 output only there, since Mosaic had no f64;
// float and double here, as the flagship's kernels are f64).  The TPU
// kernel's (rows, 512) lane layout, its 128-row blocks and the i + 1 halo
// block of its BlockSpecs were the padded layout of the TPU SpMV it was
// calibrating; vectors are flat (n,) here.
//
// Bound: bytes (HBM bandwidth): nd multiply-adds per 8 * (nd + 2) / nd bytes.
// Design: a grid-stride loop in which each thread owns 16 bytes of the row
// (float4 / double2), so every load and store is a full-width coalesced
// vector access; the nd loads of one element are independent and the loop
// over k is unrolled by 4 to keep several in flight.  Enough blocks (8 per
// SM's worth, capped) to cover DRAM latency.  Rows that are not 16-byte
// aligned (an odd row stride or base pointer) take the scalar kernel; the
// tail past the last whole vector is finished by the same scalar loop.  No
// shared memory, no atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int width = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int width = 2; };

__device__ __forceinline__ void fma_vec(float4& a, const float4& d, const float4& x) {
  a.x += d.x * x.x; a.y += d.y * x.y; a.z += d.z * x.z; a.w += d.w * x.w;
}
__device__ __forceinline__ void fma_vec(double2& a, const double2& d, const double2& x) {
  a.x += d.x * x.x; a.y += d.y * x.y;
}
__device__ __forceinline__ void zero_vec(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero_vec(double2& a) { a = make_double2(0.0, 0.0); }

// rows [begin, n) one element per thread
template <typename T>
__device__ __forceinline__ void stream_scalar(const T* __restrict__ d, int64_t ld,
                                              int nd, const T* __restrict__ x,
                                              T* __restrict__ y, int64_t begin,
                                              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T xi = x[i];
    T acc = T(0);
    for (int k = 0; k < nd; ++k) acc += d[k * ld + i] * xi;
    y[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_scalar_kernel(const T* __restrict__ d, int64_t ld, int nd,
                     const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  stream_scalar<T>(d, ld, nd, x, y, 0, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_vec_kernel(const T* __restrict__ d, int64_t ld, int nd,
                  const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  const int64_t nvec = n / W;
  const int64_t ldv = ld / W;  // ld is a multiple of W on this path
  const V* __restrict__ dv = reinterpret_cast<const V*>(d);
  const V* __restrict__ xv = reinterpret_cast<const V*>(x);
  V* __restrict__ yv = reinterpret_cast<V*>(y);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const V xi = xv[i];
    V acc;
    zero_vec(acc);
#pragma unroll 4
    for (int k = 0; k < nd; ++k) fma_vec(acc, dv[k * ldv + i], xi);
    yv[i] = acc;
  }
  stream_scalar<T>(d, ld, nd, x, y, nvec * W, n);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t launch(const void* d, int64_t ld, int nd, const void* x, void* y,
                   int64_t n, cudaStream_t stream) {
  constexpr int W = Vec<T>::width;
  const bool vec = ld % W == 0 && aligned16(d) && aligned16(x) && aligned16(y);
  const int64_t work = vec ? (n + W - 1) / W : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const T* dp = static_cast<const T*>(d);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vec)
    stream_vec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        dp, ld, nd, xp, yp, n);
  else
    stream_scalar_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        dp, ld, nd, xp, yp, n);
  return cudaGetLastError();
}

}  // namespace

// d (nd, n) with row stride ld, x and y (n,), all on the device.
extern "C" int slepc_stream_sum(int dtype, const void* d, int64_t ld, int nd,
                                const void* x, void* y, int64_t n,
                                void* stream) {
  if (nd < 1 || n < 1 || ld < n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32) return launch<float>(d, ld, nd, x, y, n, s);
  if (dtype == slepc::kF64) return launch<double>(d, ld, nd, x, y, n, s);
  return cudaErrorInvalidValue;
}
