// K1 + K2: DIA (diagonal-offset) SpMV, y[i] = sum_k d_k[i] * x[i + off_k],
// with x taken as zero outside [0, n).
//
// Replaces the Pallas kernels of slepc_tpu/ops/dia_pallas.py:
//   dia_spmv_prepared / _dia_kernel, dia_spmv_padded / _dia_kernel2,
//   dia_spmv_padded_v3 / _dia_kernel3p (f32, K1) and
//   dia_spmv_padded_ds / _dia_kernel_ds (f64 in double-single, K2).
// Hopper has native f64, so the f64 instantiation computes in f64 and the
// padded (rows, 512)-lane layout with zero halo blocks is gone: vectors are
// flat (n,) and the bounds check stands in for the halo.
//
// Bound: bytes.  One apply reads every diagonal once and writes y once; x is
// read once from DRAM when the stencil's neighbours hit in L2 (the flagship
// offsets +-1, +-200, +-45000 span 0.7 MB of f64 x, far inside the 50 MB
// L2).  Per call: (nd + 2) * n * sizeof(T) bytes, e.g. 9 * 10.35M * 8 =
// 745 MB for the f64 flagship apply.
// Design: one thread per row in a grid-stride loop, so each diagonal row
// and y are read/written fully coalesced; offsets travel by value in the
// kernel's parameter space.  No shared memory, no atomics.
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kThreads = 256;

struct DiaOffsets {
  int64_t off[kMaxDiags];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ diags, int64_t ld, DiaOffsets offs,
                int nd, const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T acc = T(0);
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + offs.off[k];
      if (j >= 0 && j < n) acc += diags[k * ld + i] * x[j];
    }
    y[i] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* diags, int64_t ld, const int64_t* offsets,
                   int nd, const void* x, void* y, int64_t n,
                   cudaStream_t stream) {
  DiaOffsets offs;
  for (int k = 0; k < nd; ++k) offs.off[k] = offsets[k];
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 16384) blocks = 16384;
  if (blocks < 1) blocks = 1;
  dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(diags), ld, offs, nd, static_cast<const T*>(x),
      static_cast<T*>(y), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int slepc_dia_max_diags() { return kMaxDiags; }

extern "C" const char* slepc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// diags: (nd, ld) device array, row k holds d_k[0:n]; offsets: host array.
extern "C" int slepc_dia_spmv(int dtype, const void* diags, int64_t ld,
                              const int64_t* offsets, int nd, const void* x,
                              void* y, int64_t n, void* stream) {
  if (nd < 1 || nd > kMaxDiags || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32)
    return launch<float>(diags, ld, offsets, nd, x, y, n, s);
  if (dtype == slepc::kF64)
    return launch<double>(diags, ld, offsets, nd, x, y, n, s);
  return cudaErrorInvalidValue;
}
