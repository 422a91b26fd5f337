// K3: the CGS2 panel sweeps on a row-major basis V (K, n) and panel W (b, n):
//   dots          D[k, m] = sum_i V[k, i] W[m, i]
//   update        Wout[m, i] = W[m, i] - sum_k C[k, m] V[k, i]
//   update_dots   both: Wout as above, D = dots of V with Wout, V read once
//
// Replaces the Pallas kernels of slepc_tpu/ops/bv_pallas.py: panel_dots /
// _dots_kernel, panel_update / _update_kernel and panel_update_dots /
// _update_dots_kernel (f32 only on the TPU; templated here over float and
// double, so the f64 flagship's orthogonalization runs through it too).
//
// Bound: bytes.  Each sweep streams the basis once: dots reads (K + b) * n
// elements, update reads (K + b) * n and writes b * n, update_dots the same
// as update.  At the flagship (K = 49, b = 1, n = 10.35M, f64) that is
// 4.1 GB per dots call and 4.2 GB per update / update_dots call, so a CGS2
// column costs three basis reads instead of four.
// Design: a block owns a 128-column tile at a time (grid-stride over tiles).
// Phase A: each thread walks its column down the K rows (coalesced across
// the block), applies the update in registers and, for the dots, parks the
// V tile and the (updated) W tile in shared memory, so V is read from DRAM
// once.  Phase B: each warp reduces whole (k, m) rows of the tile from
// shared memory and adds them into a per-block accumulator in shared
// memory.  The reduction across blocks is a second, deterministic pass
// (per-block partials, then one fixed-order tree per output): no atomics,
// so a run gives the same Ritz values every time.
#include "common.cuh"

namespace {

constexpr int kTile = 128;  // columns per tile == threads per block
constexpr int kMaxB = 8;    // panel width the register arrays hold
constexpr int kReduceThreads = 256;

template <typename T, bool kUpdate, bool kDots>
__global__ void __launch_bounds__(kTile)
panel_kernel(const T* __restrict__ V, int64_t ldv, int K,
             const T* __restrict__ W, int64_t ldw, int b,
             const T* __restrict__ C, T* __restrict__ Wout, int64_t ldo,
             T* __restrict__ partial, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);  // K*b coefficients (update)
  T* acc = Cs + K * b;                     // K*b block sums (dots)
  T* Vs = acc + K * b;                     // K*kTile V tile (dots)
  T* Ws = Vs + K * kTile;                  // b*kTile W tile (dots)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int KB = K * b;

  for (int p = tid; p < KB; p += blockDim.x) {
    if (kUpdate) Cs[p] = C[p];
    if (kDots) acc[p] = T(0);
  }
  __syncthreads();

  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile; i0 < n;
       i0 += static_cast<int64_t>(gridDim.x) * kTile) {
    const int64_t i = i0 + tid;
    const bool in = i < n;
    T w[kMaxB];
#pragma unroll
    for (int m = 0; m < kMaxB; ++m)
      w[m] = (m < b && in) ? W[m * ldw + i] : T(0);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const T v = in ? V[k * ldv + i] : T(0);
      if (kDots) Vs[k * kTile + tid] = v;
      if (kUpdate) {
#pragma unroll
        for (int m = 0; m < kMaxB; ++m)
          if (m < b) w[m] -= Cs[k * b + m] * v;
      }
    }
    if (kUpdate && in) {
#pragma unroll
      for (int m = 0; m < kMaxB; ++m)
        if (m < b) Wout[m * ldo + i] = w[m];
    }
    if (kDots) {
#pragma unroll
      for (int m = 0; m < kMaxB; ++m)
        if (m < b) Ws[m * kTile + tid] = w[m];
      __syncthreads();
      for (int p = warp; p < KB; p += nwarps) {
        const T* vr = Vs + (p / b) * kTile;
        const T* wr = Ws + (p % b) * kTile;
        T s = T(0);
        for (int t = lane; t < kTile; t += 32) s += vr[t] * wr[t];
        s = slepc::warp_sum(s);
        if (lane == 0) acc[p] += s;
      }
      __syncthreads();
    }
  }
  if (kDots) {
    for (int p = tid; p < KB; p += blockDim.x)
      partial[static_cast<int64_t>(p) * gridDim.x + blockIdx.x] = acc[p];
  }
}

// out[p] = sum_g partial[p, g], one block per output, fixed summation order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ partial, int G, T* __restrict__ out) {
  __shared__ T s[kReduceThreads];
  const int p = blockIdx.x;
  T a = T(0);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    a += partial[static_cast<int64_t>(p) * G + g];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int st = blockDim.x / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) s[threadIdx.x] += s[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[p] = s[0];
}

size_t smem_bytes(int mode, int K, int b, size_t elt) {
  const bool dots = mode != 1;
  size_t count = static_cast<size_t>(K) * b;  // Cs (or unused slot)
  if (dots) count += static_cast<size_t>(K) * b + static_cast<size_t>(K + b) * kTile;
  return count * elt;
}

template <typename T, bool kUpdate, bool kDots>
cudaError_t run(const void* V, int64_t ldv, int K, const void* W, int64_t ldw,
                int b, const void* C, void* Wout, int64_t ldo, void* partial,
                int G, void* D, int64_t n, cudaStream_t stream) {
  const int mode = kUpdate ? (kDots ? 2 : 1) : 0;
  const size_t smem = smem_bytes(mode, K, b, sizeof(T));
  cudaError_t err = slepc::allow_smem(panel_kernel<T, kUpdate, kDots>, smem);
  if (err != cudaSuccess) return err;
  panel_kernel<T, kUpdate, kDots><<<G, kTile, smem, stream>>>(
      static_cast<const T*>(V), ldv, K, static_cast<const T*>(W), ldw, b,
      static_cast<const T*>(C), static_cast<T*>(Wout), ldo,
      static_cast<T*>(partial), n);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDots) return err;
  reduce_partials<T><<<K * b, kReduceThreads, 0, stream>>>(
      static_cast<const T*>(partial), G, static_cast<T*>(D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, const void* V, int64_t ldv, int K,
                     const void* W, int64_t ldw, int b, const void* C,
                     void* Wout, int64_t ldo, void* partial, int G, void* D,
                     int64_t n, cudaStream_t s) {
  switch (mode) {
    case 0:
      return run<T, false, true>(V, ldv, K, W, ldw, b, C, Wout, ldo, partial, G, D, n, s);
    case 1:
      return run<T, true, false>(V, ldv, K, W, ldw, b, C, Wout, ldo, partial, G, D, n, s);
    case 2:
      return run<T, true, true>(V, ldv, K, W, ldw, b, C, Wout, ldo, partial, G, D, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int slepc_panel_tile() { return kTile; }
extern "C" int slepc_panel_max_b() { return kMaxB; }

// mode 0 = dots, 1 = update, 2 = update + dots.  V (K, ldv), W (b, ldw),
// C (K, b) contiguous on the device, Wout (b, ldo), partial (K*b, G) scratch,
// D (K, b) output; G is the launch grid of the sweep kernel.
extern "C" int slepc_panel(int dtype, int mode, const void* V, int64_t ldv,
                           int K, const void* W, int64_t ldw, int b,
                           const void* C, void* Wout, int64_t ldo,
                           void* partial, int G, void* D, int64_t n,
                           void* stream) {
  if (K < 1 || b < 1 || b > kMaxB || G < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32)
    return dispatch<float>(mode, V, ldv, K, W, ldw, b, C, Wout, ldo, partial, G, D, n, s);
  if (dtype == slepc::kF64)
    return dispatch<double>(mode, V, ldv, K, W, ldw, b, C, Wout, ldo, partial, G, D, n, s);
  return cudaErrorInvalidValue;
}
