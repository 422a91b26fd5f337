// K1 + K2: DIA (diagonal-offset) SpMV, y[i] = sum_k d_k[i] * x[i + off_k],
// with x taken as zero outside [0, n).  K5 (below): the same operator on b
// vectors at once (K5c: its complex instantiations).
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
//
// K1c / K2c: the same kernel instantiated for complex64 / complex128
// (slepc::Complex, common.cuh), for complex operators.  The TPU ran them
// as split real planes (slepc_tpu/ops/complex_split.py, four real DIA
// passes per apply); here one pass reads each complex diagonal once.
// Bound: bytes, (nd + 2) * n * 8 (c64) or 16 (c128) -- 84 MB for the
// 2^20-row, 3-diagonal c128 non-Hermitian deployment against 151 MB for
// its 7-diagonal, 2^21-row real form.  A complex multiply-add is 8 flops
// per 16 bytes of diagonal and x (c128), far under the FP64 ridge.
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kThreads = 256;
constexpr int kMaxB = 8;  // vectors K5 holds in registers (K3's bound too)

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

// K5: block DIA SpMM, Y[m, i] = sum_k d_k[i] * X[m, i + off_k] for m < b,
// X and Y (b, n) with row strides ldx / ldy (X may be a slice of a taller
// basis: no copy).
//
// Replaces the Pallas kernel of slepc_tpu/ops/dia_pallas.py:309
//   dia_spmv_padded_block / _dia_kernel2b (f32 only on the TPU; the f64
//   blocked cycle there vmapped the double-single single-vector kernel).
// The TPU kernel's sub-block grid, halo rounding, VMEM budget and its vmap
// fallback past one sub-block of row reach were TPU workarounds; K5 has no
// reach limit.
//
// Bound: bytes.  Each diagonal is read ONCE for all b vectors: per call
// (nd + 2b) * n * sizeof(T) bytes from DRAM (diagonals once, X once, Y
// once), against b * (nd + 2) * n for b K1/K2 calls -- 1.24 GB instead of
// 2.98 GB for the f64 flagship at b = 4.
// What held the earlier design (one thread per row, every X value loaded
// from global memory once per diagonal) back: every X element crossed
// L2 -> SM once per diagonal (7 times on the flagship; only the +-1
// neighbours hit L1).  Design now: a
// block owns a tile of `tile` consecutive rows and stages the window
// X[:, i0 - h : i0 + tile + h) of all b rows in shared memory with
// cp.async (16 bytes a copy when X's base and row stride allow it, else one
// element a copy; zero-filled past [0, n), which is how offsets past the
// ends read zero), where h is the largest |offset| of the "near" diagonals
// (the host plan, ops/dia.py plan_spmm, picks them so that at least two
// blocks fit on an SM: +-1 and +-200 on the flagship).  Each "far" offset
// (+-45,000 on the flagship) is read straight from global memory,
// coalesced.  So an X element crosses L2 about 1 + (far offsets) times: 3
// on the flagship instead of 7.  A thread takes RPT = 16 / sizeof(T) rows
// (2 f64, 4 f32) strided by the block width, so every load and store of a
// warp is 32 consecutive elements whatever the alignment, and holds b x
// RPT sums in registers; a diagonal value is read once for all b rows, and
// the sums run over the diagonals in their given order.  No atomics.  The
// one store of each Y element is where an epilogue would go.  Two other
// designs measured slower at b = 4, f64 (PERF.md's findings): staging the
// diagonals and the far windows too, so that all of a tile's loads are
// cp.async (0.727 ms: two blocks an SM, each waiting on its copies), and
// loading eight diagonals' values up front (0.603 ms) against 0.562.  What
// bounds it still: each step of the loop over the diagonals waits on that
// diagonal's loads, and a block's window copy is not overlapped with its
// own sums (only other blocks' work hides it).
//
// K5c: the same kernel instantiated for complex64 / complex128
// (slepc::Complex, common.cuh), Y[m] = A X[m] in native complex
// arithmetic: no conjugate is read.  The TPU ran a complex block as split
// real planes through the real dia_spmv_padded_block; here one pass reads
// each complex diagonal once for all b rows, so a complex block is one
// launch instead of b K1c / K2c launches.  A thread takes 16 bytes of rows
// (RPT = 2 for c64, 1 for c128), and a c128 window holds 16-byte elements:
// the host plan (ops/dia.py plan_spmm) sizes the halo from the element
// size.  Bound: bytes, (nd + 2b) * n * 8 (c64) or 16 (c128); a complex
// multiply-add is 8 flops per 16 bytes of X (c128), far under the FP64
// ridge.
constexpr int kSpmmThreads = 256;

struct SpmmOffsets {
  int64_t off[kMaxDiags];
  unsigned near;  // bit k: diagonal k reads the staged window
};

enum SpmmWhere : int { kDirect = 0, kNear = 1 };

template <typename T>
__host__ __device__ constexpr int spmm_rpt() { return 16 / static_cast<int>(sizeof(T)); }

// Window width (elements) a block stages per X row: [ws, ws + W) with ws
// the 16-byte-aligned start at or below i0 - halo.
template <typename T>
__host__ __device__ inline int spmm_width(int tile, int halo) {
  constexpr int vw = spmm_rpt<T>();
  return (tile + 2 * halo + vw - 1 + vw - 1) / vw * vw;
}

template <typename T, int BT>
__global__ void __launch_bounds__(kSpmmThreads)
dia_spmm_kernel(const T* __restrict__ diags, int64_t ld, SpmmOffsets offs,
                int nd, const T* __restrict__ X, int64_t ldx,
                T* __restrict__ Y, int64_t ldy, int b, int64_t n, int tile,
                int halo, int vec) {
  constexpr int RPT = spmm_rpt<T>();
  constexpr int VW = RPT;  // elements in 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int W = spmm_width<T>(tile, halo);
  int64_t ws = i0 - halo;
  ws = (ws >= 0 ? ws / VW : -((-ws + VW - 1) / VW)) * VW;
  if (offs.near) {
    if (vec) {  // X's base and row stride are 16-byte aligned
      const int chunks = W / VW;
      for (int c = threadIdx.x; c < b * chunks; c += kSpmmThreads) {
        const int m = c / chunks, q = c - m * chunks;
        const int64_t j = ws + static_cast<int64_t>(q) * VW;
        const int64_t valid = j < 0 ? 0 : (n - j < VW ? (n - j > 0 ? n - j : 0) : VW);
        slepc::cp_async<16>(win + m * W + q * VW,
                            X + m * ldx + (valid ? j : 0),
                            static_cast<int>(valid * sizeof(T)));
      }
    } else {
      for (int c = threadIdx.x; c < b * W; c += kSpmmThreads) {
        const int m = c / W, q = c - m * W;
        const int64_t j = ws + q;
        const bool ok = j >= 0 && j < n;
        slepc::cp_async<sizeof(T)>(win + m * W + q, X + m * ldx + (ok ? j : 0),
                                   ok ? static_cast<int>(sizeof(T)) : 0);
      }
    }
    slepc::cp_async_commit();
    slepc::cp_async_wait_all();
    __syncthreads();
  }
  for (int c0 = 0; c0 < tile; c0 += kSpmmThreads * RPT) {
    int64_t row[RPT];
    T acc[BT][RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      row[r] = i0 + c0 + r * kSpmmThreads + threadIdx.x;
#pragma unroll
      for (int m = 0; m < BT; ++m) acc[m][r] = T(0);
    }
    for (int k = 0; k < nd; ++k) {
      const int64_t off = offs.off[k];
      T d[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        d[r] = row[r] < n ? slepc::ldcs(diags + k * ld + row[r]) : T(0);
      if ((offs.near >> k) & 1u) {
        const T* w = win + (row[0] + off - ws);
#pragma unroll
        for (int m = 0; m < BT; ++m)
          if (m < b)
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              acc[m][r] += d[r] * w[m * W + r * kSpmmThreads];
      } else {
#pragma unroll
        for (int m = 0; m < BT; ++m)
          if (m < b)
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const int64_t j = row[r] + off;
              acc[m][r] += d[r] * ((j >= 0 && j < n) ? slepc::ldg(X + m * ldx + j) : T(0));
            }
      }
    }
#pragma unroll
    for (int m = 0; m < BT; ++m)
      if (m < b)
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          if (row[r] < n) Y[m * ldy + row[r]] = acc[m][r];
  }
}

template <typename T, int BT>
cudaError_t launch_block_bt(const void* diags, int64_t ld,
                            const SpmmOffsets& offs, int nd, const void* X,
                            int64_t ldx, void* Y, int64_t ldy, int b, int64_t n,
                            int tile, int halo, cudaStream_t stream) {
  const size_t smem = offs.near
      ? static_cast<size_t>(b) * spmm_width<T>(tile, halo) * sizeof(T) : 0;
  cudaError_t err = slepc::allow_smem(dia_spmm_kernel<T, BT>, smem);
  if (err != cudaSuccess) return err;
  constexpr int vw = spmm_rpt<T>();
  const int vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 && ldx % vw == 0;
  // a c128 element is one 16-byte copy and load: X must be aligned to it
  if (!vec && sizeof(T) == 16) return cudaErrorInvalidValue;
  const int64_t blocks = (n + tile - 1) / tile;
  dia_spmm_kernel<T, BT><<<static_cast<unsigned>(blocks), kSpmmThreads, smem,
                           stream>>>(
      static_cast<const T*>(diags), ld, offs, nd, static_cast<const T*>(X), ldx,
      static_cast<T*>(Y), ldy, b, n, tile, halo, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* diags, int64_t ld, const int64_t* offsets,
                         const int* where, int nd, const void* X, int64_t ldx,
                         void* Y, int64_t ldy, int b, int64_t n, int tile,
                         int halo, cudaStream_t stream) {
  if (tile % (kSpmmThreads * spmm_rpt<T>()) != 0 || halo < 0)
    return cudaErrorInvalidValue;
  SpmmOffsets offs;
  offs.near = 0;
  for (int k = 0; k < nd; ++k) {
    offs.off[k] = offsets[k];
    if (where[k] == kNear) {
      // a near offset must lie inside the staged window
      if (offsets[k] > halo || offsets[k] < -halo) return cudaErrorInvalidValue;
      offs.near |= 1u << k;
    } else if (where[k] != kDirect) {
      return cudaErrorInvalidValue;
    }
  }
  if (b <= 1)
    return launch_block_bt<T, 1>(diags, ld, offs, nd, X, ldx, Y, ldy, b, n, tile, halo, stream);
  if (b <= 2)
    return launch_block_bt<T, 2>(diags, ld, offs, nd, X, ldx, Y, ldy, b, n, tile, halo, stream);
  if (b <= 4)
    return launch_block_bt<T, 4>(diags, ld, offs, nd, X, ldx, Y, ldy, b, n, tile, halo, stream);
  return launch_block_bt<T, 8>(diags, ld, offs, nd, X, ldx, Y, ldy, b, n, tile, halo, stream);
}

}  // namespace

extern "C" int slepc_dia_max_diags() { return kMaxDiags; }
extern "C" int slepc_dia_spmm_max_b() { return kMaxB; }

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
  if (dtype == slepc::kC64)
    return launch<slepc::c64>(diags, ld, offsets, nd, x, y, n, s);
  if (dtype == slepc::kC128)
    return launch<slepc::c128>(diags, ld, offsets, nd, x, y, n, s);
  return cudaErrorInvalidValue;
}

// Shared memory (bytes) a K5 / K5c block stages: b rows of the window.
template <typename T>
int64_t spmm_smem(int b, int tile, int halo) {
  return static_cast<int64_t>(b) * spmm_width<T>(tile, halo) * sizeof(T);
}

extern "C" int64_t slepc_dia_spmm_smem(int dtype, int b, int tile, int halo) {
  if (dtype == slepc::kF32) return spmm_smem<float>(b, tile, halo);
  if (dtype == slepc::kF64) return spmm_smem<double>(b, tile, halo);
  if (dtype == slepc::kC64) return spmm_smem<slepc::c64>(b, tile, halo);
  if (dtype == slepc::kC128) return spmm_smem<slepc::c128>(b, tile, halo);
  return -1;
}

// X (b, ldx) and Y (b, ldy) device arrays, rows contiguous; 1 <= b <= kMaxB;
// where[k]: 1 = diagonal k reads the staged window (|offset| <= halo), 0 =
// device memory directly.
extern "C" int slepc_dia_spmm(int dtype, const void* diags, int64_t ld,
                              const int64_t* offsets, const int* where, int nd,
                              const void* X, int64_t ldx, void* Y, int64_t ldy,
                              int b, int64_t n, int tile, int halo,
                              void* stream) {
  if (nd < 1 || nd > kMaxDiags || n < 1 || b < 1 || b > kMaxB || tile < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == slepc::kF32)
    return launch_block<float>(diags, ld, offsets, where, nd, X, ldx, Y, ldy, b,
                               n, tile, halo, s);
  if (dtype == slepc::kF64)
    return launch_block<double>(diags, ld, offsets, where, nd, X, ldx, Y, ldy,
                                b, n, tile, halo, s);
  if (dtype == slepc::kC64)
    return launch_block<slepc::c64>(diags, ld, offsets, where, nd, X, ldx, Y,
                                    ldy, b, n, tile, halo, s);
  if (dtype == slepc::kC128)
    return launch_block<slepc::c128>(diags, ld, offsets, where, nd, X, ldx, Y,
                                     ldy, b, n, tile, halo, s);
  return cudaErrorInvalidValue;
}
