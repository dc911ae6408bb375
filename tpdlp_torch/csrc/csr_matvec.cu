// CSR sparse matvec y = M x for Hopper (sm_90a), fp32 and fp64.
//
// Replaces no TPU kernel: the JAX package's sparse layout
// (tpdlp/ops/sparse.py::SparseOp) is a BCOO product that XLA lowers, with
// no Pallas kernel behind it.  This kernel exists because the port's
// SparseOp must replay a solve bit for bit, as the dense and band kernels
// do, and cuSPARSE documents its default CSR SpMV algorithm as one that may
// give slightly different results from run to run.
//
// Bound on this card: HBM bytes.  A launch reads each stored value and its
// column index once (8 bytes a nonzero in fp32, 12 in fp64), the row
// offsets, the x entries the columns name and writes y; it does 2 flops a
// nonzero, far below the fp32 peak for those bytes.  For the 1M-column
// instance of chip_smoke.py (about 10M nonzeros) that is about 90 MB,
// 27 us at the H100 SXM's 3.35 TB/s.
//
// Design: a group of G lanes (G a power of two from 2 to 32, chosen by the
// wrapper from the mean row length) owns one row.  Lane l of the group sums
// the row's nonzeros l, l + G, l + 2G, ... in order with fused multiply-adds,
// reading values and column indices coalesced across the group and x through
// the read-only cache; a __shfl_xor_sync butterfly over the group ends the
// row.  That order depends only on the row's length and G, never on the grid
// or the block order, so repeats are bit-identical on every card.  No
// atomics, no tensor cores.  Rows are short in the LPs this layout serves
// (10-40 nonzeros), so a group does one or two passes: the kernel is simple
// and leaves the row-length imbalance of power-law matrices to a later
// design.
//
// The batch axis (tpdlp_torch/batch: a fleet of LPs that share one sparse
// K).  One launch computes Y[b] = M X[b] for b < batch, X[b] = x + b * ldx
// and Y[b] = y + b * ldy: the groups walk (element, row) pairs, so a row's
// sum is exactly the single launch's.  A single vector runs the kernel
// instantiated without the batch axis (kBatched false), the launch as it
// was before fleets.  M is read once per element (from L2 where it fits).
//
// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// crow has rows + 1 int32 offsets, col and val hold crow[rows] entries, every
// column index lies in [0, cols).  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
template <>
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int G, bool kBatched>
__global__ void __launch_bounds__(kThreads)
    csr_matvec_kernel(const int* __restrict__ crow, const int* __restrict__ col,
                      const T* __restrict__ val, const T* __restrict__ x,
                      T* __restrict__ y, int rows, int batch, int64_t ldx,
                      int64_t ldy) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t row = tid / G;
  if (kBatched) {  // (element, row) pairs
    if (row >= static_cast<int64_t>(rows) * batch) return;  // whole groups
    const int64_t e = row / rows;
    row -= e * rows;
    x += e * ldx;
    y += e * ldy;
  } else if (row >= rows) {
    return;  // whole groups leave together
  }
  const int lane = threadIdx.x & (G - 1);
  // The group's lanes in its warp: the only lanes the butterfly names.
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  const int begin = crow[row];
  const int end = crow[row + 1];
  T acc = T(0);
  for (int k = begin + lane; k < end; k += G) {
    acc = fma_t(val[k], __ldg(x + col[k]), acc);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(mask, acc, off, G);
  }
  if (lane == 0) y[row] = acc;
}

template <typename T, int G>
int launch_g(const int* crow, const int* col, const T* val, const T* x, T* y,
             int rows, int batch, int64_t ldx, int64_t ldy,
             cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(rows) * batch * G;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (batch == 1) {
    csr_matvec_kernel<T, G, false><<<static_cast<unsigned>(blocks),
                                     kThreads, 0, stream>>>(
        crow, col, val, x, y, rows, 1, 0, 0);
  } else {
    csr_matvec_kernel<T, G, true><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(crow, col, val, x, y, rows,
                                                 batch, ldx, ldy);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* crow, const int* col, const T* val, const T* x, T* y,
           int rows, int group, int batch, int64_t ldx, int64_t ldy,
           void* stream_ptr) {
  if (rows <= 0 || batch <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (group) {
    case 2:
      return launch_g<T, 2>(crow, col, val, x, y, rows, batch, ldx, ldy,
                            stream);
    case 4:
      return launch_g<T, 4>(crow, col, val, x, y, rows, batch, ldx, ldy,
                            stream);
    case 8:
      return launch_g<T, 8>(crow, col, val, x, y, rows, batch, ldx, ldy,
                            stream);
    case 16:
      return launch_g<T, 16>(crow, col, val, x, y, rows, batch, ldx, ldy,
                             stream);
    case 32:
      return launch_g<T, 32>(crow, col, val, x, y, rows, batch, ldx, ldy,
                             stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 = launched).
// `group` is the lanes per row: 2, 4, 8, 16 or 32.
int tpdlp_csr_matvec_f32(const int* crow, const int* col, const float* val,
                         const float* x, float* y, int rows, int group,
                         void* stream) {
  return launch<float>(crow, col, val, x, y, rows, group, 1, 0, 0, stream);
}

int tpdlp_csr_matvec_f64(const int* crow, const int* col, const double* val,
                         const double* x, double* y, int rows, int group,
                         void* stream) {
  return launch<double>(crow, col, val, x, y, rows, group, 1, 0, 0, stream);
}

// Y[b] = M X[b] for b < batch in one launch (see the batch axis above).
int tpdlp_csr_matvec_batch_f32(const int* crow, const int* col,
                               const float* val, const float* x, float* y,
                               int rows, int group, int batch, int64_t ldx,
                               int64_t ldy, void* stream) {
  return launch<float>(crow, col, val, x, y, rows, group, batch, ldx, ldy,
                       stream);
}

int tpdlp_csr_matvec_batch_f64(const int* crow, const int* col,
                               const double* val, const double* x, double* y,
                               int rows, int group, int batch, int64_t ldx,
                               int64_t ldy, void* stream) {
  return launch<double>(crow, col, val, x, y, rows, group, batch, ldx, ldy,
                        stream);
}

}  // extern "C"
