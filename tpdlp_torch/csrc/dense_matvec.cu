// Exact dense matvec y = M x for Hopper (sm_90a), fp32 and fp64.
//
// Replaces the TPU kernel tpdlp/ops/pallas_dense.py::_matvec_kernel (launched
// through matvec_exact / _matvec_exact_x32).  It computes the same function,
// y = M x with true fp32 (or fp64) multiply-adds, but not the TPU's tiling:
// the (BM, BN) VMEM slabs, the 128-lane padding and the column grid that
// accumulates into a revisited output block exist for VMEM and Mosaic and
// have no counterpart here.
//
// Bound on this card: HBM bytes.  One launch must read M once
// (rows * cols * sizeof(T)) plus x and write y; it does 2 * rows * cols
// flops, far below the fp32 peak for that many bytes.  For the main path
// (mittelmann-s, 2000 x 5000 fp32) that is about 40 MB, i.e. about 12 us at
// the H100 SXM's 3.35 TB/s.
//
// Design against that bound: one pass over M, nothing staged through shared
// memory.  One warp owns one output row; each lane walks the row in 16-byte
// vector loads (float4 / double2) at a stride of 32 vectors, so a warp's
// loads are 512 contiguous bytes, and accumulates with FMAs in a register.
// A fixed __shfl_xor_sync butterfly ends the row.  There are no atomics and
// no split of a row across blocks, so the same input always gives
// bit-identical output (a solve replays exactly).  No tensor cores, no TF32.
//
// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// M is row-major with a row stride `ld` that is a multiple of 4 elements and
// a 16-byte-aligned base, so every row starts on a 16-byte boundary; x is
// 16-byte aligned.  Only the first `cols` entries of a row are read: the
// stride padding is never touched.  The kernel allocates nothing and does
// not synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarp = 32;

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
  __device__ static float dot_acc(const float4 a, const float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
    return acc;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
  __device__ static double dot_acc(const double2 a, const double2 b,
                                   double acc) {
    acc = fma(a.x, b.x, acc);
    acc = fma(a.y, b.y, acc);
    return acc;
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
dense_matvec_kernel(const T* __restrict__ M, const T* __restrict__ x,
                    T* __restrict__ y, int rows, int cols, int64_t ld) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warps leave together

  const T* mrow = M + row * ld;
  const V* mv = reinterpret_cast<const V*>(mrow);
  const V* xv = reinterpret_cast<const V*>(x);
  const int nvec = cols / W;

  T acc = T(0);
#pragma unroll 4
  for (int v = lane; v < nvec; v += kWarp) {
    acc = Vec<T>::dot_acc(__ldg(mv + v), __ldg(xv + v), acc);
  }
  // Ragged tail (cols % W entries), read element by element.
  for (int c = nvec * W + lane; c < cols; c += kWarp) {
    acc = fma(__ldg(mrow + c), __ldg(x + c), acc);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[row] = acc;
}

template <typename T>
int launch(const T* M, const T* x, T* y, int rows, int cols, int64_t ld,
           void* stream) {
  if (rows <= 0) return 0;
  const unsigned blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dense_matvec_kernel<T><<<blocks, kWarpsPerBlock * kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      M, x, y, rows, cols, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 = launched).
int tpdlp_dense_matvec_f32(const float* M, const float* x, float* y, int rows,
                           int cols, int64_t ld, void* stream) {
  return launch<float>(M, x, y, rows, cols, ld, stream);
}

int tpdlp_dense_matvec_f64(const double* M, const double* x, double* y,
                           int rows, int cols, int64_t ld, void* stream) {
  return launch<double>(M, x, y, rows, cols, ld, stream);
}

const char* tpdlp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
