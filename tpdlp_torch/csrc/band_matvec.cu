// Band-slab matvec y = M x for Hopper (sm_90a), fp32 and fp64.
//
// Replaces the TPU kernel tpdlp/ops/band.py::_band_kernel (launched through
// _band_matvec_pallas).  It computes the same function over the same layout:
// M is stored as row groups of R rows, group g as a dense (R, WB) slab whose
// columns are the window [start_g, start_g + WB) of x, and
//
//     y[g*R + r] = sum_w slab[g, r, w] * x[start_g + w]     (x = 0 past n).
//
// It does not copy the TPU's blocking: the 8 groups per grid step, the static
// 128-lane unroll and the window gather done outside the kernel (Mosaic
// forced it) exist for VMEM and Mosaic and have no counterpart here.
//
// Bound on this card: HBM bytes.  A launch must read the live slab rows
// (min(m, ngroups*R) * WB * sizeof(T)), x (each window through L2; the
// windows overlap, so x costs about n elements from HBM) and write y; it
// does 2 flops per slab element, far below the fp32 / fp64 peak for that
// many bytes.  For the 100k-column banded instance of
// tpdlp_torch/bench/band_scale.py that is about 154 MB a product in fp32,
// i.e. about 46 us at the H100 SXM's 3.35 TB/s.
//
// Design against that bound: one pass over the slabs and nothing else of
// size.  One block per row group that holds rows < m.  The block first
// stages its own window x[start_g : start_g + WB] into shared memory (at
// most WB*sizeof(T) bytes: 8 KB fp32 / 16 KB fp64 at WB = 2048), zero past
// n, which removes the window gather pass of the TPU path.  Then each warp
// owns groups of 4 rows; each lane walks the rows in 16-byte vector loads
// (float4 / double2) at a stride of 32 vectors, so a warp's loads are 512
// contiguous bytes per row and 4 rows' loads are in flight at once, and
// accumulates FMAs against the shared window in registers.  A fixed
// __shfl_xor_sync butterfly ends each row.  No atomics and no split of a
// row across blocks, so the same input always gives bit-identical output.
// No tensor cores, no TF32.
//
// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// slabs is a contiguous, 16-byte-aligned (ngroups, R, WB) array with WB a
// multiple of 4 elements, so every slab row starts on a 16-byte boundary;
// ngroups * R >= m; starts is int32 (ngroups,).  Rows >= m are never read
// and y has exactly m entries.  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

// The staged window of x (dynamic shared memory, WB * sizeof(T) bytes).
extern __shared__ __align__(16) unsigned char band_window_smem[];

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kWarp = 32;
constexpr int kRowsPerWarp = 4;  // rows a warp reduces together

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
band_matvec_kernel(const T* __restrict__ slabs,
                   const int32_t* __restrict__ starts,
                   const T* __restrict__ x, T* __restrict__ y, int m, int n,
                   int R, int WB) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  T* win = reinterpret_cast<T*>(band_window_smem);

  const int g = blockIdx.x;
  const int start = __ldg(starts + g);
  for (int w = threadIdx.x; w < WB; w += blockDim.x) {
    const int col = start + w;
    win[w] = static_cast<unsigned>(col) < static_cast<unsigned>(n)
                 ? __ldg(x + col) : T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nvec = WB / W;
  const V* wv = reinterpret_cast<const V*>(win);
  const int64_t row0 = static_cast<int64_t>(g) * R;
  const int rows_here = static_cast<int>(
      min(static_cast<int64_t>(R), static_cast<int64_t>(m) - row0));

  for (int r = warp * kRowsPerWarp; r < rows_here;
       r += kWarpsPerBlock * kRowsPerWarp) {
    const V* sv = reinterpret_cast<const V*>(slabs + (row0 + r) * WB);
    const int live = min(kRowsPerWarp, rows_here - r);  // warp-uniform
    T acc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = T(0);
#pragma unroll 2
    for (int v = lane; v < nvec; v += kWarp) {
      const V xv = wv[v];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (i < live) {
          acc[i] = Vec<T>::dot_acc(__ldg(sv + static_cast<int64_t>(i) * nvec
                                         + v), xv, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
    }
    if (lane < live) {
      T out = acc[0];
#pragma unroll
      for (int i = 1; i < kRowsPerWarp; ++i) {
        if (lane == i) out = acc[i];
      }
      y[row0 + r + lane] = out;
    }
  }
}

template <typename T>
int launch(const T* slabs, const int32_t* starts, const T* x, T* y, int m,
           int n, int R, int WB, void* stream) {
  if (m <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<int64_t>(m) + R - 1) / R);
  const size_t smem = static_cast<size_t>(WB) * sizeof(T);
  band_matvec_kernel<T><<<blocks, kWarpsPerBlock * kWarp, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      slabs, starts, x, y, m, n, R, WB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 = launched).
int tpdlp_band_matvec_f32(const float* slabs, const int32_t* starts,
                          const float* x, float* y, int m, int n, int R,
                          int WB, void* stream) {
  return launch<float>(slabs, starts, x, y, m, n, R, WB, stream);
}

int tpdlp_band_matvec_f64(const double* slabs, const int32_t* starts,
                          const double* x, double* y, int m, int n, int R,
                          int WB, void* stream) {
  return launch<double>(slabs, starts, x, y, m, n, R, WB, stream);
}

}  // extern "C"
