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
// Design against that bound.  Keeping HBM busy takes some 20-30 KB of loads
// in flight on every SM from the first microsecond to the last (a warp per
// row would fill a quarter of the card's warp slots at 2000 rows), and no
// step of a row that waits on other warps.
// - A persistent grid, one block per SM, walks tiles of rows
//   (tile t = blockIdx.x + i * gridDim.x).
// - One producer thread streams each tile with 1D bulk copies
//   (cp.async.bulk) into a ring of kStages shared-memory stages of 32 KB,
//   guarded by mbarriers: 128 KB in flight per SM without a register spent
//   on them.  A row longer than kChunkBytes (4 KB) is cut into chunks, one
//   stage per chunk of the tile's 8 rows; shorter rows go several to a warp,
//   8 * (4 KB / row bytes) rows to a stage, in one copy when they are
//   contiguous.  At 2000 x 5000 fp32 a tile is 8 rows in 5 stages.
// - Each of the kConsumerWarps consumer warps owns whole rows of a tile, so
//   no warp waits on another.  A lane loads its x vectors of the chunk
//   (through L1) before it waits on the stage and uses them for every row
//   the warp holds in that stage.
// - The reduction is fixed: lane L sums the row's 16-byte vectors L, L + 32,
//   ... in order, then the last partial vector's elements, then a
//   __shfl_xor_sync butterfly ends the row.  That order depends only on
//   cols, never on the grid, the tile or the block order: repeats are
//   bit-identical on every card.  No atomics, no tensor cores, no TF32.

// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// M is row-major with a row stride `ld` that is a multiple of 4 elements and
// a 16-byte-aligned base, so every row starts on a 16-byte boundary; x is
// 16-byte aligned.  A row chunk is copied up to cols rounded up to 4
// elements (at most `ld`), but no value at or past `cols` is ever used, and
// x is never read at or past `cols`.  The kernel allocates nothing and does
// not synchronise; it runs on the caller's stream.

#include "pipeline.cuh"

namespace {

using namespace tpdlp;

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * kWarp;  // + one producer warp
constexpr int kChunkBytes = 4096;  // a row's part of one stage, at most
constexpr int kChunkVecs = kChunkBytes / 16;
constexpr int kVecsPerLane = kChunkVecs / kWarp;
constexpr int kStageBytes = kConsumerWarps * kChunkBytes;
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;

// The tiles of an (rows, cols) matrix.  A row copies cols rounded up to 4
// elements (<= ld), in 16-byte units.  A row longer than a chunk takes
// `chunks` stages, one row per warp; shorter rows take one stage,
// `per_warp` rows per warp.
struct Tiles {
  int row_bytes, chunks, stride, per_warp, tile_rows, count;
  __host__ __device__ Tiles(int rows, int cols, int item) {
    row_bytes = ((cols + 3) & ~3) * item;
    chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
    stride = row_bytes < kChunkBytes ? row_bytes : kChunkBytes;  // in a stage
    per_warp = chunks == 1 ? kChunkBytes / row_bytes : 1;
    tile_rows = kConsumerWarps * per_warp;
    count = (rows + tile_rows - 1) / tile_rows;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dense_matvec_kernel(const T* __restrict__ M, const T* __restrict__ x,
                    T* __restrict__ y, int rows, int cols, int64_t ld) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const Tiles tl(rows, cols, static_cast<int>(sizeof(T)));
  const int row_bytes = tl.row_bytes, chunks = tl.chunks, stride = tl.stride;
  const int per_warp = tl.per_warp, tile_rows = tl.tile_rows;
  const int tiles = tl.count;

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    const int64_t ld_bytes = ld * static_cast<int64_t>(sizeof(T));
    const bool packed = chunks == 1 && ld_bytes == row_bytes;
    uint32_t k = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r0 = t * tile_rows;
      const int nr = min(tile_rows, rows - r0);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(M) + r0 * ld_bytes;
      for (int c = 0; c < chunks; ++c, ++k) {
        const int s = k % kStages;
        mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
        const int c0 = c * kChunkBytes;
        const uint32_t bytes = min(kChunkBytes, row_bytes - c0);
        mbar_arrive_expect_tx(&full[s], bytes * nr);
        unsigned char* dst = ring + s * kStageBytes;
        if (packed) {  // the tile's rows are one contiguous block
          bulk_copy(dst, src, bytes * nr, &full[s]);
        } else {
          for (int r = 0; r < nr; ++r) {
            bulk_copy(dst + r * stride, src + r * ld_bytes + c0, bytes,
                      &full[s]);
          }
        }
      }
    }
    return;
  }

  // The consumers.  Lane L sums the row's 16-byte vectors L, L + 32, ...
  // in order, then (if cols % W) the last partial vector's elements; a
  // fixed butterfly ends the row.  That order depends only on cols.
  const V* xv = reinterpret_cast<const V*>(x);
  const int nvec = cols / W;        // whole vectors of a row
  const int tail = cols - nvec * W;  // elements of the partial vector
  uint32_t k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * tile_rows;
    const int nr = min(tile_rows, rows - r0);
    T acc = T(0);  // the running sum of a row that spans chunks
    for (int c = 0; c < chunks; ++c, ++k) {
      const int s = k % kStages;
      const int v0 = c * kChunkVecs;
      V xr[kVecsPerLane];  // this lane's x for the chunk, loaded early
#pragma unroll
      for (int q = 0; q < kVecsPerLane; ++q) {
        const int v = v0 + lane + q * kWarp;
        if (v < nvec) xr[q] = __ldg(xv + v);
      }
      const bool tail_here = tail && lane == nvec % kWarp && nvec >= v0 &&
                             nvec < v0 + kChunkVecs;
      mbar_wait(&full[s], (k / kStages) & 1);
      const unsigned char* st = ring + s * kStageBytes;
      for (int i = 0; i < per_warp; ++i) {
        const int j = warp + kConsumerWarps * i;  // the row in the tile
        if (j >= nr) break;
        const V* sr = reinterpret_cast<const V*>(st + j * stride);
        T a = chunks == 1 ? T(0) : acc;
#pragma unroll
        for (int q = 0; q < kVecsPerLane; ++q) {
          const int v = v0 + lane + q * kWarp;
          if (v < nvec) a = Vec<T>::dot_acc(sr[v - v0], xr[q], a);
        }
        if (tail_here) {
          const T* se = reinterpret_cast<const T*>(sr + (nvec - v0));
          for (int e = 0; e < tail; ++e) {
            a = fma(se[e], __ldg(x + nvec * W + e), a);
          }
        }
        if (chunks == 1) {
          a = warp_sum(a);
          if (lane == 0) y[r0 + j] = a;
        } else {
          acc = a;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (chunks != 1 && warp < nr) {  // a row that spans chunks (or cols 0)
      acc = warp_sum(acc);
      if (lane == 0) y[r0 + warp] = acc;
    }
  }
}

template <typename T>
int launch(const T* M, const T* x, T* y, int rows, int cols, int64_t ld,
           void* stream) {
  if (rows <= 0) return 0;
  static int smem_done[kMaxDevices] = {};
  const cudaError_t err =
      allow_dynamic_smem(dense_matvec_kernel<T>, kRingBytes, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Tiles tiles(rows, cols, static_cast<int>(sizeof(T)));
  const unsigned blocks = static_cast<unsigned>(std::min(tiles.count, sms));
  dense_matvec_kernel<T><<<blocks, kThreads, kRingBytes,
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
