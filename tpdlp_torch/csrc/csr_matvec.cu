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
// nonzero, far below the fp32 peak for those bytes.  For the banded 100k
// instance of chip_smoke.py (10.5M nonzeros) that is 85 MB, 25 us at the
// H100 SXM's 3.35 TB/s.  Where the columns are random (the sparse-1M
// instance) each 4-byte read of x costs a 32-byte L2 sector, and those
// sectors, not the bytes streamed, set the time.
//
// The sum order, which fixes every output bit: a group of G lanes (G a
// power of two from 2 to 32, chosen by the wrapper from the mean row
// length, ops/_kernels.py::csr_group) owns one row.  Lane l of the group
// sums the row's nonzeros l, l + G, l + 2G, ... in order with fused
// multiply-adds, and a __shfl_xor_sync butterfly over the group ends the
// row.  That order depends only on the row's length and G, never on the
// grid, the stages or the block that took the row, so repeats are
// bit-identical on every card.  No atomics, no tensor cores.
//
// Two routes, one order (the wrapper picks one by ops/_kernels.py::
// csr_plan; both give the same bits, so a matrix's products replay whichever
// card runs them):
//
// The ring, for a matrix large enough that every block of a persistent wave
// streams at least a few stages (the banded 100k and sparse-1M instances):
// - Rows are cut into chunks of kConsumerWarps * R * 32 / G rows (R rows
//   for each lane group of the block's consumer warps), a function of the
//   row count and G alone.  A persistent grid (kBlocksPerSm blocks an SM)
//   gives each block a contiguous run of chunks; on the batch axis the
//   runs walk (element tile, chunk) pairs.
// - The nonzeros of a run of rows are one contiguous span of `val` and one
//   of `col`.  One producer thread streams the span in stages of
//   kStageNnz nonzeros by 1D bulk copies (cp.async.bulk) into a ring of
//   kStages shared-memory stages guarded by mbarriers.  A bulk copy needs
//   16-byte-aligned, 16-byte-multiple addresses, so each stage copies the
//   aligned superset of its values and of its column indices, and the
//   consumers index past the lead-in.  Chunks end on row boundaries; a row
//   may straddle stages.
// - Consumer warp w takes batches of R * 32 / G consecutive rows: w, w +
//   8, ... of the run; lane group i owns row i of each of the batch's R
//   slabs of 32 / G rows.  For a batch it waits for each stage its rows
//   touch, in order; each lane carries its nonzero index and its sum of
//   each row from stage to stage, so it walks exactly the one-pass
//   sequence above.  A warp releases a stage (one arrival on its `empty`
//   barrier) once it has moved past it, and always after waiting for the
//   stage's `full` barrier, so a slot's arrivals never run a round ahead.
//   A row longer than the ring is walked by its own group across stages.
// - A lane issues the loads of its R rows' next nonzeros before it uses
//   any, so R gathers of x are in flight a lane (a lane group with one row
//   has one, and 32 consumer warps an SM hold too few of them on short
//   rows); the row offsets of the warp's next batch are loaded while it
//   sums the current one.
// - x is gathered through the read-only cache (on the banded instances the
//   columns of neighbouring rows are neighbours, so L1 serves most reads).
//
// The direct route, for smaller matrices (mittelmann-l): a block of 256
// threads, one row a lane group, values and column indices loaded straight
// from device memory (the port's first CSR kernel).  There each block
// would hold a stage or two, so the ring has nothing to overlap and its
// copy, its barriers and its larger blocks only add latency; 64 warps an
// SM keep the loads in flight instead.
//
// The batch axis (tpdlp_torch/batch: a fleet of LPs that share one sparse
// K).  One launch computes Y[b] = M X[b] for b < batch, X[b] = x + b * ldx
// and Y[b] = y + b * ldy.  On the ring, elements go in tiles of
// kBatchTile: a stage serves every element of its tile, so the nonzeros
// are read once a tile, not once an element, and a lane keeps one sum an
// element, each the single launch's chain.  The direct route walks
// (element, row) pairs.  Either way element b's bits are exactly its
// single launch's.
//
// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// crow has rows + 1 int32 offsets, col and val hold crow[rows] < 2^31
// entries, every column index lies in [0, cols).  The aligned supersets may
// read up to 15 bytes past either end of `val` and `col`, inside the
// 16-byte granules that hold their first and last entries, and never use
// them.  The kernel allocates nothing and does not synchronise; it runs on
// the caller's stream.

#include "pipeline.cuh"

namespace {

using namespace tpdlp;

constexpr int kDirectThreads = 256;  // the direct route's block
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarp = kConsumerWarps;
constexpr int kThreads = (kConsumerWarps + 1) * kWarp;
constexpr int kStageNnz = 1024;  // nonzeros a stage (a multiple of 4)
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 4;       // a single vector
constexpr int kBatchTile = 8;         // elements a stage serves
constexpr int kBatchBlocksPerSm = 2;  // the batch axis: 8 sums a lane
constexpr int kRows = 4;              // rows a lane group sums at once
constexpr int kUnroll = 1;            // nonzeros of each a lane loads at once

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

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

// ---------------------------------------------------------------------------
// The direct route: one row a lane group, operands straight from device
// memory (the port's first CSR kernel, unchanged).
// ---------------------------------------------------------------------------

template <typename T, int G, bool kBatched>
__global__ void __launch_bounds__(kDirectThreads)
    csr_matvec_direct_kernel(const int* __restrict__ crow,
                      const int* __restrict__ col, const T* __restrict__ val,
                      const T* __restrict__ x, T* __restrict__ y, int rows,
                      int batch, int64_t ldx, int64_t ldy) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * kDirectThreads + threadIdx.x;
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

// ---------------------------------------------------------------------------
// The ring route.
// ---------------------------------------------------------------------------

// A stage: the aligned superset of kStageNnz values, then that of their
// column indices.
template <typename T>
struct Stage {
  static constexpr int kValBytes = kStageNnz * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kColBytes = kStageNnz * 4 + 16;
  static constexpr int kBytes = kValBytes + kColBytes;
};

// The block's work: items [begin, end) of tiles x chunks (item w is chunk
// w % chunks of element tile w / chunks), split into segments of one tile
// each.  A segment is a run of rows [r0, r1) and its nonzeros [n0, n1).
struct Segments {
  int64_t w, end, chunks;
  int chunk_rows, rows;
  __device__ Segments(int rows_, int batch, int tile, int chunk_rows_)
      : chunk_rows(chunk_rows_), rows(rows_) {
    chunks = (static_cast<int64_t>(rows) + chunk_rows - 1) / chunk_rows;
    const int64_t work = chunks * ((batch + tile - 1) / tile);
    w = work * blockIdx.x / gridDim.x;
    end = work * (blockIdx.x + 1) / gridDim.x;
  }
  // The next segment: its tile and rows; false when the block is done.
  __device__ bool next(int* t, int* r0, int* r1) {
    if (w >= end) return false;
    *t = static_cast<int>(w / chunks);
    const int64_t first = static_cast<int64_t>(*t) * chunks;
    const int64_t last = min64(end, first + chunks);
    *r0 = static_cast<int>((w - first) * chunk_rows);
    *r1 = static_cast<int>(min64(rows, (last - first) * chunk_rows));
    w = last;
    return true;
  }
};

// The 16-byte boundaries at or below and at or above an address.
__device__ __forceinline__ uintptr_t down16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & ~uintptr_t{15};
}
__device__ __forceinline__ uintptr_t up16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t{15};
}

// The stages of nonzeros [n0, n1): fewer than 2^31 / kStageNnz + 1.
__device__ __forceinline__ int stages_of(int n0, int n1) {
  return static_cast<int>(
      (static_cast<int64_t>(n1) - n0 + kStageNnz - 1) / kStageNnz);
}

// Wait for stage g to land, then release it (one arrival for the warp).
__device__ __forceinline__ void release(uint64_t* full, uint64_t* empty,
                                        int g, int lane) {
  mbar_wait(&full[g % kStages], (g / kStages) & 1);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[g % kStages]);
}

// One lane's nonzeros k[r], k[r] + G, ... below lim[r] of each of its R
// rows out of one stage (sv, sc indexed by k - lo), summed into acc[r][e]
// for the tile's ne elements, each row's in order.  The loads of kUnroll
// nonzeros of every row are issued before any is used.  Advances k[r] to
// the row's next nonzero.
template <typename T, int G, int EB, int R>
__device__ __forceinline__ void sum_stage(const T* sv, const int* sc, int lo,
                                          const T* x, int64_t ldx, int ne,
                                          int (&k)[R], const int (&lim)[R],
                                          T (&acc)[R][EB]) {
  constexpr int U = EB == 1 ? kUnroll : 1;
  for (;;) {
    bool more = false;
#pragma unroll
    for (int r = 0; r < R; ++r) more |= k[r] < lim[r];
    if (!more) break;
    int c[R][U];
    T v[R][U];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k[r] + u * G;
        c[r][u] = kk < lim[r] ? sc[kk - lo] : 0;
        v[r][u] = kk < lim[r] ? sv[kk - lo] : T(0);
      }
    }
    T xv[R][U][EB];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int e = 0; e < EB; ++e) {
          xv[r][u][e] = k[r] + u * G < lim[r] && e < ne
                            ? __ldg(x + e * ldx + c[r][u])
                            : T(0);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int taken = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k[r] + u * G < lim[r]) {
          ++taken;
#pragma unroll
          for (int e = 0; e < EB; ++e) {
            acc[r][e] = fma_t(v[r][u], xv[r][u][e], acc[r][e]);
          }
        }
      }
      k[r] += taken * G;
    }
  }
}

template <typename T, int G, int EB, int R>
__global__ void __launch_bounds__(kThreads,
                                  EB == 1 ? kBlocksPerSm : kBatchBlocksPerSm)
    csr_matvec_ring_kernel(const int* __restrict__ crow,
                      const int* __restrict__ col, const T* __restrict__ val,
                      const T* __restrict__ x, T* __restrict__ y, int rows,
                      int batch, int64_t ldx, int64_t ldy) {
  constexpr int P = kWarp / G;  // rows of a lane group's slab of a batch
  constexpr int kBatchRows = R * P;  // a warp's rows at once
  constexpr int kStride = kConsumerWarps * kBatchRows;  // a chunk
  using S = Stage<T>;
  extern __shared__ __align__(128) unsigned char smem[];
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

  Segments seg(rows, batch, EB, kStride);
  int t, r0, r1;
  int base = 0;  // the block's stages before this segment

  if (warp == kProducerWarp) {  // one thread streams the segments' spans
    if (lane != 0) return;
    while (seg.next(&t, &r0, &r1)) {
      const int n0 = crow[r0], n1 = crow[r1];
      const int nst = stages_of(n0, n1);
      for (int s = 0; s < nst; ++s) {
        const int g = base + s;
        const int slot = g % kStages;
        mbar_wait(&empty[slot], ((g / kStages) & 1) ^ 1);
        const int64_t lo = n0 + static_cast<int64_t>(s) * kStageNnz;
        const int64_t hi = min64(lo + kStageNnz, n1);
        const uintptr_t v0 = down16(val + lo), v1 = up16(val + hi);
        const uintptr_t c0 = down16(col + lo), c1 = up16(col + hi);
        unsigned char* stage = smem + slot * S::kBytes;
        mbar_arrive_expect_tx(&full[slot],
                              static_cast<uint32_t>((v1 - v0) + (c1 - c0)));
        bulk_copy(stage, reinterpret_cast<const void*>(v0),
                  static_cast<uint32_t>(v1 - v0), &full[slot]);
        bulk_copy(stage + S::kValBytes, reinterpret_cast<const void*>(c0),
                  static_cast<uint32_t>(c1 - c0), &full[slot]);
      }
      base += nst;
    }
    return;
  }

  const int gi = lane / G;  // the lane's group in its warp
  const int l = lane % G;   // the lane in its group
  // The group's lanes in its warp: the only lanes the butterfly names.
  const unsigned mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (gi * G));
  while (seg.next(&t, &r0, &r1)) {
    const int n0 = crow[r0], n1 = crow[r1];
    const int nst = stages_of(n0, n1);
    // Stage g's buffers hold nonzero k at index k - lo + lead.
    const int lead_v = static_cast<int>(
        (reinterpret_cast<uintptr_t>(val + n0) & 15) / sizeof(T));
    const int lead_c =
        static_cast<int>((reinterpret_cast<uintptr_t>(col + n0) & 15) / 4);
    const T* xt = x + static_cast<int64_t>(t) * EB * ldx;
    T* yt = y + static_cast<int64_t>(t) * EB * ldy;
    const int ne = min(EB, batch - t * EB);
    int rel = base;  // the first stage this warp has not released
    // The warp's batches: rows rb + r * P + gi of lane group gi, r < R; a
    // row past r1 is dead (empty at crow[r1]).  The next batch's row
    // offsets are loaded while the warp sums the current one.
    int rb = r0 + warp * kBatchRows;
    int beg[R], end[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = min(rb + r * P + gi, r1);
      beg[r] = rb < r1 ? crow[row] : 0;
      end[r] = rb < r1 && row < r1 ? crow[row + 1] : beg[r];
    }
    while (rb < r1) {
      const int rn = rb + kStride;
      int beg_n[R], end_n[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = min(rn + r * P + gi, r1);
        beg_n[r] = rn < r1 ? crow[row] : 0;
        end_n[r] = rn < r1 && row < r1 ? crow[row + 1] : beg_n[r];
      }
      // The batch's nonzeros: its first row's start to its last row's end.
      const int bb = __shfl_sync(0xffffffffu, beg[0], 0);
      const int be = __shfl_sync(0xffffffffu, end[R - 1], kWarp - 1);
      T acc[R][EB];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < EB; ++e) acc[r][e] = T(0);
      }
      if (be > bb) {
        const int ks = base + (bb - n0) / kStageNnz;
        const int ke = base + (be - 1 - n0) / kStageNnz;
        for (; rel < ks; ++rel) release(full, empty, rel, lane);
        int k[R];
#pragma unroll
        for (int r = 0; r < R; ++r) k[r] = beg[r] + l;
        for (int g = ks; g <= ke; ++g) {
          const int slot = g % kStages;
          mbar_wait(&full[slot], (g / kStages) & 1);
          const int lo = n0 + (g - base) * kStageNnz;
          int lim[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            lim[r] = end[r] - lo < kStageNnz ? end[r] : lo + kStageNnz;
          }
          const unsigned char* stage = smem + slot * S::kBytes;
          sum_stage<T, G, EB, R>(
              reinterpret_cast<const T*>(stage) + lead_v,
              reinterpret_cast<const int*>(stage + S::kValBytes) + lead_c,
              lo, xt, ldx, ne, k, lim, acc);
          if (g < ke) {  // the next batch starts in stage ke or later
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
          }
        }
        rel = ke;
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int e = 0; e < EB; ++e) {
            acc[r][e] += __shfl_xor_sync(mask, acc[r][e], off, G);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = rb + r * P + gi;
        if (l == 0 && row < r1) {
#pragma unroll
          for (int e = 0; e < EB; ++e) {
            if (e < ne) yt[e * ldy + row] = acc[r][e];
          }
        }
      }
      rb = rn;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        beg[r] = beg_n[r];
        end[r] = end_n[r];
      }
    }
    for (; rel < base + nst; ++rel) release(full, empty, rel, lane);
    base += nst;
  }
}

template <typename T, int G, int EB>
int launch_ring_g(const int* crow, const int* col, const T* val, const T* x,
                  T* y, int rows, int batch, int64_t ldx, int64_t ldy,
                  cudaStream_t stream) {
  constexpr int R = EB == 1 ? kRows : 1;
  constexpr int kChunkRows = kConsumerWarps * R * (kWarp / G);
  constexpr int smem = kStages * Stage<T>::kBytes;
  static int smem_done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      csr_matvec_ring_kernel<T, G, EB, R>, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t chunks = (static_cast<int64_t>(rows) + kChunkRows - 1) /
                         kChunkRows;
  const int64_t work = chunks * ((static_cast<int64_t>(batch) + EB - 1) / EB);
  const int per_sm = EB == 1 ? kBlocksPerSm : kBatchBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(
      std::min<int64_t>(work, static_cast<int64_t>(per_sm) * sms));
  csr_matvec_ring_kernel<T, G, EB, R><<<blocks, kThreads, smem, stream>>>(
      crow, col, val, x, y, rows, batch, ldx, ldy);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_direct_g(const int* crow, const int* col, const T* val,
                    const T* x, T* y, int rows, int batch, int64_t ldx,
                    int64_t ldy, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(rows) * batch * G;
  const int64_t blocks = (threads + kDirectThreads - 1) / kDirectThreads;
  if (blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (batch == 1) {
    csr_matvec_direct_kernel<T, G, false><<<static_cast<unsigned>(blocks),
                                     kDirectThreads, 0, stream>>>(
        crow, col, val, x, y, rows, 1, 0, 0);
  } else {
    csr_matvec_direct_kernel<T, G, true><<<static_cast<unsigned>(blocks),
                                    kDirectThreads, 0, stream>>>(
        crow, col, val, x, y, rows, batch, ldx, ldy);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool kRing, int EB>
int launch_g(const int* crow, const int* col, const T* val, const T* x, T* y,
             int rows, int batch, int64_t ldx, int64_t ldy,
             cudaStream_t stream) {
  if constexpr (kRing) {
    return launch_ring_g<T, G, EB>(crow, col, val, x, y, rows, batch, ldx,
                                   ldy, stream);
  } else {
    return launch_direct_g<T, G>(crow, col, val, x, y, rows, batch, ldx, ldy,
                                 stream);
  }
}

// One launch of the route kRing names (the ring with element tiles of EB).
template <typename T, bool kRing, int EB>
int launch(const int* crow, const int* col, const T* val, const T* x, T* y,
           int rows, int group, int batch, int64_t ldx, int64_t ldy,
           void* stream_ptr) {
  if (rows <= 0 || batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (group) {
    case 2:
      return launch_g<T, 2, kRing, EB>(crow, col, val, x, y, rows, batch, ldx,
                                       ldy, s);
    case 4:
      return launch_g<T, 4, kRing, EB>(crow, col, val, x, y, rows, batch, ldx,
                                       ldy, s);
    case 8:
      return launch_g<T, 8, kRing, EB>(crow, col, val, x, y, rows, batch, ldx,
                                       ldy, s);
    case 16:
      return launch_g<T, 16, kRing, EB>(crow, col, val, x, y, rows, batch,
                                        ldx, ldy, s);
    case 32:
      return launch_g<T, 32, kRing, EB>(crow, col, val, x, y, rows, batch,
                                        ldx, ldy, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 = launched).
// `group` is the lanes per row: 2, 4, 8, 16 or 32.  The wrapper picks the
// route (ops/_kernels.py::csr_plan); both give the same bits.
int tpdlp_csr_matvec_f32(const int* crow, const int* col, const float* val,
                         const float* x, float* y, int rows, int group,
                         void* stream) {
  return launch<float, false, 1>(crow, col, val, x, y, rows, group, 1, 0, 0,
                                 stream);
}

int tpdlp_csr_matvec_f64(const int* crow, const int* col, const double* val,
                         const double* x, double* y, int rows, int group,
                         void* stream) {
  return launch<double, false, 1>(crow, col, val, x, y, rows, group, 1, 0, 0,
                                  stream);
}

int tpdlp_csr_matvec_ring_f32(const int* crow, const int* col,
                              const float* val, const float* x, float* y,
                              int rows, int group, void* stream) {
  return launch<float, true, 1>(crow, col, val, x, y, rows, group, 1, 0, 0,
                                stream);
}

int tpdlp_csr_matvec_ring_f64(const int* crow, const int* col,
                              const double* val, const double* x, double* y,
                              int rows, int group, void* stream) {
  return launch<double, true, 1>(crow, col, val, x, y, rows, group, 1, 0, 0,
                                 stream);
}

// Y[b] = M X[b] for b < batch in one launch (see the batch axis above).
int tpdlp_csr_matvec_batch_f32(const int* crow, const int* col,
                               const float* val, const float* x, float* y,
                               int rows, int group, int batch, int64_t ldx,
                               int64_t ldy, void* stream) {
  return launch<float, false, 1>(crow, col, val, x, y, rows, group, batch,
                                 ldx, ldy, stream);
}

int tpdlp_csr_matvec_batch_f64(const int* crow, const int* col,
                               const double* val, const double* x, double* y,
                               int rows, int group, int batch, int64_t ldx,
                               int64_t ldy, void* stream) {
  return launch<double, false, 1>(crow, col, val, x, y, rows, group, batch,
                                  ldx, ldy, stream);
}

int tpdlp_csr_matvec_ring_batch_f32(const int* crow, const int* col,
                                    const float* val, const float* x,
                                    float* y, int rows, int group, int batch,
                                    int64_t ldx, int64_t ldy, void* stream) {
  return launch<float, true, kBatchTile>(crow, col, val, x, y, rows, group,
                                         batch, ldx, ldy, stream);
}

int tpdlp_csr_matvec_ring_batch_f64(const int* crow, const int* col,
                                    const double* val, const double* x,
                                    double* y, int rows, int group, int batch,
                                    int64_t ldx, int64_t ldy, void* stream) {
  return launch<double, true, kBatchTile>(crow, col, val, x, y, rows, group,
                                          batch, ldx, ldy, stream);
}

}  // extern "C"
