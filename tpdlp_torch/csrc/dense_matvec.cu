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
//
// The batch axis (tpdlp_torch/batch: a fleet of LPs solved together, where
// the JAX package vmaps ExactDenseOp.mv/rmv and pallas_call's batching rule
// runs K1 over a batch grid axis).  One launch computes Y[b] = M_b X[b] for
// b < batch, with M_b = M + b * stride_m, X[b] = x + b * ldx and
// Y[b] = y + b * ldy: stride_m picks the stack kernel or a shared K's.
//
// A stack of distinct K (stride_m != 0) takes dense_matvec_stack_kernel
// below, built for many small distinct matrices (a distinct fleet: 16 x
// 444 x 757 fp32, 21.6 MB).
// - Bound: bytes, each M_b read once (6.4 us at the fleet's shape).  An
//   element's work is small, so what costs is the time to get every byte
//   requested: a persistent walk of (element, 8-row tile) pairs through a
//   ring would keep the ring filling or draining for most of a launch
//   (6.8 pairs a block at the fleet's shape), and vector loads of X would
//   need X padded to 16-byte rows, a second kernel in every product.
// - Design.  A block owns a tile of RB rows of one element (a grid of row
//   blocks x elements, not persistent), sized by the wrapper
//   (ops/_kernels.py::stack_plan) so that the grid fills the card in one
//   wave: four blocks an SM for rows of at most 4 KB, two for longer.  The producer warp loads X[b] into shared memory with
//   cp.async at any row stride and alignment (no padded copy), its
//   completion tracked by an mbarrier, and bulk-copies the tile's K rows,
//   8 rows (one a consumer warp) a stage.  Rows of at most 4 KB: the
//   whole row in a stage, X[b] loaded once, and a tile's stages all in
//   flight at once where they fit (the fleet's tiles do).  Longer rows:
//   4 KB parts, each stage carrying the same part of X[b], through a ring
//   of stages.
// - The order of every sum is the single launch's: lane L sums vectors L,
//   L + 32, ... (parts start at multiples of 32 vectors), the last partial
//   vector by fma, then the butterfly 16, 8, 4, 2, 1.  So element b equals
//   a single launch on b, bit for bit.
//
// One K shared by the fleet (stride_m == 0) reads K once for a tile of
// right-hand sides, in one of two kernels by the wrapper's plan
// (ops/_kernels.py::shared_plan, a fixed rule on shape, item size, batch
// and the SM count; the launchers check it).
// - Bound: a shared K is read once, X once, Y written once; 2 * batch *
//   rows * cols flops.  So the bound is bytes for a short row or a small
//   batch and fp32 FMAs for a long row at a large one: 0.9 us at afiro x
//   10,000 (27 x 51), 0.6 us at deg2 x 64 (444 x 757), 12 us (K's 40 MB)
//   at mittelmann-s x 8, 0.306 ms (2 * 8000 * 20000 * 64 flops at 67
//   TFLOP/s) at mittelmann-l x 64.
// - The order of every sum is the single launch's.  For output (b, r),
//   partial L (L < 32) starts at +0.0 and takes Vec<T>::dot_acc of the
//   vectors L, L + 32, ... in order, then (if cols % W) partial nvec % 32
//   the last partial vector's elements by fma, then the butterfly with
//   offsets 16, 8, 4, 2, 1 over all 32 partials.  The kernels change only
//   who computes each partial and who adds each pair of the tree (fadd is
//   commutative).  So element b of a launch equals, bit for bit, a single
//   launch on b; repeats are bit-identical; no atomics, no tensor cores,
//   no TF32, no memory of its own beyond Y.
//
// dense_matvec_shared_kernel: whole rows, fp64 rows, and fp32 rows of any
// length where the plan keeps it (a batch of at most 8, or a K small enough
// that reading it again costs less than a wave of clusters: afiro x 10,000,
// deg2 x 64, mittelmann-s x 8-16).
// - A block owns a tile of RB rows x EB elements (a grid of row blocks x
//   element blocks, not persistent) and reads the tile's K rows and X rows
//   into shared memory once: K is read once per element block, X once per
//   row block.  One producer warp bulk-copies K's rows (cp.async.bulk; one
//   copy where they lie back to back) while the consumer warps load X's
//   rows themselves element by element (cp.async), at any row stride and
//   alignment, so a fleet's (B, n) x goes in as it is (no padded copy, no
//   second kernel).  Rows of at most kWholeRowBytes sit whole in one
//   stage; longer rows stream in parts of `chunk` bytes through a
//   two-stage ring, one tile of 8 units per block.
// - A consumer warp's work is a unit of 4 rows x 4 elements: lane j holds
//   partial j of the unit's 16 outputs, loads 4 K and 4 X vectors a step
//   and makes 16 dot products of them.  A unit's 16 butterflies run
//   transposed: at each level a lane keeps half its outputs and trades the
//   other half with its partner, so 16 row sums cost 16 shuffles, not 80.
// - Rows of at most 16 live vectors (afiro's 13 and 7) run G = 4, 8 or 16
//   lanes to a unit, 32 / G units to a warp: the butterfly levels whose
//   partner lanes hold only +0.0 are an add of +0.0 in the lane itself.
//
// dense_matvec_shared_kernel_long: the cluster route, fp32 rows longer
// than kWholeRowBytes where the chunked route would read K again for 60 MB
// or more (mittelmann-l x 64: K 8000 x 20000 and K' 20000 x 8000).  There
// the chunked tiles of 16 rows x 8 elements read K (640 MB) from HBM 8
// times and X from L2 500 times, 7.68 GB a launch at 93% of HBM's rate,
// and each lane's 16 partials fed 16 FMAs from 8 shared-memory loads.
// - A cluster of kLongCluster = 4 blocks owns a tile of 3072 outputs, 48
//   rows x 64 elements (96 x 32 at a batch of at most 32), and splits the
//   32 partials of every output between its blocks: block q holds partials
//   8 q, ..., 8 q + 7, which read only the vectors 32 s + 8 q, ..., 32 s +
//   8 q + 7 of each segment s (32 vectors, 512 bytes) of a row.  So block q
//   copies bytes [128 q, 128 q + 128) of each segment of the tile's K rows
//   and X rows: each byte of K enters the SMs once an element block (once
//   a launch up to B = 64) and X once a 48-row tile, 1.5 GB a launch at
//   mittelmann-l x 64.  The cluster's four register files hold the tile's
//   98,304 partials, 96 a lane.  48 rows, not 64: an H100 runs 30 such
//   clusters at once, and K's 167 tiles are 5.57 waves of 6 where 125 were
//   4.17 of 5.
// - Every thread copies its share of each stage (cp.async, 16 bytes; X's
//   partial vector and X's rows at a stride or base that is not 16-byte
//   aligned by element) kLongStages - kLongLag stages ahead and arrives on
//   the stage's barrier when its copies land; each warp arrives on the
//   stage's empty barrier when it has read it, once a stage of kLongSegs
//   segments; a slot is refilled once every warp has left it, kLongLag
//   stages back.  (A producer warp with 128-byte bulk copies took 4x as
//   long: the copy engine spends some 70 cycles a copy.)
// - Lane c + 8 g of warp (wr, we) holds partial 8 q + c of rows 12 wr + i
//   and elements 32 we + 8 g + e (12 x 8 = 96 partials): a segment is 8 X
//   loads held in registers, then K's vectors of its rows 3 at a time (the
//   same 128 bytes for the warp's 4 lane groups), each partial taking x, y,
//   z, w in order.
// - The tree: each block writes its partials to shared memory ([partial]
//   [element][row], strides padded so that a warp's 32 stores hit 32
//   banks), the cluster synchronises, and block q reads the 32 partials of
//   elements [q EB / 4, (q + 1) EB / 4) from the four blocks' shared memory
//   (distributed shared memory) and adds them in the butterfly's order.

// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// M is row-major with a row stride `ld` that is a multiple of 4 elements and
// a 16-byte-aligned base, so every row starts on a 16-byte boundary; x is
// 16-byte aligned.  A row chunk is copied up to cols rounded up to 4
// elements (at most `ld`), but no value at or past `cols` is ever used, and
// x is never read at or past `cols`.  In a batch, stride_m keeps every M_b
// 16-byte aligned (a multiple of 4 elements); both batch kernels ask
// nothing of X but a unit column stride, and read no X element at or past
// cols.  The kernels allocate nothing and do not synchronise;
// they run on the caller's stream.

#include <cooperative_groups.h>

#include "pipeline.cuh"

namespace {

using namespace tpdlp;
namespace cg = cooperative_groups;

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
  const int nvec = cols / W;        // whole vectors of a row
  const int tail = cols - nvec * W;  // elements of the partial vector
  const V* xv = reinterpret_cast<const V*>(x);
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

// ---------------------------------------------------------------------------
// The shared-K batch kernel (stride_m == 0; see the batch axis above).
// ---------------------------------------------------------------------------

constexpr int kUnitRows = 4;   // a unit: 4 rows x 4 elements of one tile
constexpr int kUnitElems = 4;
constexpr int kUnit = kUnitRows * kUnitElems;
constexpr int kWholeRowBytes = 4096;  // rows up to this sit whole in a stage
constexpr int kSharedStages = 2;      // the ring of a tile of longer rows
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on Hopper

// acc + the first n products of a . b (n = W for a whole vector, cols % W
// for the last partial one), in the order x, y, z, w: Vec<T>::dot_acc's
// operations when n = W, the single kernel's tail loop otherwise.
__device__ __forceinline__ float dot_acc_n(const float4 a, const float4 b,
                                           float acc, int n) {
  acc = fmaf(a.x, b.x, acc);
  if (n > 1) acc = fmaf(a.y, b.y, acc);
  if (n > 2) acc = fmaf(a.z, b.z, acc);
  if (n > 3) acc = fmaf(a.w, b.w, acc);
  return acc;
}
__device__ __forceinline__ double dot_acc_n(const double2 a, const double2 b,
                                            double acc, int n) {
  acc = fma(a.x, b.x, acc);
  if (n > 1) acc = fma(a.y, b.y, acc);
  return acc;
}

// A barrier of the consumer warps alone (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * kWarp) : "memory");
}

// One element of global memory to shared memory, asynchronously (cp.async:
// no alignment asked beyond the element's own).
template <typename T>
__device__ __forceinline__ void cp_async(void* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "n"(sizeof(T)) : "memory");
}

// 16 bytes of global memory to shared memory, asynchronously, through L2
// alone (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// Make the barrier's current phase wait for this thread's cp.async copies
// issued so far: an arrival (counted in the barrier's init count) that
// lands when they have.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

// Wait until at most N of this thread's committed cp.async groups are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start loading elements [k0, k1) of X's rows e0, ..., e0 + ne - 1 (row
// stride ldx) into the stage's X rows, `stride` bytes apart: warp w takes
// rows w, w + 8, ..., its lanes the elements (coalesced; any row stride,
// so a fleet's x goes in as it is).  Commits one group per thread.
template <typename T>
__device__ __forceinline__ void load_x_async(unsigned char* xs, const T* x,
                                             int e0, int ne, int64_t ldx,
                                             int k0, int k1, int stride,
                                             int warp, int lane) {
  for (int e = warp; e < ne; e += kConsumerWarps) {
    const T* src = x + (e0 + e) * ldx;
    T* row = reinterpret_cast<T*>(xs + e * stride);
    for (int k = k0 + lane; k < k1; k += kWarp) {
      cp_async(row + (k - k0), src + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One unit's partials over the stage's live vectors [0, count) (chunk-local;
// global vector v0 + lv): this lane takes lv = j, j + 32, ...  `ks` and `xs`
// are the unit's first K row and first X row in the stage, `stride` bytes
// apart.
template <typename T>
__device__ __forceinline__ void accumulate(T (&acc)[kUnit],
                                           const unsigned char* ks,
                                           const unsigned char* xs,
                                           int stride, int j, int v0,
                                           int count, int nvec, int tail) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  for (int base = 0; base < count; base += kWarp) {
    const int lv = base + j;
    if (lv >= count) continue;
    const int n = v0 + lv < nvec ? W : tail;
    V kv[kUnitRows], xv[kUnitElems];
#pragma unroll
    for (int i = 0; i < kUnitRows; ++i) {
      kv[i] = reinterpret_cast<const V*>(ks + i * stride)[lv];
    }
#pragma unroll
    for (int e = 0; e < kUnitElems; ++e) {
      xv[e] = reinterpret_cast<const V*>(xs + e * stride)[lv];
    }
#pragma unroll
    for (int i = 0; i < kUnitRows; ++i) {
#pragma unroll
      for (int e = 0; e < kUnitElems; ++e) {
        acc[i * kUnitElems + e] =
            dot_acc_n(kv[i], xv[e], acc[i * kUnitElems + e], n);
      }
    }
  }
}

// One butterfly level, transposed over the unit's outputs: the lane keeps
// H of its 2H sums (the upper half if its `off` bit is set) and adds its
// partner's value of each; `base` tracks the first output it keeps.
template <typename T, int H>
__device__ __forceinline__ void fold(T (&acc)[kUnit], int lane, int off,
                                     int& base) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int o = 0; o < H; ++o) {
    const T send = up ? acc[o] : acc[o + H];
    const T keep = up ? acc[o + H] : acc[o];
    acc[o] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
  if (up) base += H;
}

// The butterfly of every output of a unit held by G lanes: levels whose
// offset is at least G pair each partial with lanes that hold only +0.0
// (an add of +0.0 here); the others fold.  Returns the first of the
// kUnit / min(G, 16) outputs the lane then holds complete in acc[0, ...).
template <typename T, int G>
__device__ __forceinline__ int reduce_unit(T (&acc)[kUnit], int lane) {
#pragma unroll
  for (int off = kWarp / 2; off >= G; off /= 2) {
#pragma unroll
    for (int o = 0; o < kUnit; ++o) acc[o] = acc[o] + T(0);
  }
  int base = 0;
  if constexpr (G >= 2) fold<T, 8>(acc, lane, G / 2, base);
  if constexpr (G >= 4) fold<T, 4>(acc, lane, G / 4, base);
  if constexpr (G >= 8) fold<T, 2>(acc, lane, G / 8, base);
  if constexpr (G >= 16) fold<T, 1>(acc, lane, G / 16, base);
  if constexpr (G >= 32) {
    acc[0] = acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
  }
  return base;
}

// Write the outputs this lane holds after reduce_unit (one lane of each
// pair when G = 32): output o of unit (ur, ue) is row 4 ur + o / 4 and
// element 4 ue + o % 4 of the tile.
template <typename T, int G>
__device__ __forceinline__ void store_unit(const T (&acc)[kUnit], int base,
                                           int lane, int ur, int ue, int r0,
                                           int e0, int nr, int ne, T* y,
                                           int64_t ldy) {
  constexpr int kHeld = kUnit / (G < 16 ? G : 16);
  if (G == kWarp && (lane & 1)) return;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int o = base + k;
    const int r = ur * kUnitRows + o / kUnitElems;
    const int e = ue * kUnitElems + o % kUnitElems;
    if (r < nr && e < ne) y[(e0 + e) * ldy + r0 + r] = acc[k];
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 2)
dense_matvec_shared_kernel(const T* __restrict__ M, const T* __restrict__ x,
                           T* __restrict__ y, int rows, int cols, int64_t ld,
                           int batch, int64_t ldx, int64_t ldy, int RB,
                           int EB, int chunk, int stages) {
  constexpr int W = Vec<T>::width;
  constexpr int kGroups = kWarp / G;  // units a warp works on at once
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kSharedStages];
  __shared__ __align__(8) uint64_t empty[kSharedStages];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int item = static_cast<int>(sizeof(T));
  const int row_bytes = ((cols + 3) & ~3) * item;
  const int chunks = row_bytes <= chunk ? 1 : (row_bytes + chunk - 1) / chunk;
  const int stride = min(row_bytes, chunk);  // a row's bytes in a stage
  const int stage_bytes = (RB + EB) * stride;
  const int row_blocks = (rows + RB - 1) / RB;
  const int r0 = static_cast<int>(blockIdx.x % row_blocks) * RB;
  const int e0 = static_cast<int>(blockIdx.x / row_blocks) * EB;
  const int nr = min(RB, rows - r0), ne = min(EB, batch - e0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: K's rows
    const int64_t ld_bytes = ld * item;
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(M) + r0 * ld_bytes;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % stages;
      const int c0 = c * chunk;
      const uint32_t bytes = max(0, min(chunk, row_bytes - c0));
      unsigned char* dst = ring + s * stage_bytes;
      if (lane == 0) {
        mbar_wait(&empty[s], ((c / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes * nr);
      }
      __syncwarp();
      if (bytes == 0) continue;  // cols == 0: the phase completes empty
      // One copy where the tile's rows lie back to back, else one a row,
      // spread over the warp's lanes.
      if (chunks == 1 && ld_bytes == row_bytes) {
        if (lane == 0) bulk_copy(dst, kb, bytes * nr, &full[s]);
      } else {
        for (int r = lane; r < nr; r += kWarp) {
          bulk_copy(dst + r * stride, kb + r * ld_bytes + c0, bytes,
                    &full[s]);
        }
      }
    }
    return;
  }

  // The consumers.  Lane j of a unit's group holds partial j of each of the
  // unit's 16 outputs (vectors j, j + 32, ...).
  const int nvec = cols / W;
  const int tail = cols - nvec * W;
  const int nlive = nvec + (tail ? 1 : 0);
  const int j = lane % G;
  T acc[kUnit];
  unsigned char* const xs = ring + RB * stride;  // stage 0's X rows
  if (chunks == 1) {  // whole rows: the units of the tile, a pass at a time
    load_x_async<T>(xs, x, e0, ne, ldx, 0, cols, stride, warp, lane);
    cp_async_wait<0>();
    consumers_sync();
    const int nue = (ne + kUnitElems - 1) / kUnitElems;
    const int units = (nr + kUnitRows - 1) / kUnitRows * nue;
    mbar_wait(&full[0], 0);
    for (int u0 = warp * kGroups; u0 < units;
         u0 += kConsumerWarps * kGroups) {  // warp-uniform
      const int u = min(u0 + lane / G, units - 1);
      const int ur = u / nue, ue = u % nue;
#pragma unroll
      for (int o = 0; o < kUnit; ++o) acc[o] = T(0);
      accumulate<T>(acc, ring + ur * kUnitRows * stride,
                    xs + ue * kUnitElems * stride, stride, j, 0, nlive,
                    nvec, tail);
      const int base = reduce_unit<T, G>(acc, lane);
      if (u0 + lane / G < units) {
        store_unit<T, G>(acc, base, lane, ur, ue, r0, e0, nr, ne, y, ldy);
      }
    }
    return;
  }
  // Longer rows (G = 32): one unit a warp, its partials carried over the
  // chunks (each a multiple of 32 vectors, so lane j keeps partial j).  The
  // X part of the next chunk's stage is loaded while this chunk computes;
  // that stage's last readers finished before the previous chunk's closing
  // barrier.
  const int ues = EB / kUnitElems;
  const int ur = warp / ues, ue = warp % ues;
  const int cvec = chunk / 16;
  const int celems = chunk / item;
#pragma unroll
  for (int o = 0; o < kUnit; ++o) acc[o] = T(0);
  load_x_async<T>(xs, x, e0, ne, ldx, 0, min(cols, celems), stride, warp,
                  lane);
  for (int c = 0; c < chunks; ++c) {
    const int s = c % stages;
    if (c + 1 < chunks) {
      const int k0 = (c + 1) * celems;
      load_x_async<T>(xs + ((c + 1) % stages) * stage_bytes, x, e0, ne, ldx,
                      k0, min(cols, k0 + celems), stride, warp, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    consumers_sync();
    mbar_wait(&full[s], (c / stages) & 1);
    const unsigned char* st = ring + s * stage_bytes;
    accumulate<T>(acc, st + ur * kUnitRows * stride,
                  st + (RB + ue * kUnitElems) * stride, stride, j,
                  c * cvec, min(cvec, nlive - c * cvec), nvec, tail);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    consumers_sync();
  }
  const int base = reduce_unit<T, G>(acc, lane);
  store_unit<T, G>(acc, base, lane, ur, ue, r0, e0, nr, ne, y, ldy);
}

template <typename T, int G>
int launch_shared_g(const T* M, const T* x, T* y, int rows, int cols,
                    int64_t ld, int batch, int64_t ldx, int64_t ldy, int RB,
                    int EB, int chunk, int stages, int smem, unsigned blocks,
                    void* stream) {
  static int smem_done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      dense_matvec_shared_kernel<T, G>, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_matvec_shared_kernel<T, G><<<blocks, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      M, x, y, rows, cols, ld, batch, ldx, ldy, RB, EB, chunk, stages);
  return static_cast<int>(cudaGetLastError());
}

// Checks the wrapper's plan against what the kernel assumes, then launches
// one block a tile.
template <typename T>
int launch_shared(const T* M, const T* x, T* y, int rows, int cols,
                  int64_t ld, int batch, int64_t ldx, int64_t ldy, int G,
                  int RB, int EB, int chunk, int stages, void* stream) {
  if (rows <= 0 || batch <= 0) return 0;
  const int64_t row_bytes = ((static_cast<int64_t>(cols) + 3) & ~3) *
                            static_cast<int64_t>(sizeof(T));
  const int64_t nlive = (cols + Vec<T>::width - 1) / Vec<T>::width;
  const int64_t chunks = row_bytes <= chunk ? 1
                                            : (row_bytes + chunk - 1) / chunk;
  const int64_t smem =
      static_cast<int64_t>(stages) * (RB + EB) * std::min<int64_t>(
                                                     row_bytes, chunk);
  const int64_t blocks = static_cast<int64_t>((rows + RB - 1) / RB) *
                         ((batch + EB - 1) / EB);
  const bool whole = chunks == 1;
  if (RB <= 0 || EB <= 0 || RB % kUnitRows || EB % kUnitElems ||
      chunk <= 0 || chunk % 16 || stages < 1 || stages > kSharedStages ||
      smem > kMaxSmem || row_bytes >= (int64_t{1} << 31) ||
      blocks >= (int64_t{1} << 31) || (G < kWarp && nlive > G) ||
      (!whole && (G != kWarp || chunk % (16 * kWarp) ||
                  stages != kSharedStages ||
                  (RB / kUnitRows) * (EB / kUnitElems) != kConsumerWarps))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int s = static_cast<int>(smem);
  const unsigned n = static_cast<unsigned>(blocks);
  switch (G) {
    case 4:
      return launch_shared_g<T, 4>(M, x, y, rows, cols, ld, batch, ldx, ldy,
                                   RB, EB, chunk, stages, s, n, stream);
    case 8:
      return launch_shared_g<T, 8>(M, x, y, rows, cols, ld, batch, ldx, ldy,
                                   RB, EB, chunk, stages, s, n, stream);
    case 16:
      return launch_shared_g<T, 16>(M, x, y, rows, cols, ld, batch, ldx,
                                    ldy, RB, EB, chunk, stages, s, n, stream);
    case 32:
      return launch_shared_g<T, 32>(M, x, y, rows, cols, ld, batch, ldx,
                                    ldy, RB, EB, chunk, stages, s, n, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The shared-K kernel's cluster route: fp32 rows longer than kWholeRowBytes
// at a batch over 8 (see the batch axis above; the wrapper's plan picks).
// ---------------------------------------------------------------------------

constexpr int kLongCluster = 4;                    // blocks a cluster
constexpr int kLongChains = kWarp / kLongCluster;  // partials (and a slice's
                                                   // vectors) a block
constexpr int kLongWarps = 8;                      // every warp computes
constexpr int kLongThreads = kLongWarps * kWarp;
constexpr int kLaneRows = 12;  // a lane's tile: kLaneRows x 8 elements
constexpr int kLaneElems = 8;
constexpr int kRowsHeld = 3;   // K vectors a lane holds at once
constexpr int kLongSegs = 2;   // segments (32 vectors of a row) a stage
constexpr int kLongStages = 7;
constexpr int kLongLag = 2;    // stages a refill waits behind the slowest warp
constexpr int kSliceBytes = kLongChains * 16;  // a block's part of a segment
constexpr int kLongOutputs =                   // a tile's rows x elements
    kLongWarps * kWarp * kLaneRows * kLaneElems / kLongChains;

// One segment of a lane's partials: X's vectors of its 8 elements held in
// registers, K's of its rows kRowsHeld at a time (one LDS.128 each, the same
// 128 bytes for the warp's 4 lane groups), then n products a pair (4, or
// cols % 4 for the partial vector) component by component, so that every
// partial takes x, y, z, w in order as in Vec<float>::dot_acc.
__device__ __forceinline__ void lane_tile(
    float (&acc)[kLaneRows][kLaneElems], const float4* ks, const float4* xs,
    int n) {
  float4 xv[kLaneElems];
#pragma unroll
  for (int e = 0; e < kLaneElems; ++e) xv[e] = xs[e * kLongChains];
#pragma unroll
  for (int h = 0; h < kLaneRows; h += kRowsHeld) {
    float4 kv[kRowsHeld];
#pragma unroll
    for (int i = 0; i < kRowsHeld; ++i) kv[i] = ks[(h + i) * kLongChains];
#pragma unroll
    for (int i = 0; i < kRowsHeld; ++i) {
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) {
        acc[h + i][e] = fmaf(kv[i].x, xv[e].x, acc[h + i][e]);
      }
    }
    if (n > 1) {
#pragma unroll
      for (int i = 0; i < kRowsHeld; ++i) {
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) {
          acc[h + i][e] = fmaf(kv[i].y, xv[e].y, acc[h + i][e]);
        }
      }
    }
    if (n > 2) {
#pragma unroll
      for (int i = 0; i < kRowsHeld; ++i) {
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) {
          acc[h + i][e] = fmaf(kv[i].z, xv[e].z, acc[h + i][e]);
        }
      }
    }
    if (n > 3) {
#pragma unroll
      for (int i = 0; i < kRowsHeld; ++i) {
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) {
          acc[h + i][e] = fmaf(kv[i].w, xv[e].w, acc[h + i][e]);
        }
      }
    }
  }
}

// The butterfly's tree over 32 partials held in one thread: level OFF adds
// partial L + OFF to partial L for L < OFF, then the next level.
template <int OFF>
__device__ __forceinline__ void fold_levels(float (&t)[kWarp]) {
#pragma unroll
  for (int L = 0; L < OFF; ++L) t[L] = t[L] + t[L + OFF];
  if constexpr (OFF > 1) fold_levels<OFF / 2>(t);
}

// A cluster owns a tile of RB rows x EB elements (RB EB = kLongOutputs, EB =
// 32 WE); block q of it holds partials 8 q, ..., 8 q + 7 of every output of
// the tile, so it copies and reads only bytes [128 q, 128 q + 128) of each
// 512-byte segment of K's rows and X's.  Warp (wr, we) holds rows kLaneRows
// wr + i and elements 32 we + 8 g + e of the tile, its lane c + 8 g partial
// 8 q + c.
template <int WE>
__global__ void __cluster_dims__(kLongCluster, 1, 1)
__launch_bounds__(kLongThreads, 1)
dense_matvec_shared_kernel_long(const float* __restrict__ M,
                                const float* __restrict__ x,
                                float* __restrict__ y, int rows, int cols,
                                int64_t ld, int batch, int64_t ldx,
                                int64_t ldy) {
  constexpr int EB = kWarp * WE;
  constexpr int RB = kLongOutputs / EB;
  constexpr int kKBytes = kLongSegs * RB * kSliceBytes;  // a stage's K part
  constexpr int kStageBytes = kKBytes + kLongSegs * EB * kSliceBytes;
  constexpr int kPe = RB + 1, kPc = EB * kPe + 1;  // the partials' strides
  constexpr int kKVecs = kKBytes / 16, kXVecs = kStageBytes / 16 - kKVecs;
  constexpr int kKCopies = (kKVecs + kLongThreads - 1) / kLongThreads;
  constexpr int kXCopies = (kXVecs + kLongThreads - 1) / kLongThreads;
  static_assert(kLongWarps / WE * kLaneRows == RB, "the warps cover a tile");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kLongStages];
  __shared__ __align__(8) uint64_t empty[kLongStages];

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int elem_blocks = (batch + EB - 1) / EB;
  const int tile = static_cast<int>(blockIdx.x / kLongCluster);
  const int r0 = tile / elem_blocks * RB, e0 = tile % elem_blocks * EB;
  const int nr = min(RB, rows - r0), ne = min(EB, batch - e0);
  const int nvec = cols / 4, tail = cols % 4;
  const int nlive = nvec + (tail ? 1 : 0);
  const int stages = (nlive + kLongSegs * kWarp - 1) / (kLongSegs * kWarp);
  const bool xvec =
      ldx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float4* const slots = reinterpret_cast<float4*>(ring);
  if (tid == 0) {
    for (int s = 0; s < kLongStages; ++s) {
      mbar_init(&full[s], kLongThreads);
      mbar_init(&empty[s], kLongWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // This thread's copies of a stage: vector cc of the slices rs = lr + m
  // kRowStep of the stage's K rows (segment rs / RB, row rs % RB) and of its
  // X rows,
  // 16 bytes each, from the pointers of stage 0 advanced 64 vectors a
  // stage.  A stage whose 64 vectors are all whole, with X's rows 16-byte
  // aligned, takes them as they are; any other copies only what lies
  // before cols, X's partial vector and unaligned rows by element.  Every
  // thread arrives on the stage's barrier once, when its copies land.
  constexpr int kRowStep = kLongThreads / kLongChains;
  constexpr int kStageFloats = kLongSegs * kWarp * 4;
  const int cc = tid % kLongChains, lr = tid / kLongChains;
  const float* ksrc[kKCopies];
  const float* xsrc[kXCopies];
#pragma unroll
  for (int m = 0; m < kKCopies; ++m) {
    const int rs = lr + m * kRowStep, r = rs % RB;
    ksrc[m] = rs < kLongSegs * RB && r < nr
                  ? M + (r0 + r) * ld +
                        4 * (rs / RB * kWarp + q * kLongChains + cc)
                  : nullptr;
  }
#pragma unroll
  for (int m = 0; m < kXCopies; ++m) {
    const int es = lr + m * kRowStep, e = es % EB;
    xsrc[m] = es < kLongSegs * EB && e < ne
                  ? x + (e0 + e) * ldx +
                        4 * (es / EB * kWarp + q * kLongChains + cc)
                  : nullptr;
  }
  auto load = [&](int k) {
    float4* st = slots + (k % kLongStages) * (kStageBytes / 16);
    const int64_t adv = static_cast<int64_t>(k) * kStageFloats;
    if (xvec && (k + 1) * kLongSegs * kWarp <= nvec) {
#pragma unroll
      for (int m = 0; m < kKCopies; ++m) {
        if (ksrc[m]) {
          cp_async16(st + (lr + m * kRowStep) * kLongChains + cc,
                     ksrc[m] + adv);
        }
      }
#pragma unroll
      for (int m = 0; m < kXCopies; ++m) {
        if (xsrc[m]) {
          cp_async16(st + kKVecs + (lr + m * kRowStep) * kLongChains + cc,
                     xsrc[m] + adv);
        }
      }
    } else {
      const int vk = k * kLongSegs * kWarp + q * kLongChains + cc;
#pragma unroll
      for (int m = 0; m < kKCopies; ++m) {
        const int rs = lr + m * kRowStep, v = vk + rs / RB * kWarp;
        if (ksrc[m] && v < nlive) {
          cp_async16(st + rs * kLongChains + cc, ksrc[m] + adv);
        }
      }
#pragma unroll
      for (int m = 0; m < kXCopies; ++m) {
        const int es = lr + m * kRowStep, v = vk + es / EB * kWarp;
        if (!xsrc[m] || v >= nlive) continue;
        float4* dst = st + kKVecs + es * kLongChains + cc;
        const float* src = xsrc[m] + adv;
        if (xvec && v < nvec) {
          cp_async16(dst, src);
        } else {
          for (int t = 0; t < min(4, cols - 4 * v); ++t) {
            cp_async<float>(reinterpret_cast<float*>(dst) + t, src + t);
          }
        }
      }
    }
    cp_async_arrive(&full[k % kLongStages]);
  };

  // The ring: kLongStages - kLongLag stages in flight ahead of the one
  // computing; a thread refills a slot once every warp has left the stage
  // it held, kLongLag stages back, so that no warp waits on one that is a
  // stage behind it.
  const int c = lane % kLongChains, g = lane / kLongChains;
  const int wr = warp / WE, we = warp % WE;
  const int krow = wr * kLaneRows * kLongChains + c;  // in float4
  const int xrow = kKVecs + (we * kWarp + g * kLaneElems) * kLongChains + c;
  float acc[kLaneRows][kLaneElems];
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) acc[i][e] = 0.0f;
  }
  for (int k = 0; k < min(stages, kLongStages - kLongLag); ++k) load(k);
  for (int k = 0; k < stages; ++k) {
    const int s = k % kLongStages;
    mbar_wait(&full[s], (k / kLongStages) & 1);
    const float4* st = slots + s * (kStageBytes / 16);
#pragma unroll
    for (int sg = 0; sg < kLongSegs; ++sg) {
      const int v = (k * kLongSegs + sg) * kWarp + q * kLongChains + c;
      const float4* ks = st + sg * RB * kLongChains + krow;
      const float4* xs = st + sg * EB * kLongChains + xrow;
      if (v < nvec) {
        lane_tile(acc, ks, xs, 4);
      } else if (v < nlive) {
        lane_tile(acc, ks, xs, tail);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    const int next = k + kLongStages - kLongLag;
    if (next < stages) {
      if (k >= kLongLag) {
        mbar_wait(&empty[next % kLongStages],
                  ((k - kLongLag) / kLongStages) & 1);
      }
      load(next);
    }
  }

  // The partials meet.  Each lane's go to this block's buffer over the
  // ring (every copy has landed), as [partial][element][row] at strides kPc
  // and kPe, padded so that a warp's 32 stores hit 32 banks.
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      part[c * kPc + (we * kWarp + g * kLaneElems + e) * kPe +
           wr * kLaneRows + i] = acc[i][e];
    }
  }
  cluster.sync();
  // Block q ends the outputs of elements [q EB / 4, (q + 1) EB / 4) of the
  // tile, every row: output (r, e)'s partial L is partial L % 8 of block
  // L / 8, summed in the butterfly's tree (offsets 16, 8, 4, 2, 1).  Each
  // thread's kEnds outputs read their partials all at once.
  constexpr int kEnds = kLongOutputs / kLongCluster / kLongThreads;
  static_assert(kEnds * kLongCluster * kLongThreads == kLongOutputs,
                "a block's outputs split evenly over its threads");
  float sum[kEnds][kWarp];
#pragma unroll
  for (int j = 0; j < kEnds; ++j) {
    const int o = tid + j * kLongThreads;
    const int e = q * (EB / kLongCluster) + o / RB, r = o % RB;
#pragma unroll
    for (int L = 0; L < kWarp; ++L) {
      sum[j][L] = cluster.map_shared_rank(part, L / kLongChains)
          [(L % kLongChains) * kPc + e * kPe + r];
    }
  }
#pragma unroll
  for (int j = 0; j < kEnds; ++j) {
    const int o = tid + j * kLongThreads;
    const int e = q * (EB / kLongCluster) + o / RB, r = o % RB;
    fold_levels<kWarp / 2>(sum[j]);
    if (r < nr && e < ne) y[(e0 + e) * ldy + r0 + r] = sum[j][0];
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Launches kLongCluster blocks a tile of RB x EB = kLongOutputs outputs
// (EB = 32 WE), with the ring of kLongStages stages that the partials'
// buffer reuses.
template <int WE>
int launch_shared_long_we(const float* M, const float* x, float* y, int rows,
                          int cols, int64_t ld, int batch, int64_t ldx,
                          int64_t ldy, void* stream) {
  constexpr int EB = kWarp * WE, RB = kLongOutputs / EB;
  constexpr int smem = kLongStages * (RB + EB) * kLongSegs * kSliceBytes;
  static_assert(smem <= kMaxSmem, "the ring fits a block");
  static_assert(kLongChains * (EB * (RB + 1) + 1) * 4 <= smem,
                "the partials' buffer fits the ring");
  const int64_t tiles = static_cast<int64_t>((rows + RB - 1) / RB) *
                        ((batch + EB - 1) / EB);
  if (kLongCluster * tiles >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      dense_matvec_shared_kernel_long<WE>, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_matvec_shared_kernel_long<WE><<<
      static_cast<unsigned>(kLongCluster * tiles), kLongThreads, smem,
      static_cast<cudaStream_t>(stream)>>>(M, x, y, rows, cols, ld, batch,
                                           ldx, ldy);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The stack kernel (stride_m != 0; see the batch axis above).
// ---------------------------------------------------------------------------

constexpr int kStackMaxSlots = 16;  // the stage barriers a block has

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dense_matvec_stack_kernel(const T* __restrict__ M, const T* __restrict__ x,
                          T* __restrict__ y, int rows, int cols, int64_t ld,
                          int64_t stride_m, int64_t ldx, int64_t ldy, int RB,
                          int chunk, int slots) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStackMaxSlots];
  __shared__ __align__(8) uint64_t empty[kStackMaxSlots];
  __shared__ __align__(8) uint64_t x_full;

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int item = static_cast<int>(sizeof(T));
  const int row_bytes = ((cols + 3) & ~3) * item;
  const bool whole = row_bytes <= chunk;
  const int chunks = whole ? 1 : (row_bytes + chunk - 1) / chunk;
  const int stride = min(row_bytes, chunk);  // a row's bytes in a stage
  // A stage: 8 rows' parts, then (longer rows) the same part of X[b].
  const int stage_bytes = (kConsumerWarps + (whole ? 0 : 1)) * stride;
  unsigned char* const ring = smem + (whole ? stride : 0);  // after X[b]
  const int row_blocks = (rows + RB - 1) / RB;
  const int64_t b = blockIdx.x / row_blocks;
  const int r0 = static_cast<int>(blockIdx.x % row_blocks) * RB;
  const int nr = min(RB, rows - r0);
  const int items = (nr + kConsumerWarps - 1) / kConsumerWarps * chunks;
  const T* xb = x + b * ldx;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], whole ? 1 : 1 + kWarp);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(&x_full, kWarp);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp
    const int64_t ld_bytes = ld * item;
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(M + b * stride_m) +
        r0 * ld_bytes;
    if (whole) {  // X[b] whole, once, at any stride and alignment
      T* xs = reinterpret_cast<T*>(smem);
      for (int k = lane; k < cols; k += kWarp) cp_async(xs + k, xb + k);
      cp_async_arrive(&x_full);
    }
    for (int i = 0; i < items; ++i) {
      const int s = i % slots;
      const int g = i / chunks, c = i - g * chunks;
      const int c0 = c * chunk;
      const int ng = min(kConsumerWarps, nr - g * kConsumerWarps);
      const uint32_t bytes = min(chunk, row_bytes - c0);
      unsigned char* dst = ring + s * stage_bytes;
      if (lane == 0) mbar_wait(&empty[s], ((i / slots) & 1) ^ 1);
      __syncwarp();
      if (!whole) {  // this part of X[b], beside K's
        const int e0 = c0 / item, e1 = min(cols, e0 + chunk / item);
        T* xs = reinterpret_cast<T*>(dst + kConsumerWarps * stride);
        for (int k = e0 + lane; k < e1; k += kWarp) {
          cp_async(xs + (k - e0), xb + k);
        }
        cp_async_arrive(&full[s]);
      }
      if (lane == 0) mbar_arrive_expect_tx(&full[s], bytes * ng);
      __syncwarp();
      if (bytes == 0) continue;  // cols == 0: the phase completes empty
      const unsigned char* src = kb + g * kConsumerWarps * ld_bytes + c0;
      // One copy where the group's rows lie back to back, else one a row.
      if (whole && ld_bytes == row_bytes) {
        if (lane == 0) bulk_copy(dst, src, bytes * ng, &full[s]);
      } else if (lane < ng) {
        bulk_copy(dst + lane * stride, src + lane * ld_bytes, bytes,
                  &full[s]);
      }
    }
    return;
  }

  // The consumers: warp w owns row 8 g + w of each group g, its partials
  // carried over the row's parts (each a multiple of 32 vectors, so lane L
  // keeps partial L).
  const int nvec = cols / W;
  const int tail = cols - nvec * W;
  const int nlive = nvec + (tail ? 1 : 0);
  const int cvec = stride / 16;  // vectors of a stage's row part
  if (whole) mbar_wait(&x_full, 0);
  T acc = T(0);
  for (int i = 0; i < items; ++i) {
    const int s = i % slots;
    const int g = i / chunks, c = i - g * chunks;
    const int j = g * kConsumerWarps + warp;  // the row in the tile
    mbar_wait(&full[s], (i / slots) & 1);
    if (j < nr) {  // warp-uniform
      const unsigned char* st = ring + s * stage_bytes;
      const V* kr = reinterpret_cast<const V*>(st + warp * stride);
      const V* xr = reinterpret_cast<const V*>(
          whole ? smem : st + kConsumerWarps * stride);
      const int v0 = c * cvec;
      const int count = min(cvec, nlive - v0);
      if (c == 0) acc = T(0);
      for (int lv = lane; lv < count; lv += kWarp) {
        acc = dot_acc_n(kr[lv], xr[lv], acc, v0 + lv < nvec ? W : tail);
      }
      if (c == chunks - 1) {
        acc = warp_sum(acc);
        if (lane == 0) y[b * ldy + r0 + j] = acc;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// Checks the wrapper's plan against what the kernel assumes, then launches
// one block a tile of RB rows of one element.
template <typename T>
int launch_stack(const T* M, const T* x, T* y, int rows, int cols,
                 int64_t ld, int batch, int64_t stride_m, int64_t ldx,
                 int64_t ldy, int RB, int chunk, int slots, void* stream) {
  if (rows <= 0 || batch <= 0) return 0;
  const int64_t row_bytes = ((static_cast<int64_t>(cols) + 3) & ~3) *
                            static_cast<int64_t>(sizeof(T));
  const bool whole = row_bytes <= chunk;
  const int64_t stride = std::min<int64_t>(row_bytes, chunk);
  const int64_t smem =
      (whole ? stride : 0) +
      static_cast<int64_t>(slots) * (kConsumerWarps + (whole ? 0 : 1)) *
          stride;
  const int64_t blocks = static_cast<int64_t>((rows + RB - 1) / RB) * batch;
  if (RB <= 0 || chunk <= 0 || chunk % 16 || slots < 1 ||
      slots > kStackMaxSlots || smem > kMaxSmem ||
      row_bytes >= (int64_t{1} << 31) || blocks >= (int64_t{1} << 31) ||
      (!whole && chunk % (16 * kWarp))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_done[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(dense_matvec_stack_kernel<T>,
                                             static_cast<int>(smem),
                                             smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_matvec_stack_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                                 static_cast<int>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      M, x, y, rows, cols, ld, stride_m, ldx, ldy, RB, chunk, slots);
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

// Y[b] = M_b X[b] for b < batch in one launch (see the batch axis above),
// by the wrapper's plan: a shared K (stride_m == 0) runs
// dense_matvec_shared_kernel (G, RB, EB, chunk, stages); a stack runs
// dense_matvec_stack_kernel (RB, chunk and `stages` slots; G and EB
// unused).
int tpdlp_dense_matvec_batch_f32(const float* M, const float* x, float* y,
                                 int rows, int cols, int64_t ld, int batch,
                                 int64_t stride_m, int64_t ldx, int64_t ldy,
                                 int G, int RB, int EB, int chunk, int stages,
                                 void* stream) {
  if (stride_m == 0) {
    return launch_shared<float>(M, x, y, rows, cols, ld, batch, ldx, ldy, G,
                                RB, EB, chunk, stages, stream);
  }
  return launch_stack<float>(M, x, y, rows, cols, ld, batch, stride_m, ldx,
                             ldy, RB, chunk, stages, stream);
}

int tpdlp_dense_matvec_batch_f64(const double* M, const double* x, double* y,
                                 int rows, int cols, int64_t ld, int batch,
                                 int64_t stride_m, int64_t ldx, int64_t ldy,
                                 int G, int RB, int EB, int chunk, int stages,
                                 void* stream) {
  if (stride_m == 0) {
    return launch_shared<double>(M, x, y, rows, cols, ld, batch, ldx, ldy, G,
                                 RB, EB, chunk, stages, stream);
  }
  return launch_stack<double>(M, x, y, rows, cols, ld, batch, stride_m, ldx,
                              ldy, RB, chunk, stages, stream);
}

// The same for a shared fp32 K on the cluster route
// (dense_matvec_shared_kernel_long): tiles of EB = 32 or 64 elements, the
// rest fixed by the kernel's constants; rows longer than kWholeRowBytes.
int tpdlp_dense_matvec_shared_long_f32(const float* M, const float* x,
                                       float* y, int rows, int cols,
                                       int64_t ld, int batch, int64_t ldx,
                                       int64_t ldy, int EB, void* stream) {
  const int64_t row_bytes = ((static_cast<int64_t>(cols) + 3) & ~3) * 4;
  if (rows <= 0 || batch <= 0) return 0;
  if (row_bytes <= kWholeRowBytes || row_bytes >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (EB == kWarp) {
    return launch_shared_long_we<1>(M, x, y, rows, cols, ld, batch, ldx, ldy,
                                    stream);
  }
  if (EB == 2 * kWarp) {
    return launch_shared_long_we<2>(M, x, y, rows, cols, ld, batch, ldx, ldy,
                                    stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpdlp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
