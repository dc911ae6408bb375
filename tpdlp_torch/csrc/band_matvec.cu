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
// Design against that bound: one pass over the slabs, with the slab stream
// never waiting on anything else.
// - The work is cut into units: a unit is the rows of one part of a row
//   group, as many as fit one 16 KB stage (a group of 128 rows at WB = 384
//   fp32 is 12 units of 10 rows and one of 8).  A persistent grid of two
//   blocks per SM walks the units (u = blockIdx.x + i * gridDim.x), which
//   keeps the SMs even where whole groups would not (235 groups on 264
//   blocks at WB = 2048).
// - A unit's rows are one contiguous block of the slabs.  One thread of the
//   slab warp streams them with 1D bulk copies (cp.async.bulk) into a ring
//   of kStages stages guarded by mbarriers: 64 KB in flight per block, 128
//   KB per SM, without a register spent on them.
// - The window warp fetches each unit's window x[start_g : start_g + WB]
//   into a ring of kWindows shared buffers, on its own barriers and ahead of
//   the consumers: the part below n, rounded down to whole 16 bytes, by a
//   bulk copy, the rest (x below n, then zeros) by plain stores.  Neither
//   the start's load nor the window's copy sits before a slab load.
// - kConsumerWarps warps own rows (row j of a unit goes to warp j % 8), two
//   at a time, so the second row's loads issue before the first row's
//   butterfly; each lane walks a row in 16-byte vectors (float4 / double2)
//   at a stride of 32 vectors against the shared window and reduces with a
//   fixed __shfl_xor_sync butterfly.  A row's sum order depends only on WB,
//   never on the grid or the warp that took it, so repeats are
//   bit-identical on every card.  No atomics, no tensor cores, no TF32.
//
// The batch axis (tpdlp_torch/batch: a fleet of LPs solved together, where
// the JAX package vmaps BandOp.mv/rmv and pallas_call's batching rule runs
// K2 over a batch grid axis).  One launch computes Y[b] = M_b X[b] for
// b < batch: element b's slabs are slabs + b * stride_s, its starts
// starts + b * stride_g (both 0 for one band K shared by the fleet), its x
// x + b * ldx and its y y + b * ldy.  The persistent loop walks (element,
// unit) pairs, u = b * units + unit, so a row's sum is exactly the single
// launch's.  Every element has n columns: a window that runs past n reads
// zeros, never the next element's x, which matters for a stacked fleet
// whose windows were widened past its padded column count.  batch = 1 with
// zero strides is the single-vector launch.
//
// Layout contract (checked by the Python wrapper, tpdlp_torch/ops/_kernels.py):
// slabs is a contiguous, 16-byte-aligned (ngroups, R, WB) array with WB a
// multiple of 4 elements and at most kMaxRowBytes per row, so every slab row
// starts on a 16-byte boundary; ngroups * R >= m; starts is int32
// (ngroups,); x is 16-byte aligned (in a batch, ldx, stride_s and the
// slabs' row width keep every element so).  A start that is not a multiple of 16
// bytes takes its whole window by plain loads.  Rows >= m are never read
// and y has exactly m entries.  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.

#include "pipeline.cuh"

namespace {

using namespace tpdlp;

constexpr int kConsumerWarps = 8;
constexpr int kSlabWarp = kConsumerWarps;        // streams the slab rows
constexpr int kWindowWarp = kConsumerWarps + 1;  // fetches the windows
constexpr int kThreads = (kConsumerWarps + 2) * kWarp;
constexpr int kMaxRowBytes = 16 * 1024;  // the widest row: 2048 fp64
constexpr int kStageBytes = 16 * 1024;
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kWindows = 3;      // windows of x in flight
constexpr int kBlocksPerSm = 2;  // 2 x (64 KB ring + 3 windows) fit an SM

// The work of a block is a list of units: a unit is the rows of one part of
// a row group, at most one stage of them.  A group of R rows splits into
// `parts` units of `unit_rows` rows (the last one shorter); units are
// numbered group by group and cover exactly the rows below m.
struct Units {
  int parts, unit_rows, count;
  __host__ __device__ Units(int m, int R, int row_bytes) {
    const int max_rows = kStageBytes / row_bytes;
    parts = (R + max_rows - 1) / max_rows;
    unit_rows = (R + parts - 1) / parts;
    const int rem = m % R;
    count = (m / R) * parts + (rem + unit_rows - 1) / unit_rows;
  }
  __device__ int group(int u) const { return u / parts; }
  __device__ int64_t row0(int u, int R) const {
    return static_cast<int64_t>(u / parts) * R +
           static_cast<int64_t>(u % parts) * unit_rows;
  }
  __device__ int rows(int u, int R, int m) const {
    const int64_t r0 = row0(u, R);
    const int in_group = min(unit_rows, R - (u % parts) * unit_rows);
    const int64_t left = static_cast<int64_t>(m) - r0;
    return left < in_group ? static_cast<int>(left) : in_group;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
band_matvec_kernel(const T* __restrict__ slabs,
                   const int32_t* __restrict__ starts,
                   const T* __restrict__ x, T* __restrict__ y, int m, int n,
                   int R, int WB, int batch, int64_t stride_s,
                   int64_t stride_g, int64_t ldx, int64_t ldy) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  // Dynamic shared memory: the ring, then kWindows windows of WB elements.
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  T* windows = reinterpret_cast<T*>(smem + kRingBytes);
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t win_full[kWindows];
  __shared__ __align__(8) uint64_t win_empty[kWindows];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int b = 0; b < kWindows; ++b) {
      mbar_init(&win_full[b], kWarp);  // every window-warp lane arrives
      mbar_init(&win_empty[b], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int row_bytes = WB * static_cast<int>(sizeof(T));
  const Units units(m, R, row_bytes);
  const int64_t work = static_cast<int64_t>(units.count) * batch;

  if (warp == kSlabWarp) {  // one thread streams the units' slab rows
    if (lane != 0) return;
    int i = 0;
    for (int64_t w = blockIdx.x; w < work; w += gridDim.x, ++i) {
      const int64_t b = batch == 1 ? 0 : w / units.count;
      const int u = static_cast<int>(w - b * units.count);
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const uint32_t bytes = units.rows(u, R, m) * row_bytes;
      mbar_arrive_expect_tx(&full[s], bytes);
      bulk_copy(ring + s * kStageBytes,
                slabs + b * stride_s + units.row0(u, R) * WB, bytes,
                &full[s]);
    }
    return;
  }

  if (warp == kWindowWarp) {  // fetches each unit's window ahead
    int i = 0;
    for (int64_t w = blockIdx.x; w < work; w += gridDim.x, ++i) {
      const int64_t e = batch == 1 ? 0 : w / units.count;  // the element
      const int u = static_cast<int>(w - e * units.count);
      const T* xe = x + e * ldx;
      const int b = i % kWindows;
      T* win = windows + b * WB;
      if (lane == 0) mbar_wait(&win_empty[b], ((i / kWindows) & 1) ^ 1);
      __syncwarp();
      const int start = __ldg(starts + e * stride_g + units.group(u));
      const int live = max(0, min(WB, n - start));  // window columns < n
      // The bulk part: whole 16-byte pieces, from a 16-byte-aligned start.
      const int bulk = start % (16 / static_cast<int>(sizeof(T))) == 0
                           ? live & ~(16 / static_cast<int>(sizeof(T)) - 1)
                           : 0;
      for (int w = bulk + lane; w < WB; w += kWarp) {
        win[w] = w < live ? __ldg(xe + start + w) : T(0);
      }
      fence_proxy_async();  // before a later bulk copy into these bytes
      __syncwarp();
      if (lane == 0 && bulk > 0) {
        mbar_arrive_expect_tx(&win_full[b], bulk * sizeof(T));
        bulk_copy(win, xe + start, bulk * sizeof(T), &win_full[b]);
      } else {
        mbar_arrive(&win_full[b]);
      }
    }
    return;
  }

  // The consumers: warp w takes rows w, w + 8, ... of each unit, two at a
  // time, so that the second row's loads issue before the first row's
  // butterfly.
  const int nvec = WB / W;
  int i = 0;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x, ++i) {
    const int64_t e = batch == 1 ? 0 : w / units.count;  // the element
    const int u = static_cast<int>(w - e * units.count);
    T* ye = y + e * ldy;
    const int s = i % kStages;
    const int b = i % kWindows;
    const V* wv = reinterpret_cast<const V*>(windows + b * WB);
    const int64_t row0 = units.row0(u, R);
    const int nr = units.rows(u, R, m);
    mbar_wait(&win_full[b], (i / kWindows) & 1);
    mbar_wait(&full[s], (i / kStages) & 1);
    const V* st = reinterpret_cast<const V*>(ring + s * kStageBytes);
    for (int j = warp; j < nr; j += 2 * kConsumerWarps) {
      const int j2 = j + kConsumerWarps;
      const bool two = j2 < nr;
      const V* s0 = st + static_cast<int64_t>(j) * nvec;
      const V* s1 = st + static_cast<int64_t>(two ? j2 : j) * nvec;
      T a0 = T(0), a1 = T(0);
#pragma unroll 4
      for (int v = lane; v < nvec; v += kWarp) {
        const V xw = wv[v];
        a0 = Vec<T>::dot_acc(s0[v], xw, a0);
        a1 = Vec<T>::dot_acc(s1[v], xw, a1);
      }
      a0 = warp_sum(a0);
      a1 = warp_sum(a1);
      if (lane == 0) {
        ye[row0 + j] = a0;
        if (two) ye[row0 + j2] = a1;
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[s]);
      mbar_arrive(&win_empty[b]);
    }
  }
}

template <typename T>
int launch(const T* slabs, const int32_t* starts, const T* x, T* y, int m,
           int n, int R, int WB, int batch, int64_t stride_s,
           int64_t stride_g, int64_t ldx, int64_t ldy, void* stream) {
  if (m <= 0 || batch <= 0) return 0;
  const int row_bytes = WB * static_cast<int>(sizeof(T));
  if (WB <= 0 || row_bytes > kMaxRowBytes || R <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kRingBytes + kWindows * row_bytes;
  static int smem_done[kMaxDevices] = {};
  const cudaError_t err =
      allow_dynamic_smem(band_matvec_kernel<T>, smem, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Units units(m, R, row_bytes);
  const int64_t work = static_cast<int64_t>(units.count) * batch;
  const unsigned blocks = static_cast<unsigned>(
      std::min<int64_t>(work, kBlocksPerSm * sms));
  band_matvec_kernel<T><<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      slabs, starts, x, y, m, n, R, WB, batch, stride_s, stride_g, ldx, ldy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 = launched).
int tpdlp_band_matvec_f32(const float* slabs, const int32_t* starts,
                          const float* x, float* y, int m, int n, int R,
                          int WB, void* stream) {
  return launch<float>(slabs, starts, x, y, m, n, R, WB, 1, 0, 0, 0, 0,
                       stream);
}

int tpdlp_band_matvec_f64(const double* slabs, const int32_t* starts,
                          const double* x, double* y, int m, int n, int R,
                          int WB, void* stream) {
  return launch<double>(slabs, starts, x, y, m, n, R, WB, 1, 0, 0, 0, 0,
                        stream);
}

// Y[b] = M_b X[b] for b < batch in one launch (see the batch axis above).
int tpdlp_band_matvec_batch_f32(const float* slabs, const int32_t* starts,
                                const float* x, float* y, int m, int n,
                                int R, int WB, int batch, int64_t stride_s,
                                int64_t stride_g, int64_t ldx, int64_t ldy,
                                void* stream) {
  return launch<float>(slabs, starts, x, y, m, n, R, WB, batch, stride_s,
                       stride_g, ldx, ldy, stream);
}

int tpdlp_band_matvec_batch_f64(const double* slabs, const int32_t* starts,
                                const double* x, double* y, int m, int n,
                                int R, int WB, int batch, int64_t stride_s,
                                int64_t stride_g, int64_t ldx, int64_t ldy,
                                void* stream) {
  return launch<double>(slabs, starts, x, y, m, n, R, WB, batch, stride_s,
                        stride_g, ldx, ldy, stream);
}

}  // extern "C"
