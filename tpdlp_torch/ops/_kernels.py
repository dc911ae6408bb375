"""Hand-written CUDA kernels: build, ctypes binding, wrappers, plain twins.

Kernels live in `tpdlp_torch/csrc/*.cu`.  At the first call that needs
them, one `nvcc` per source compiles it (all started together), and the
objects are linked into one shared library with a plain C interface, in
`build/tpdlp_torch/` at the root of the checkout (ignored by git).  The
library's file name carries a hash of every source and header in `csrc/`
and of the flags, so an edited source or header is rebuilt and concurrent
processes never load a half-written file.

Nothing CUDA-specific happens at import: the CPU tests import every module.
Each wrapper takes its kernel's plain PyTorch twin only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.  There is
no fallback.

`launches` counts kernel launches by name (a wrapper adds one where it
launches, nowhere else), so a run can show that its main path went through
the kernels.  The batched wrappers (`*_batch`: one launch computes
Y[b] = M_b X[b] for every element b of a fleet, the batch axis that the
JAX package's vmap gives pallas_call) count under their own names.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from tpdlp_torch.timer import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpdlp_torch"
SOURCES = ("dense_matvec.cu", "band_matvec.cu", "csr_matvec.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: Row strides of matrices handed to the kernels are multiples of this many
#: elements, so 16-byte vector loads stay aligned (4 fp32 / 2 fp64 per load).
ROW_ALIGN = 4

launches = {"dense_matvec": 0, "band_matvec": 0, "csr_matvec": 0,
            "dense_matvec_batch": 0, "band_matvec_batch": 0,
            "csr_matvec_batch": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
        "kernels of tpdlp_torch are built from source at first use"
    )


def library_path(csrc: Path = CSRC) -> Path:
    """The library built from `csrc`: named by a hash of every `*.cu` and
    `*.cuh` there (a header change rebuilds too) and of the flags."""
    h = hashlib.sha256()
    for path in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpdlp_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise on the first that fails, and
    leave none running."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}\n{err}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()


def build() -> Path:
    """Compile the kernels (if not yet built) and return the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                  for s, o in zip(SOURCES, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            with span("library"):
                lib = ctypes.CDLL(str(build()))
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_void_p]
            for fn in (lib.tpdlp_dense_matvec_f32,
                       lib.tpdlp_dense_matvec_f64):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            band_args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            for fn in (lib.tpdlp_band_matvec_f32, lib.tpdlp_band_matvec_f64):
                fn.argtypes = band_args
                fn.restype = ctypes.c_int
            csr_args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
            for fn in (lib.tpdlp_csr_matvec_f32, lib.tpdlp_csr_matvec_f64,
                       lib.tpdlp_csr_matvec_ring_f32,
                       lib.tpdlp_csr_matvec_ring_f64):
                fn.argtypes = csr_args
                fn.restype = ctypes.c_int
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            batch_args = {
                "dense": [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, i64,
                          ctypes.c_int, i64, i64, i64, *[ctypes.c_int] * 5,
                          ptr],
                "band": [ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, i64, i64,
                         i64, i64, ptr],
                "csr": [ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, i64, i64, ptr],
            }
            for kind, argtypes in batch_args.items():
                for t in ("f32", "f64"):
                    fn = getattr(lib, f"tpdlp_{kind}_matvec_batch_{t}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            for t in ("f32", "f64"):
                fn = getattr(lib, f"tpdlp_csr_matvec_ring_batch_{t}")
                fn.argtypes = batch_args["csr"]
                fn.restype = ctypes.c_int
            lib.tpdlp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpdlp_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _load().tpdlp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# K1: dense matvec (replaces tpdlp/ops/pallas_dense.py::_matvec_kernel)
# ---------------------------------------------------------------------------


#: Elements per row block of the plain matvec on the CPU (keeps the
#: product's temporary in cache; measured 1.1 ms instead of 5.9 ms for a
#: 846 x 2000 fp64 product on two threads).
_PLAIN_CPU_BLOCK = 1 << 17


def dense_matvec_plain(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M x in M's dtype: the plain PyTorch twin of the dense_matvec
    kernel (elementwise products, then a row sum; on the CPU in blocks of
    rows)."""
    m, n = M.shape
    rows = max(1, _PLAIN_CPU_BLOCK // max(1, n))
    if M.device.type != "cpu" or rows >= m:
        return (M * x).sum(dim=1)
    return torch.cat([(M[i:i + rows] * x).sum(dim=1)
                      for i in range(0, m, rows)])


def dense_matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M x for a row-major (rows, cols) view M whose row stride is a
    multiple of ROW_ALIGN elements.

    CPU tensors take `dense_matvec_plain`.  CUDA tensors launch the
    hand-written kernel (csrc/dense_matvec.cu) on the current stream; the
    call does not synchronise."""
    if M.device.type == "cpu" and x.device.type == "cpu":
        return dense_matvec_plain(M, x)
    if M.device.type != "cuda" or x.device != M.device:
        raise ValueError(
            f"dense_matvec: M on {M.device}, x on {x.device}; both must be "
            "on the same CUDA device (or both on the CPU)"
        )
    if M.dtype not in (torch.float32, torch.float64) or x.dtype != M.dtype:
        raise TypeError(
            f"dense_matvec: dtypes {M.dtype}/{x.dtype}; the kernel takes "
            "float32 or float64, the same for M and x"
        )
    if M.dim() != 2 or x.dim() != 1 or x.shape[0] != M.shape[1]:
        raise ValueError(
            f"dense_matvec: shapes {tuple(M.shape)} @ {tuple(x.shape)}"
        )
    rows, cols = M.shape
    ld = M.stride(0) if rows > 1 else max(M.stride(0), cols)
    if (M.stride(1) != 1 and cols > 1) or ld % ROW_ALIGN or ld < cols:
        raise ValueError(
            f"dense_matvec: strides {M.stride()} — rows must be contiguous "
            f"with a row stride that is a multiple of {ROW_ALIGN}"
        )
    if x.stride(0) != 1 and cols > 1:
        raise ValueError("dense_matvec: x must be contiguous")
    if M.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("dense_matvec: M and x must be 16-byte aligned")
    if rows >= 2**31 or cols >= 2**31:
        raise ValueError("dense_matvec: dimension exceeds int32")
    lib = _load()
    y = torch.empty(rows, dtype=M.dtype, device=M.device)
    fn = (lib.tpdlp_dense_matvec_f32 if M.dtype == torch.float32
          else lib.tpdlp_dense_matvec_f64)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        code = fn(M.data_ptr(), x.data_ptr(), y.data_ptr(), rows, cols, ld,
                  stream)
    _check(code, "dense_matvec launch")
    launches["dense_matvec"] += 1
    return y


# ---------------------------------------------------------------------------
# K2: band-slab matvec (replaces tpdlp/ops/band.py::_band_kernel)
# ---------------------------------------------------------------------------

#: The widest slab row the kernel takes (kMaxRowBytes in
#: csrc/band_matvec.cu: WB = 2048 in fp64): a row must fit one stage of its
#: shared-memory ring, and two blocks per SM must fit their windows.
_MAX_WINDOW_BYTES = 16 * 1024


def band_matvec_plain(slabs: torch.Tensor, starts: torch.Tensor,
                      x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """y = M x for band slabs, in slabs' dtype: the plain PyTorch twin of
    the band_matvec kernel, with the JAX `matvec_xla` arithmetic (gather
    each group's window x[start_g : start_g + WB], zero past n, multiply by
    the slab, sum over the window, keep the first m rows).  Only the groups
    that hold rows below m are computed; on the CPU in blocks of groups."""
    R, WB = slabs.shape[1:]
    live = -(-m // R)
    slabs, starts = slabs[:live], starts[:live]
    ngroups = slabs.shape[0]
    col = starts.long()[:, None] + torch.arange(WB, device=x.device)
    win = torch.where(col < n, x[col.clamp(max=n - 1)], x.new_zeros(()))
    groups = max(1, _PLAIN_CPU_BLOCK // max(1, R * WB))
    if slabs.device.type != "cpu" or groups >= ngroups:
        y = (slabs * win[:, None, :]).sum(dim=2)
    else:
        y = torch.cat([(slabs[i:i + groups] * win[i:i + groups, None, :])
                       .sum(dim=2) for i in range(0, ngroups, groups)])
    return y.reshape(-1)[:m]


def band_matvec(slabs: torch.Tensor, starts: torch.Tensor, x: torch.Tensor,
                m: int, n: int) -> torch.Tensor:
    """y (m,) = M x for the band slabs of an (m, n) matrix M: slabs
    (ngroups, R, WB), starts (ngroups,) int32, x (n,).

    CPU tensors take `band_matvec_plain`.  CUDA tensors launch the
    hand-written kernel (csrc/band_matvec.cu) on the current stream; the
    call does not synchronise."""
    tensors = (slabs, starts, x)
    if all(t.device.type == "cpu" for t in tensors):
        return band_matvec_plain(slabs, starts, x, m, n)
    if slabs.device.type != "cuda" or any(t.device != slabs.device
                                          for t in tensors):
        raise ValueError(
            f"band_matvec: slabs on {slabs.device}, starts on "
            f"{starts.device}, x on {x.device}; all must be on the same "
            "CUDA device (or all on the CPU)"
        )
    if slabs.dtype not in (torch.float32, torch.float64) or (
            x.dtype != slabs.dtype):
        raise TypeError(
            f"band_matvec: dtypes {slabs.dtype}/{x.dtype}; the kernel takes "
            "float32 or float64, the same for slabs and x"
        )
    if starts.dtype != torch.int32:
        raise TypeError(f"band_matvec: starts dtype {starts.dtype}, "
                        "expected int32")
    if slabs.dim() != 3 or starts.shape != (slabs.shape[0],) or (
            x.shape != (n,)):
        raise ValueError(
            f"band_matvec: shapes slabs {tuple(slabs.shape)}, starts "
            f"{tuple(starts.shape)}, x {tuple(x.shape)} for n = {n}"
        )
    ngroups, R, WB = slabs.shape
    if not 0 <= m <= ngroups * R or n < 1:
        raise ValueError(
            f"band_matvec: m = {m}, n = {n} outside the {ngroups} x {R} "
            "row groups"
        )
    if WB % ROW_ALIGN or WB * slabs.element_size() > _MAX_WINDOW_BYTES:
        raise ValueError(
            f"band_matvec: window {WB} must be a multiple of {ROW_ALIGN} "
            f"and at most {_MAX_WINDOW_BYTES} bytes"
        )
    if not (slabs.is_contiguous() and starts.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("band_matvec: slabs, starts and x must be "
                         "contiguous")
    if slabs.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("band_matvec: slabs and x must be 16-byte aligned")
    if max(ngroups * R, n, WB) >= 2**31:
        raise ValueError("band_matvec: dimension exceeds int32")
    y = torch.empty(m, dtype=slabs.dtype, device=slabs.device)
    if m == 0:
        return y
    lib = _load()
    fn = (lib.tpdlp_band_matvec_f32 if slabs.dtype == torch.float32
          else lib.tpdlp_band_matvec_f64)
    stream = torch.cuda.current_stream(slabs.device).cuda_stream
    with torch.cuda.device(slabs.device):
        code = fn(slabs.data_ptr(), starts.data_ptr(), x.data_ptr(),
                  y.data_ptr(), m, n, R, WB, stream)
    _check(code, "band_matvec launch")
    launches["band_matvec"] += 1
    return y


# ---------------------------------------------------------------------------
# CSR matvec (no TPU kernel behind it: the JAX sparse layout is plain XLA;
# this kernel makes the port's sparse products replay bit for bit)
# ---------------------------------------------------------------------------


def csr_group(rows: int, nnz: int) -> int:
    """Lanes per row of the csr_matvec kernel: the mean row length rounded
    up to a power of two, between 2 and 32 (a function of the matrix alone,
    so a matrix's products keep one summation order)."""
    mean = -(-nnz // max(rows, 1))
    return min(32, max(2, 1 << max(mean - 1, 0).bit_length()))


#: The csr_matvec kernel's ring (csrc/csr_matvec.cu: kConsumerWarps,
#: kStageNnz, kStages, kBlocksPerSm, kRows, kBatchTile, kBatchBlocksPerSm):
#: 8 consumer warps, stages of 1024 nonzeros (each the 16-byte-aligned
#: supersets of their values and column indices), three stages, four blocks
#: an SM and four rows a lane group for a single vector; the batch axis in
#: tiles of 8 elements, one row a lane group, two blocks an SM.  A matrix
#: takes the ring when a persistent wave gives every block at least
#: _CSR_RING_MIN_STAGES stages, else the direct route (kDirectThreads
#: threads a block, one row a lane group).
_CSR_WARPS = 8
_CSR_STAGE_NNZ = 1024
_CSR_STAGES = 3
_CSR_BLOCKS_PER_SM = 4
_CSR_ROWS = 4
_CSR_BATCH_TILE = 8
_CSR_BATCH_BLOCKS_PER_SM = 2
_CSR_RING_MIN_STAGES = 4
_CSR_DIRECT_THREADS = 256


class CsrPlan(NamedTuple):
    """A launch of the csr_matvec kernel.  `path` is its route: "ring"
    (nonzeros streamed through shared memory) or "direct" (loaded straight
    from device memory).  G lanes a row, R rows a lane group at once,
    chunks of `chunk_rows` rows (`chunks` of them an element tile of
    `tile` elements, `tiles` tiles), `grid` blocks, stages of `stage_nnz`
    nonzeros in a ring of `stages`, `smem` bytes of ring a block.  The
    direct route's chunk is a block's rows (no stage, no ring)."""
    path: str
    G: int
    R: int
    chunk_rows: int
    chunks: int
    tile: int
    tiles: int
    grid: int
    stage_nnz: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=1024)
def csr_ring_plan(rows: int, nnz: int, item: int, batch: int,
                  sms: int) -> CsrPlan:
    """The ring route's launch for `rows` rows and `nnz` nonzeros of
    `item`-byte values, `batch` right-hand sides (1: the single-vector
    launch) on a card of `sms` SMs: the rule the kernel's launcher
    applies, a function of these numbers alone.  A chunk is R rows for
    each lane group of the consumer warps (csr_chunks); the grid is
    persistent, at most a wave, each block a contiguous run of (tile,
    chunk) items (csr_block_segments)."""
    G = csr_group(rows, nnz)
    tile = 1 if batch == 1 else _CSR_BATCH_TILE
    R = _CSR_ROWS if tile == 1 else 1
    chunk_rows = _CSR_WARPS * R * (32 // G)
    chunks = -(-rows // chunk_rows)
    tiles = -(-batch // tile)
    per_sm = _CSR_BLOCKS_PER_SM if tile == 1 else _CSR_BATCH_BLOCKS_PER_SM
    grid = min(chunks * tiles, per_sm * sms)
    stage = 2 * 16 + _CSR_STAGE_NNZ * (item + 4)
    return CsrPlan("ring", G, R, chunk_rows, chunks, tile, tiles, grid,
                   _CSR_STAGE_NNZ, _CSR_STAGES, _CSR_STAGES * stage)


@functools.lru_cache(maxsize=1024)
def csr_plan(rows: int, nnz: int, item: int, batch: int,
             sms: int) -> CsrPlan:
    """The csr_matvec kernel's route and launch: the ring (csr_ring_plan)
    when a persistent wave of its blocks would stream at least
    _CSR_RING_MIN_STAGES stages each (nonzeros a tile times tiles), else
    the direct route, a block of _CSR_DIRECT_THREADS threads for every
    256 / G (element, row) pairs.  Both routes sum in the same order."""
    ring = csr_ring_plan(rows, nnz, item, batch, sms)
    per_sm = _CSR_BLOCKS_PER_SM if ring.tile == 1 else (
        _CSR_BATCH_BLOCKS_PER_SM)
    if nnz * ring.tiles >= (_CSR_RING_MIN_STAGES * _CSR_STAGE_NNZ * per_sm
                            * sms):
        return ring
    per_block = _CSR_DIRECT_THREADS // ring.G
    blocks = -(-rows * batch // per_block)
    return CsrPlan("direct", ring.G, 1, per_block, blocks, 1, batch, blocks,
                   0, 0, 0)


def csr_chunks(crow, chunk_rows: int) -> list:
    """The kernel's chunks of a CSR matrix with row offsets `crow`: (first
    row, end row, first nonzero, end nonzero) of each, in order.  A chunk
    is `chunk_rows` whole rows (the ring plan's: a function of the row
    count, the nonzeros and the batch; the last one shorter), so chunks start on
    row boundaries and depend on crow alone, never on the grid; its
    nonzeros are one contiguous span."""
    crow = [int(v) for v in crow]
    rows = len(crow) - 1
    return [(r, min(r + chunk_rows, rows), crow[r],
             crow[min(r + chunk_rows, rows)])
            for r in range(0, rows, chunk_rows)]


def csr_block_segments(plan: CsrPlan, rows: int, block: int) -> list:
    """Block `block`'s segments, in the kernel's order: (element tile,
    first row, end row) runs of whole chunks, one tile each."""
    work = plan.chunks * plan.tiles
    w, end = work * block // plan.grid, work * (block + 1) // plan.grid
    out = []
    while w < end:
        t = w // plan.chunks
        last = min(end, (t + 1) * plan.chunks)
        out.append((t, (w - t * plan.chunks) * plan.chunk_rows,
                    min(rows, (last - t * plan.chunks) * plan.chunk_rows)))
        w = last
    return out


#: The C entry points' infix of each route.
_CSR_ENTRY = {"ring": "_ring", "direct": ""}


def csr_matvec_plain(crow: torch.Tensor, col: torch.Tensor,
                     val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M x for the CSR arrays of M, in val's dtype: the plain PyTorch
    twin of the csr_matvec kernel (each nonzero times its x entry, then a
    sum over each row's segment; 0 for an empty row)."""
    return torch.segment_reduce(val * x[col.long()], "sum", offsets=crow)


def csr_matvec(crow: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y (rows,) = M x for M in CSR form: crow (rows + 1,) int32 row
    offsets, col (nnz,) int32 column indices in [0, x.numel()), val (nnz,).

    CPU tensors take `csr_matvec_plain`.  CUDA tensors launch the
    hand-written kernel (csrc/csr_matvec.cu) on the current stream, by the
    route `csr_plan` picks; the call does not synchronise."""
    tensors = (crow, col, val, x)
    if all(t.device.type == "cpu" for t in tensors):
        return csr_matvec_plain(crow, col, val, x)
    if val.device.type != "cuda" or any(t.device != val.device
                                        for t in tensors):
        raise ValueError(
            f"csr_matvec: crow on {crow.device}, col on {col.device}, val "
            f"on {val.device}, x on {x.device}; all must be on the same "
            "CUDA device (or all on the CPU)"
        )
    if val.dtype not in (torch.float32, torch.float64) or x.dtype != val.dtype:
        raise TypeError(
            f"csr_matvec: dtypes {val.dtype}/{x.dtype}; the kernel takes "
            "float32 or float64, the same for val and x"
        )
    if crow.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"csr_matvec: index dtypes {crow.dtype}/{col.dtype}, "
                        "expected int32")
    if (crow.dim() != 1 or col.dim() != 1 or val.dim() != 1 or x.dim() != 1
            or col.shape != val.shape or crow.numel() < 1):
        raise ValueError(
            f"csr_matvec: shapes crow {tuple(crow.shape)}, col "
            f"{tuple(col.shape)}, val {tuple(val.shape)}, x {tuple(x.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("csr_matvec: crow, col, val and x must be "
                         "contiguous")
    rows, nnz = crow.numel() - 1, val.numel()
    if max(rows, nnz, x.numel()) >= 2**31:
        raise ValueError("csr_matvec: dimension exceeds int32")
    y = torch.empty(rows, dtype=val.dtype, device=val.device)
    if rows == 0:
        return y
    plan = csr_plan(rows, nnz, val.element_size(), 1, _sm_count(val.device))
    lib = _load()
    fn = getattr(lib, f"tpdlp_csr_matvec{_CSR_ENTRY[plan.path]}_"
                      f"{'f32' if val.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(val.device).cuda_stream
    with torch.cuda.device(val.device):
        code = fn(crow.data_ptr(), col.data_ptr(), val.data_ptr(),
                  x.data_ptr(), y.data_ptr(), rows, plan.G, stream)
    _check(code, "csr_matvec launch")
    launches["csr_matvec"] += 1
    return y


# ---------------------------------------------------------------------------
# The batch axis: one launch for every element of a fleet
# (tpdlp_torch/batch).  The JAX package vmaps ExactDenseOp.mv/rmv and
# BandOp.mv/rmv, and pallas_call's batching rule runs K1 and K2 over a batch
# grid axis; here the axis is written out.  Element b's result equals, bit
# for bit, a single launch on element b.
# ---------------------------------------------------------------------------


def _padded_rows(X: torch.Tensor) -> torch.Tensor:
    """X (B, c), contiguous, its row stride a multiple of ROW_ALIGN (zero
    columns appended where c is not) and its base 16-byte aligned (a copy
    of a view that starts off the alignment), so that every X[b] is
    16-byte aligned, as K2's bulk copies of x need."""
    X = X.contiguous()
    c = X.shape[1]
    if c % ROW_ALIGN:
        X = torch.nn.functional.pad(X, (0, ROW_ALIGN - c % ROW_ALIGN))
    elif X.data_ptr() % 16:
        X = X.clone()
    return X


def _check_batch(name, mats, X, shared_dims):
    """Device and dtype checks shared by the batched wrappers: every tensor
    of `mats` and X on one CUDA device, float32 or float64 like X, X of
    rank 2, and a stacked operand's leading dimension X's batch."""
    if mats[0].device.type != "cuda" or any(
            t.device != mats[0].device for t in (*mats, X)):
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in (*mats, X)]}; all "
            "must be on the same CUDA device (or all on the CPU)")
    if X.dtype not in (torch.float32, torch.float64) or (
            mats[0].dtype != X.dtype):
        raise TypeError(f"{name}: dtypes {mats[0].dtype}/{X.dtype}; the "
                        "kernel takes float32 or float64, the same for both")
    if X.dim() != 2 or mats[0].dim() not in (shared_dims, shared_dims + 1):
        raise ValueError(f"{name}: shapes {tuple(mats[0].shape)} and "
                         f"{tuple(X.shape)}")
    if mats[0].dim() == shared_dims + 1 and mats[0].shape[0] != X.shape[0]:
        raise ValueError(f"{name}: a stack of {mats[0].shape[0]} matrices "
                         f"for {X.shape[0]} vectors")


def dense_matvec_batch_plain(M: torch.Tensor,
                             X: torch.Tensor) -> torch.Tensor:
    """Y (B, rows) with Y[b] = M_b X[b], M (rows, cols) shared or
    (B, rows, cols) stacked, X (B, cols): the plain twin of
    dense_matvec_batch, element by element the arithmetic of
    `dense_matvec_plain` (on the CPU in blocks of elements)."""
    rows, cols = M.shape[-2:]
    B = X.shape[0]
    Mb = M if M.dim() == 3 else M.unsqueeze(0)
    step = max(1, _PLAIN_CPU_BLOCK // max(1, rows * cols))
    if M.device.type != "cpu" or step >= B:
        return (Mb * X[:, None, :]).sum(dim=2)
    return torch.cat([
        ((Mb[i:i + step] if M.dim() == 3 else Mb) * X[i:i + step, None, :])
        .sum(dim=2) for i in range(0, B, step)])


#: The shared-K kernel's tiles (csrc/dense_matvec.cu: kWholeRowBytes,
#: kSharedStages): rows of at most _WHOLE_ROW_BYTES sit whole in one stage,
#: whose tile takes at most _WHOLE_TILE_SMEM bytes (two blocks an SM: 228
#: KB an SM, 1 KB of it reserved a block); longer rows stream in
#: _CHUNK_BYTES parts (a multiple of 32 vectors) through a two-stage ring.
_WHOLE_ROW_BYTES = 4096
_WHOLE_TILE_SMEM = 113 * 1024
_CHUNK_BYTES = 2048
_CHUNK_STAGES = 2


class SharedPlan(NamedTuple):
    """A launch of the shared-K kernel: G lanes a unit of 4 rows x 4
    elements, tiles of RB rows x EB elements (a block each, row blocks x
    element blocks of them), `chunk` bytes of a row a stage (the whole row
    when `stages` is 1), `stages` stages, `smem` bytes of shared memory a
    block."""
    G: int
    RB: int
    EB: int
    chunk: int
    stages: int
    row_blocks: int
    elem_blocks: int
    smem: int


@functools.lru_cache(maxsize=1024)
def shared_plan(rows: int, cols: int, batch: int, item: int,
                sms: int) -> SharedPlan:
    """The shared-K kernel's tiles for a (rows, cols) K of `item`-byte
    elements and `batch` right-hand sides on a card of `sms` SMs: a fixed
    rule, a function of these numbers alone.

    Whole rows (at most _WHOLE_ROW_BYTES): G = the live vectors of a row
    rounded up to a power of two in [4, 32]; units (4 x 4 outputs) a block
    at least one pass of its 8 warps (8 * 32 / G units), else the units
    spread over two blocks an SM; the block's unit rectangle near square
    (each byte of a tile's K and X rows feeds as many outputs), its K part
    at most half the tile's memory, then evened out so the row and element
    blocks come out the same size.  Longer rows: 8 units a block, one a
    warp, 4 x 2 units (16 rows x 8 elements) or, for at most 4 elements,
    8 x 1, K read once per 8 elements."""
    row_bytes = -(-cols // 4) * 4 * item
    nlive = -(-cols // (16 // item))  # 16-byte vectors a row, the last partial
    units_r, units_e = -(-rows // 4), -(-batch // 4)
    if row_bytes > _WHOLE_ROW_BYTES:
        G, ue = 32, 2 if batch > 4 else 1
        ur = 8 // ue
        chunk, stages = _CHUNK_BYTES, _CHUNK_STAGES
    else:
        G = min(32, max(4, 1 << max(nlive - 1, 0).bit_length()))
        slots = 8 * (32 // G)
        fit = _WHOLE_TILE_SMEM // max(row_bytes, 16)  # tile rows, K and X
        target = -(-max(slots, -(-units_r * units_e // (2 * sms)))
                   // slots) * slots
        side = 1 << math.isqrt(target - 1).bit_length()  # >= sqrt(target)
        ur = min(units_r, max(1, fit // 8), side)
        ur = -(-units_r // -(-units_r // ur))
        ue = min(units_e, -(-target // ur), max(1, (fit - 4 * ur) // 4))
        ue = -(-units_e // -(-units_e // ue))
        chunk, stages = max(row_bytes, 16), 1
    RB, EB = 4 * ur, 4 * ue
    return SharedPlan(G, RB, EB, chunk, stages, -(-rows // RB),
                      -(-batch // EB),
                      stages * (RB + EB) * min(row_bytes, chunk))


#: The stack kernel's stages (csrc/dense_matvec.cu:
#: dense_matvec_stack_kernel): whole rows in tiles of at most
#: _STACK_WHOLE_SMEM bytes (four blocks an SM) and at most _STACK_MAX_SLOTS
#: stages; rows longer than _WHOLE_ROW_BYTES in _STACK_CHUNK_BYTES parts (a
#: multiple of 32 vectors) through _STACK_LONG_SLOTS stages (two blocks an
#: SM).
_STACK_WHOLE_SMEM = 56 * 1024
_STACK_MAX_SLOTS = 16
_STACK_CHUNK_BYTES = 4096
_STACK_LONG_SLOTS = 3


class StackPlan(NamedTuple):
    """A launch of the stack kernel: tiles of RB rows of one element (a
    block each, row_blocks of them an element), `chunk` bytes of a row a
    stage (the whole row when it is at most _WHOLE_ROW_BYTES), `slots`
    stages of 8 rows, `smem` bytes of shared memory a block."""
    RB: int
    chunk: int
    slots: int
    row_blocks: int
    smem: int


@functools.lru_cache(maxsize=1024)
def stack_plan(rows: int, cols: int, batch: int, item: int,
               sms: int) -> StackPlan:
    """The stack kernel's tiles for `batch` distinct (rows, cols) matrices
    of `item`-byte elements on a card of `sms` SMs: a fixed rule, a
    function of these numbers alone.

    Each element's rows are cut into as many tiles as one wave of blocks
    gives it (at least one, of at least 8 rows), evened out: four blocks an
    SM for whole rows (at most _WHOLE_ROW_BYTES), two for longer ones.
    Whole rows: X[b] and then a stage a group of 8 rows, every stage of
    the tile in flight where _STACK_WHOLE_SMEM holds them (else a ring of
    as many as it holds, at least two, at most _STACK_MAX_SLOTS).  Longer rows: tiles of
    whole groups of 8 rows, each row in _STACK_CHUNK_BYTES parts, a stage
    8 rows' part and X's, _STACK_LONG_SLOTS stages."""
    row_bytes = -(-cols // 4) * 4 * item
    whole = row_bytes <= _WHOLE_ROW_BYTES
    tiles = max(1, (4 if whole else 2) * sms // max(1, batch))
    RB = max(min(rows, 8), -(-rows // tiles))
    if not whole:
        RB = -(-RB // 8) * 8
    RB = -(-rows // -(-rows // RB))  # the tiles evened out
    if whole:
        chunk = max(row_bytes, 16)
        stage = 8 * row_bytes
        groups = -(-RB // 8)
        slots = max(min(groups, 2), min(
            groups, _STACK_MAX_SLOTS,
            (_STACK_WHOLE_SMEM - row_bytes) // max(stage, 1)))
        smem = row_bytes + slots * stage
    else:
        RB = -(-RB // 8) * 8
        chunk = _STACK_CHUNK_BYTES
        slots = min(-(-RB // 8) * -(-row_bytes // chunk), _STACK_LONG_SLOTS)
        smem = slots * 9 * chunk
    return StackPlan(RB, chunk, slots, -(-rows // RB), smem)

_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def dense_matvec_batch(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y (B, rows) with Y[b] = M_b X[b] in one launch: M a row-major
    (rows, cols) view shared by every element (row stride a multiple of
    ROW_ALIGN), or a (B, rows, cols) view of a stack whose matrices sit at
    one stride; X (B, cols).

    CPU tensors take `dense_matvec_batch_plain`.  CUDA tensors launch, on
    the current stream, the shared-K kernel by `shared_plan` where the
    matrix stride is 0 (one K, read once for a tile of elements), else the
    stack kernel by `stack_plan` (csrc/dense_matvec.cu); both load X's rows
    themselves, at any row stride.  The call does not synchronise."""
    if M.device.type == "cpu" and X.device.type == "cpu":
        return dense_matvec_batch_plain(M, X)
    _check_batch("dense_matvec_batch", (M,), X, 2)
    rows, cols = M.shape[-2:]
    B = X.shape[0]
    if X.shape[1] != cols:
        raise ValueError(f"dense_matvec_batch: shapes {tuple(M.shape)} @ "
                         f"{tuple(X.shape)}")
    ld = M.stride(-2) if rows > 1 else max(M.stride(-2), cols)
    stride_m = M.stride(0) if M.dim() == 3 else 0
    if ((M.stride(-1) != 1 and cols > 1) or ld % ROW_ALIGN or ld < cols
            or stride_m % ROW_ALIGN):
        raise ValueError(
            f"dense_matvec_batch: strides {M.stride()} — rows must be "
            f"contiguous with row and matrix strides multiples of "
            f"{ROW_ALIGN}")
    if M.data_ptr() % 16:
        raise ValueError("dense_matvec_batch: M must be 16-byte aligned")
    if rows >= 2**31 or cols >= 2**31 or B >= 2**31:
        raise ValueError("dense_matvec_batch: dimension exceeds int32")
    Y = torch.empty((B, rows), dtype=M.dtype, device=M.device)
    if B == 0 or rows == 0:
        return Y
    sms = _sm_count(M.device)
    if stride_m == 0:
        plan = shared_plan(rows, cols, B, M.element_size(), sms)[:5]
    else:
        p = stack_plan(rows, cols, B, M.element_size(), sms)
        plan = (0, p.RB, 1, p.chunk, p.slots)
    Xp = X if X.stride(-1) == 1 or cols <= 1 else X.contiguous()
    lib = _load()
    fn = (lib.tpdlp_dense_matvec_batch_f32 if M.dtype == torch.float32
          else lib.tpdlp_dense_matvec_batch_f64)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        code = fn(M.data_ptr(), Xp.data_ptr(), Y.data_ptr(), rows, cols, ld,
                  B, stride_m, Xp.stride(0), rows, *plan, stream)
    _check(code, "dense_matvec_batch launch")
    launches["dense_matvec_batch"] += 1
    return Y


def _band_windows_batch(starts, X, n, WB):
    """(B, ngroups, WB) windows X[b, start : start + WB], zero past n; starts
    (ngroups,) shared or (B, ngroups)."""
    col = starts.long()[..., None] + torch.arange(WB, device=X.device)
    safe = col.clamp(max=n - 1)
    if starts.dim() == 1:
        win = X[:, safe]
    else:
        win = torch.gather(X, 1, safe.reshape(X.shape[0], -1)).reshape(
            safe.shape)
    return torch.where(col < n, win, X.new_zeros(()))


def band_matvec_batch_plain(slabs: torch.Tensor, starts: torch.Tensor,
                            X: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Y (B, m) with Y[b] = M_b X[b] for band slabs (ngroups, R, WB) shared,
    or (B, ngroups, R, WB) stacked with starts (B, ngroups): the plain twin
    of band_matvec_batch, element by element the arithmetic of
    `band_matvec_plain` (only the groups that hold rows below m)."""
    R, WB = slabs.shape[-2:]
    live = -(-m // R)
    slabs, starts = slabs[..., :live, :, :], starts[..., :live]
    ngroups = slabs.shape[-3]
    B = X.shape[0]
    win = _band_windows_batch(starts, X, n, WB)
    S = slabs if slabs.dim() == 4 else slabs.unsqueeze(0)
    step = max(1, _PLAIN_CPU_BLOCK // max(1, ngroups * R * WB))
    if slabs.device.type != "cpu" or step >= B:
        Y = (S * win[:, :, None, :]).sum(dim=3)
    else:
        Y = torch.cat([
            ((S[i:i + step] if slabs.dim() == 4 else S)
             * win[i:i + step, :, None, :]).sum(dim=3)
            for i in range(0, B, step)])
    return Y.reshape(B, -1)[:, :m]


def band_matvec_batch(slabs: torch.Tensor, starts: torch.Tensor,
                      X: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Y (B, m) with Y[b] = M_b X[b] in one launch: slabs (ngroups, R, WB)
    and starts (ngroups,) int32 shared by every element, or a stack
    (B, ngroups, R, WB) / (B, ngroups); X (B, n).  Every element has n
    columns: a window past n reads zeros, not the next element's x.

    CPU tensors take `band_matvec_batch_plain`.  CUDA tensors launch the
    band_matvec kernel over its batch axis (csrc/band_matvec.cu) on the
    current stream; the call does not synchronise."""
    if all(t.device.type == "cpu" for t in (slabs, starts, X)):
        return band_matvec_batch_plain(slabs, starts, X, m, n)
    _check_batch("band_matvec_batch", (slabs, starts), X, 3)
    if starts.dtype != torch.int32:
        raise TypeError(f"band_matvec_batch: starts dtype {starts.dtype}, "
                        "expected int32")
    ngroups, R, WB = slabs.shape[-3:]
    B = X.shape[0]
    if starts.shape != slabs.shape[:-2] or X.shape[1] != n or n < 1:
        raise ValueError(
            f"band_matvec_batch: shapes slabs {tuple(slabs.shape)}, starts "
            f"{tuple(starts.shape)}, X {tuple(X.shape)} for n = {n}")
    if not 0 <= m <= ngroups * R:
        raise ValueError(f"band_matvec_batch: m = {m} outside the "
                         f"{ngroups} x {R} row groups")
    if WB % ROW_ALIGN or WB * slabs.element_size() > _MAX_WINDOW_BYTES:
        raise ValueError(
            f"band_matvec_batch: window {WB} must be a multiple of "
            f"{ROW_ALIGN} and at most {_MAX_WINDOW_BYTES} bytes")
    if not (slabs.is_contiguous() and starts.is_contiguous()):
        raise ValueError("band_matvec_batch: slabs and starts must be "
                         "contiguous")
    if slabs.data_ptr() % 16:
        raise ValueError("band_matvec_batch: slabs must be 16-byte aligned")
    if max(ngroups * R, n, WB, B) >= 2**31:
        raise ValueError("band_matvec_batch: dimension exceeds int32")
    Y = torch.empty((B, m), dtype=slabs.dtype, device=slabs.device)
    if B == 0 or m == 0:
        return Y
    Xp = _padded_rows(X)
    stacked = slabs.dim() == 4
    lib = _load()
    fn = (lib.tpdlp_band_matvec_batch_f32 if slabs.dtype == torch.float32
          else lib.tpdlp_band_matvec_batch_f64)
    stream = torch.cuda.current_stream(slabs.device).cuda_stream
    with torch.cuda.device(slabs.device):
        code = fn(slabs.data_ptr(), starts.data_ptr(), Xp.data_ptr(),
                  Y.data_ptr(), m, n, R, WB, B,
                  slabs.stride(0) if stacked else 0,
                  starts.stride(0) if stacked else 0, Xp.stride(0), m,
                  stream)
    _check(code, "band_matvec_batch launch")
    launches["band_matvec_batch"] += 1
    return Y


def csr_matvec_batch_plain(crow: torch.Tensor, col: torch.Tensor,
                           val: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y (B, rows) with Y[b] = M X[b] for one CSR M: the plain twin of
    csr_matvec_batch, element by element the arithmetic of
    `csr_matvec_plain`."""
    data = val[:, None] * X.t()[col.long()]
    return torch.segment_reduce(data, "sum", offsets=crow, axis=0).t()


def csr_matvec_batch(crow: torch.Tensor, col: torch.Tensor,
                     val: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y (B, rows) with Y[b] = M X[b] in one launch, for M in CSR form
    (crow, col int32, val) shared by every element; X (B, cols).

    CPU tensors take `csr_matvec_batch_plain`.  CUDA tensors launch the
    csr_matvec kernel over its batch axis (csrc/csr_matvec.cu) on the
    current stream, by the route `csr_plan` picks; the call does not
    synchronise."""
    if all(t.device.type == "cpu" for t in (crow, col, val, X)):
        return csr_matvec_batch_plain(crow, col, val, X)
    _check_batch("csr_matvec_batch", (val, crow, col), X, 1)
    if crow.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"csr_matvec_batch: index dtypes {crow.dtype}/"
                        f"{col.dtype}, expected int32")
    if (crow.dim() != 1 or col.shape != val.shape or val.dim() != 1
            or crow.numel() < 1):
        raise ValueError(
            f"csr_matvec_batch: shapes crow {tuple(crow.shape)}, col "
            f"{tuple(col.shape)}, val {tuple(val.shape)}")
    if not all(t.is_contiguous() for t in (crow, col, val)):
        raise ValueError("csr_matvec_batch: crow, col and val must be "
                         "contiguous")
    rows, nnz = crow.numel() - 1, val.numel()
    B = X.shape[0]
    if max(rows, nnz, X.shape[1], B) >= 2**31:
        raise ValueError("csr_matvec_batch: dimension exceeds int32")
    Y = torch.empty((B, rows), dtype=val.dtype, device=val.device)
    if B == 0 or rows == 0:
        return Y
    X = X.contiguous()
    plan = csr_plan(rows, nnz, val.element_size(), B, _sm_count(val.device))
    lib = _load()
    fn = getattr(lib, f"tpdlp_csr_matvec{_CSR_ENTRY[plan.path]}_batch_"
                      f"{'f32' if val.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(val.device).cuda_stream
    with torch.cuda.device(val.device):
        code = fn(crow.data_ptr(), col.data_ptr(), val.data_ptr(),
                  X.data_ptr(), Y.data_ptr(), rows, plan.G, B, X.stride(0),
                  rows, stream)
    _check(code, "csr_matvec_batch launch")
    launches["csr_matvec_batch"] += 1
    return Y
