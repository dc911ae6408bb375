"""Hand-written CUDA kernels: build, ctypes binding, wrappers, plain twins.

Kernels live in `tpdlp_torch/csrc/*.cu` and are compiled by `nvcc` into one
shared library with a plain C interface, at the first call that needs them,
into `build/tpdlp_torch/` at the root of the checkout (ignored by git).  The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and concurrent processes never load a half-written file.

Nothing CUDA-specific happens at import: the CPU tests import every module.
Each wrapper takes its kernel's plain PyTorch twin only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.  There is
no fallback.

`launches` counts kernel launches by name (a wrapper adds one where it
launches, nowhere else), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpdlp_torch"
SOURCES = ("dense_matvec.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: Row strides of matrices handed to the kernels are multiples of this many
#: elements, so 16-byte vector loads stay aligned (4 fp32 / 2 fp64 per load).
ROW_ALIGN = 4

launches = {"dense_matvec": 0}

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


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpdlp_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (if not yet built) and return the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_void_p]
            for fn in (lib.tpdlp_dense_matvec_f32,
                       lib.tpdlp_dense_matvec_f64):
                fn.argtypes = args
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
