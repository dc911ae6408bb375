"""ctypes bindings for the C++ presolve core (counterpart of
tpdlp/presolve/cpp.py).

The core (`core.cpp` beside this file, the port's own copy) exposes a C
ABI.  At first use `g++ -O2 -fPIC -shared -std=c++17 -ffp-contract=off`
builds it into `build/tpdlp_torch/` at the root of the checkout, the
directory the CUDA kernels are built in (ignored by git), under a name
that carries a hash of the source and the flags: an edited source is
rebuilt, and concurrent processes never load a half-written file.
`-ffp-contract=off` keeps g++ from fusing a*b+c, which would break the
bit-level lockstep with the numpy engine (the tests compare the two
reduction cascades at rtol 1e-12).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from tpdlp_torch.config import Status
from tpdlp_torch.ops._kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "core.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")
_LIB = None
_lib_lock = threading.Lock()


def library_path(source: Path = SOURCE) -> Path:
    """The library built from `source`, named by a hash of it and of the
    flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpdlp_presolve_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile core.cpp (if not yet built) and return the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", lib],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE}\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)
    return out


def _lib():
    global _LIB
    with _lib_lock:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
    return _LIB


def _bind(lib):
    """Declare the core's C functions on the loaded library."""
    i64 = ctypes.c_int64
    p = ctypes.POINTER
    lib.tpdlp_presolve_run.restype = ctypes.c_void_p
    lib.tpdlp_presolve_run.argtypes = [
        i64, i64, i64,
        p(i64), p(ctypes.c_int32), p(ctypes.c_double),
        p(ctypes.c_double), p(ctypes.c_double), p(ctypes.c_double),
        p(ctypes.c_double), ctypes.c_int,
    ]
    for name, res in [
        ("tpdlp_status", ctypes.c_int),
        ("tpdlp_reduced_m", i64),
        ("tpdlp_reduced_n", i64),
        ("tpdlp_reduced_m_ineq", i64),
        ("tpdlp_reduced_nnz", i64),
        ("tpdlp_n_fixed", i64),
        ("tpdlp_rows_removed", i64),
        ("tpdlp_cols_removed", i64),
        ("tpdlp_passes", ctypes.c_int),
        ("tpdlp_obj_offset", ctypes.c_double),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.tpdlp_get_reduced.restype = None
    lib.tpdlp_get_reduced.argtypes = [
        ctypes.c_void_p, p(i64), p(ctypes.c_int32), p(ctypes.c_double),
        p(ctypes.c_double), p(ctypes.c_double), p(ctypes.c_double),
        p(ctypes.c_double),
    ]
    lib.tpdlp_get_postsolve.restype = None
    lib.tpdlp_get_postsolve.argtypes = [
        ctypes.c_void_p, p(i64), p(i64), p(ctypes.c_double)
    ]
    lib.tpdlp_n_subst.restype = i64
    lib.tpdlp_n_subst.argtypes = [ctypes.c_void_p]
    lib.tpdlp_subst_nnz.restype = i64
    lib.tpdlp_subst_nnz.argtypes = [ctypes.c_void_p]
    lib.tpdlp_dcol_nnz.restype = i64
    lib.tpdlp_dcol_nnz.argtypes = [ctypes.c_void_p]
    lib.tpdlp_get_subst_ext.restype = None
    lib.tpdlp_get_subst_ext.argtypes = [
        ctypes.c_void_p, p(i64), p(ctypes.c_double), p(ctypes.c_int8),
        p(i64), p(i64), p(ctypes.c_double),
    ]
    lib.tpdlp_get_row_map.restype = None
    lib.tpdlp_get_row_map.argtypes = [ctypes.c_void_p, p(i64)]
    lib.tpdlp_get_subst.restype = None
    lib.tpdlp_get_subst.argtypes = [
        ctypes.c_void_p, p(i64), p(ctypes.c_double), p(ctypes.c_double),
        p(i64), p(i64), p(ctypes.c_double), p(ctypes.c_int8),
    ]
    lib.tpdlp_free.restype = None
    lib.tpdlp_free.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def presolve_cpp(problem, *, max_passes: int = 25):
    """Run the C++ presolve core; same result contract as the Python path."""
    from tpdlp_torch.presolve.reductions import PostsolveData, PresolveResult
    from tpdlp_torch.problem import LPProblem

    lib = _lib()
    K = sp.csr_matrix(
        problem.K.astype(np.float64)
        if sp.issparse(problem.K)
        else np.asarray(problem.K, np.float64)
    )
    K.sum_duplicates()
    m, n = K.shape
    indptr = np.asarray(K.indptr, np.int64)
    indices = np.ascontiguousarray(K.indices, np.int32)
    data = np.ascontiguousarray(K.data, np.float64)
    c = np.ascontiguousarray(problem.c, np.float64)
    q = np.ascontiguousarray(problem.q, np.float64)
    l = np.ascontiguousarray(problem.l, np.float64)
    u = np.ascontiguousarray(problem.u, np.float64)

    h = lib.tpdlp_presolve_run(
        m, n, problem.m_ineq,
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_double),
        _ptr(c, ctypes.c_double), _ptr(q, ctypes.c_double),
        _ptr(l, ctypes.c_double), _ptr(u, ctypes.c_double),
        max_passes,
    )
    try:
        status = Status(lib.tpdlp_status(h))
        rm = lib.tpdlp_reduced_m(h)
        rn = lib.tpdlp_reduced_n(h)
        nnz = lib.tpdlp_reduced_nnz(h)
        nfix = lib.tpdlp_n_fixed(h)

        col_map = np.empty(rn, np.int64)
        fixed_idx = np.empty(nfix, np.int64)
        fixed_val = np.empty(nfix, np.float64)
        lib.tpdlp_get_postsolve(
            h, _ptr(col_map, ctypes.c_int64), _ptr(fixed_idx, ctypes.c_int64),
            _ptr(fixed_val, ctypes.c_double),
        )
        n_subst = lib.tpdlp_n_subst(h)
        subst_nnz = lib.tpdlp_subst_nnz(h)
        subst_kind = np.empty(n_subst, np.int8)
        subst_idx = np.empty(n_subst, np.int64)
        subst_scale = np.empty(n_subst, np.float64)
        subst_rhs = np.empty(n_subst, np.float64)
        subst_indptr = np.empty(n_subst + 1, np.int64)
        subst_cols = np.empty(subst_nnz, np.int64)
        subst_vals = np.empty(subst_nnz, np.float64)
        lib.tpdlp_get_subst(
            h, _ptr(subst_idx, ctypes.c_int64),
            _ptr(subst_scale, ctypes.c_double),
            _ptr(subst_rhs, ctypes.c_double),
            _ptr(subst_indptr, ctypes.c_int64),
            _ptr(subst_cols, ctypes.c_int64),
            _ptr(subst_vals, ctypes.c_double),
            _ptr(subst_kind, ctypes.c_int8),
        )
        dcol_nnz = lib.tpdlp_dcol_nnz(h)
        subst_row = np.empty(n_subst, np.int64)
        subst_cj = np.empty(n_subst, np.float64)
        subst_flag = np.empty(n_subst, np.int8)
        dcol_indptr = np.empty(n_subst + 1, np.int64)
        dcol_rows = np.empty(dcol_nnz, np.int64)
        dcol_vals = np.empty(dcol_nnz, np.float64)
        lib.tpdlp_get_subst_ext(
            h, _ptr(subst_row, ctypes.c_int64),
            _ptr(subst_cj, ctypes.c_double),
            _ptr(subst_flag, ctypes.c_int8),
            _ptr(dcol_indptr, ctypes.c_int64),
            _ptr(dcol_rows, ctypes.c_int64),
            _ptr(dcol_vals, ctypes.c_double),
        )
        row_map = np.empty(rm, np.int64)
        lib.tpdlp_get_row_map(h, _ptr(row_map, ctypes.c_int64))
        data_out = PostsolveData(
            n_orig=problem.n,
            m_orig=problem.m,
            col_map=col_map,
            fixed_idx=fixed_idx,
            fixed_val=fixed_val,
            obj_offset=lib.tpdlp_obj_offset(h),
            subst_kind=subst_kind,
            subst_idx=subst_idx,
            subst_scale=subst_scale,
            subst_rhs=subst_rhs,
            subst_indptr=subst_indptr,
            subst_cols=subst_cols,
            subst_vals=subst_vals,
            row_map=row_map,
            subst_row=subst_row,
            subst_cj=subst_cj,
            subst_flag=subst_flag,
            dcol_indptr=dcol_indptr,
            dcol_rows=dcol_rows,
            dcol_vals=dcol_vals,
        )
        rows_removed = lib.tpdlp_rows_removed(h)
        cols_removed = lib.tpdlp_cols_removed(h)
        passes = lib.tpdlp_passes(h)

        if status != Status.RUNNING:
            return PresolveResult(
                None, data_out, status, rows_removed, cols_removed, passes
            )

        r_indptr = np.empty(rm + 1, np.int64)
        r_indices = np.empty(nnz, np.int32)
        r_data = np.empty(nnz, np.float64)
        r_c = np.empty(rn, np.float64)
        r_q = np.empty(rm, np.float64)
        r_l = np.empty(rn, np.float64)
        r_u = np.empty(rn, np.float64)
        lib.tpdlp_get_reduced(
            h, _ptr(r_indptr, ctypes.c_int64), _ptr(r_indices, ctypes.c_int32),
            _ptr(r_data, ctypes.c_double), _ptr(r_c, ctypes.c_double),
            _ptr(r_q, ctypes.c_double), _ptr(r_l, ctypes.c_double),
            _ptr(r_u, ctypes.c_double),
        )
        reduced = LPProblem(
            c=r_c,
            K=sp.csr_matrix(
                (r_data, r_indices, r_indptr), shape=(rm, rn)
            ),
            q=r_q,
            m_ineq=int(lib.tpdlp_reduced_m_ineq(h)),
            l=r_l,
            u=r_u,
            name=problem.name + "+presolved",
            obj_offset=problem.obj_offset + data_out.obj_offset,
        )
        return PresolveResult(
            reduced, data_out, status, rows_removed, cols_removed, passes
        )
    finally:
        lib.tpdlp_free(h)
