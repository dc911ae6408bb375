"""Sparse CSR operator (counterpart of tpdlp/ops/sparse.py, `SparseOp`).

K and a materialised K' are torch `sparse_csr` tensors with int32 indices,
each with its column indices sorted within a row and duplicates summed (in
fp64, on the host, before the cast).  The JAX operator keeps BCOO and lets
XLA lower its products; there is no Pallas kernel behind it.  Here every
product, K x and K'y, runs the CUDA kernel `csr_matvec` (ops/_kernels.py,
csrc/csr_matvec.cu) for CUDA tensors and its plain PyTorch twin for CPU
tensors: a solve through this layout replays bit for bit, as the dense and
band layouts do, which cuSPARSE's default SpMV does not promise.

The norms that scaling takes are fixed-order reductions over each row's
segment (rows over the CSR of K, columns over the CSR of K'), with no float
atomics, so Ruiz scaling gives the same factors on every run.  The norm of
an empty row or column is 0, as `LinOp.row_abs_norms` says and the dense,
band and block-ELL operators give.  The JAX `SparseOp` returns -inf there
(`jax.ops.segment_max`'s identity), which turns Ruiz's factors into NaN;
the port does not copy that.

The batched products `mm`/`rmm` (off the iteration path) are torch's own
sparse-dense products.  A fleet sharing this K (tpdlp_torch/batch) hands
`mv`/`rmv` a (B, n) batch, which takes one launch of the kernel's batch
axis (`csr_matvec_batch`), so its products replay bit for bit too.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops._kernels import csr_matvec, csr_matvec_batch
from tpdlp_torch.ops.base import LinOp


def _canonical_csr(K) -> sp.csr_matrix:
    """A private fp64 CSR copy of K with sorted indices and no duplicates."""
    K = sp.csr_matrix(K, dtype=np.float64, copy=True)
    K.sum_duplicates()
    return K


def _csr_tensor(crow, col, val, shape) -> torch.Tensor:
    """A torch sparse_csr tensor over the given arrays (no copy)."""
    with warnings.catch_warnings():
        # torch warns once per process that its CSR support is in beta,
        # and (some versions) that invariant checks are off, which
        # `check_invariants=False` asks for: the arrays come from scipy's
        # canonical CSR.
        warnings.filterwarnings("ignore", message=".*Sparse CSR tensor")
        warnings.filterwarnings("ignore",
                                message=".*Sparse invariant checks")
        return torch.sparse_csr_tensor(crow, col, val, size=shape,
                                       check_invariants=False)


def _to_device(K: sp.csr_matrix, dtype, device) -> torch.Tensor:
    if K.nnz >= 2**31 or max(K.shape) >= 2**31:
        raise ValueError(f"SparseOp: {K.nnz} nonzeros in a {K.shape} K "
                         "exceed int32 indices")
    return _csr_tensor(
        torch.tensor(K.indptr.astype(np.int32), device=device),
        torch.tensor(K.indices.astype(np.int32), device=device),
        torch.tensor(K.data, dtype=dtype, device=device),
        K.shape,
    )


def _matvec(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """mat @ x; a (B, cols) batch in one launch of the kernel's batch
    axis."""
    fn = csr_matvec_batch if x.dim() == 2 else csr_matvec
    return fn(mat.crow_indices(), mat.col_indices(), mat.values(), x)


def _abs_segment_norm(mat: torch.Tensor, ord) -> torch.Tensor:
    """Per-row norms of |mat|, 0 for an empty row."""
    a = mat.values().abs()
    crow = mat.crow_indices()
    if ord == "inf":
        return torch.segment_reduce(a, "max", offsets=crow, initial=0.0)
    return torch.segment_reduce(a ** ord, "sum", offsets=crow) ** (1.0 / ord)


def _row_factors(mat: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """d[row] for every stored entry of `mat`, in storage order."""
    counts = mat.crow_indices().diff()
    return torch.repeat_interleave(d, counts, output_size=mat.values().numel())


@dataclasses.dataclass
class SparseOp(LinOp):
    """LinOp over CSR tensors of K and K' (both materialised)."""

    mat: torch.Tensor  # (m, n) sparse_csr
    mat_t: torch.Tensor  # (n, m) sparse_csr, the transpose

    @classmethod
    def from_scipy(cls, K, dtype=torch.float32, device=None) -> "SparseOp":
        """Build K and K' on `device` (CUDA unless the caller names
        another) from a scipy matrix or a dense array."""
        dev = resolve_device(device)
        K = _canonical_csr(K if sp.issparse(K) else np.asarray(K))
        Kt = _canonical_csr(K.T)
        return cls(_to_device(K, dtype, dev), _to_device(Kt, dtype, dev))

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.values().dtype

    @property
    def device(self):
        return self.mat.device

    @property
    def nnz(self) -> int:
        return int(self.mat.values().numel())

    def mv(self, x):
        return _matvec(self.mat, x)

    def rmv(self, y):
        return _matvec(self.mat_t, y)

    def mm(self, X):
        return self.mat @ X

    def rmm(self, Y):
        return self.mat_t @ Y

    def row_abs_norms(self, ord):
        return _abs_segment_norm(self.mat, ord)

    def col_abs_norms(self, ord):
        return _abs_segment_norm(self.mat_t, ord)

    @staticmethod
    def _scaled_values(mat, d_row, d_col):
        # (value * d_row[row]) * d_col[col]: the JAX operator's rounding.
        return mat.values() * _row_factors(mat, d_row) * d_col[
            mat.col_indices()]

    def scale(self, d_row, d_col) -> "SparseOp":
        def scaled(mat, dr, dc):
            return _csr_tensor(mat.crow_indices(), mat.col_indices(),
                              self._scaled_values(mat, dr, dc),
                              tuple(mat.shape))

        return SparseOp(scaled(self.mat, d_row, d_col),
                        scaled(self.mat_t, d_col, d_row))

    def scale_(self, d_row, d_col) -> "SparseOp":
        # In place, with the rounding of `scale`.
        for mat, dr, dc in ((self.mat, d_row, d_col),
                            (self.mat_t, d_col, d_row)):
            val = mat.values()
            val.mul_(_row_factors(mat, dr)).mul_(dc[mat.col_indices()])
        return self

    def astype(self, dtype) -> "SparseOp":
        return SparseOp(self.mat.to(dtype), self.mat_t.to(dtype))
