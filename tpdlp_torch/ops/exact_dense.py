"""Exact dense operator over the hand-written matvec kernel.

Counterpart of tpdlp/ops/pallas_dense.py (`ExactDenseOp`, whose products
run the Pallas kernel `_matvec_kernel`).  Here every product, K x and K'y,
runs the CUDA kernel `dense_matvec` (ops/_kernels.py, csrc/dense_matvec.cu)
for CUDA tensors and its plain PyTorch twin for CPU tensors.  On the H100
an fp32 product is exact, so there is no separate throughput path:
`has_fast_products` is False and mv_fast/rmv_fast are mv/rmv.  A batch of
vectors (a (B, n) X, a fleet sharing this K: tpdlp_torch/batch) takes one
launch of the kernel's batch axis (`dense_matvec_batch`) per product, where
the JAX package vmaps the Pallas call.

Layout: K (m, n) is stored row-major with its row stride padded to a
multiple of `ROW_ALIGN` elements, so that the kernel's 16-byte loads stay
aligned; the padding is zero and the kernel never reads it.  K' is
materialised too (the JAX op does the same, pallas_dense.py:187-189), as
the exact transpose of the stored K, at the first product that needs it.
Scaling (`scale`) therefore only touches K: the Ruiz passes, which scale
and take norms, never build K', and after scaling K' is built once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpdlp_torch.ops._kernels import (
    ROW_ALIGN,
    dense_matvec,
    dense_matvec_batch,
)
from tpdlp_torch.ops.base import LinOp


def _ceil_to(a: int, b: int) -> int:
    return -(-a // b) * b


def pad_rows(mat: torch.Tensor) -> torch.Tensor:
    """(r, c) -> a contiguous (r, ceil(c/ROW_ALIGN)*ROW_ALIGN) copy with zero
    padding columns (no copy when `mat` already has that layout)."""
    r, c = mat.shape
    ld = _ceil_to(max(c, 1), ROW_ALIGN)
    if ld == c and mat.is_contiguous():
        return mat
    out = torch.zeros((r, ld), dtype=mat.dtype, device=mat.device)
    out[:, :c].copy_(mat)
    return out


@dataclasses.dataclass
class ExactDenseOp(LinOp):
    """Dense K with exact products through the dense_matvec kernel."""

    fwd: torch.Tensor  # (m, ld_n) padded K
    m: int
    n: int
    #: (n, ld_m) padded K', built from `fwd` at first use.
    _bwd: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)

    @classmethod
    def build(cls, mat: torch.Tensor) -> "ExactDenseOp":
        m, n = mat.shape
        return cls(pad_rows(mat), m, n)

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.fwd.dtype

    @property
    def device(self):
        return self.fwd.device

    @property
    def mat(self) -> torch.Tensor:
        """The logical (m, n) matrix, a view of the padded storage."""
        return self.fwd[:, : self.n]

    @property
    def bwd(self) -> torch.Tensor:
        """The padded K' storage, the exact transpose of `mat`."""
        if self._bwd is None:
            self._bwd = pad_rows(self.mat.t())
        return self._bwd

    def stored_bytes(self) -> int:
        """Bytes of K and K' as stored (padded), i.e. what one mv+rmv
        pair streams."""
        item = self.fwd.element_size()
        ld_m = _ceil_to(max(self.m, 1), ROW_ALIGN)
        return (self.fwd.numel() + self.n * ld_m) * item

    def mv(self, x):
        if x.dim() == 2:
            return dense_matvec_batch(self.mat, x)
        return dense_matvec(self.mat, x)

    def rmv(self, y):
        if y.dim() == 2:
            return dense_matvec_batch(self.bwd[:, : self.m], y)
        return dense_matvec(self.bwd[:, : self.m], y)

    # Batched products: plain matrix products, off the iteration path (as
    # in the JAX op, pallas_dense.py:265-269).
    def mm(self, X):
        return torch.matmul(self.mat, X)

    def rmm(self, Y):
        return torch.matmul(Y.T, self.mat).T

    def _abs_norms(self, ord, dim):
        if ord == "inf":
            # max |K| as a reduction: exact, and no |K| temporary.
            return torch.linalg.vector_norm(self.mat, float("inf"), dim=dim)
        return (self.mat.abs() ** ord).sum(dim=dim) ** (1.0 / ord)

    def row_abs_norms(self, ord):
        return self._abs_norms(ord, 1)

    def col_abs_norms(self, ord):
        return self._abs_norms(ord, 0)

    def scale(self, d_row, d_col) -> "ExactDenseOp":
        # (K * d_row) * d_col, the JAX operators' rounding order.  The
        # padding columns stay zero; K' is rebuilt lazily.
        fwd = self.fwd * d_row[:, None]
        fwd[:, : self.n].mul_(d_col[None, :])
        return ExactDenseOp(fwd, self.m, self.n)

    def scale_(self, d_row, d_col) -> "ExactDenseOp":
        # In place, with the rounding of `scale`; drops a stale K'.
        self.fwd.mul_(d_row[:, None])
        self.fwd[:, : self.n].mul_(d_col[None, :])
        self._bwd = None
        return self

    def astype(self, dtype) -> "ExactDenseOp":
        return ExactDenseOp(self.fwd.to(dtype), self.m, self.n)
