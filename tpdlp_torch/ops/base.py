"""Abstract linear operator for the constraint matrix (counterpart of
tpdlp/ops/base.py)."""

from __future__ import annotations

import torch


class LinOp:
    """A (m, n) linear operator K with the product pair K x and K'y."""

    #: The reducer of the solver's dots and norms over this operator's
    #: vectors (solver/reduce.py): None for an operator on one device, a
    #: shard.mesh.Placement for a sharded one.
    red = None

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def mv(self, x):
        """K @ x: (n,) -> (m,)."""
        raise NotImplementedError

    def rmv(self, y):
        """K' @ y: (m,) -> (n,)."""
        raise NotImplementedError

    @property
    def slice_shape(self) -> tuple[int, int]:
        """(len of the y slice, len of the x slice) that the products take
        and give: the whole (m, n) except under a mesh."""
        return self.shape

    def mv_sums(self, x, parts=(), fast=False):
        """(K x, the x-space scalar partials `parts` summed over the whole
        space); `fast` takes mv_fast.  On one device the partials are
        already the sums; a sharded operator sums them on its product's
        collective."""
        return (self.mv_fast(x) if fast else self.mv(x)), tuple(parts)

    def rmv_sums(self, y, parts=(), fast=False):
        """(K'y, the y-space partials `parts` summed), as mv_sums."""
        return (self.rmv_fast(y) if fast else self.rmv(y)), tuple(parts)

    # Throughput variants for the PDHG step products (cfg.step_products).
    # The JAX package needs them for the TPU's rounding MXU dot; on the
    # H100 an fp32 product is exact, so every operator here keeps the
    # default: the same products as mv/rmv.
    def mv_fast(self, x):
        return self.mv(x)

    def rmv_fast(self, y):
        return self.rmv(y)

    @property
    def batch_shape(self) -> tuple:
        """Leading axes of the operator's vectors: () for one K, (B,) for a
        stack of B (tpdlp_torch/batch/stacked.py)."""
        return ()

    @property
    def has_fast_products(self) -> bool:
        """True when mv_fast/rmv_fast differ from mv/rmv (then restart
        checks refresh carried products through mv/rmv before certifying
        termination — solver/loop.py::_fresh_products)."""
        return False

    def mm(self, X):
        """K @ X: (n, b) -> (m, b)."""
        return torch.stack([self.mv(X[:, i]) for i in range(X.shape[1])], 1)

    def rmm(self, Y):
        """K' @ Y: (m, b) -> (n, b)."""
        return torch.stack([self.rmv(Y[:, i]) for i in range(Y.shape[1])], 1)

    def row_abs_norms(self, ord):
        """Per-row norms of |K| (ord "inf" or a power p) — used by scaling."""
        raise NotImplementedError

    def col_abs_norms(self, ord):
        raise NotImplementedError

    def scale(self, d_row, d_col) -> "LinOp":
        """Return the operator diag(d_row) K diag(d_col)."""
        raise NotImplementedError

    def scale_(self, d_row, d_col) -> "LinOp":
        """diag(d_row) K diag(d_col), in place where the operator can
        (scaling calls it only on a copy it owns); returns the result."""
        return self.scale(d_row, d_col)

    def astype(self, dtype) -> "LinOp":
        raise NotImplementedError
