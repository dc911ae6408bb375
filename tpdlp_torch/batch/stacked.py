"""Stacked operators of a fleet of distinct constraint matrices
(counterpart of the per-element `DenseOp` and `BandOp` that
tpdlp/batch/vmapped.py vmaps, `_batch_init` and `_batch_init_band`).

Every element is zero-padded to the fleet's (m, n) with the JAX package's
exactness-preserving padding (`_pad_stack`: padded rows are inequality rows
with 0 rhs, padded variables fixed at 0).  The products of all B elements
take one launch each: K1's batch axis over a matrix stride for the dense
stack, K2's batch axis over per-element slabs and starts for the band
stack (ops/_kernels.py).  Scaling keeps per-element (B, m) / (B, n)
diagonals (scaling/ruiz.py, which stops each element at its own
convergence, as the JAX package's Ruiz `while_loop` does under vmap).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.ops._kernels import (
    ROW_ALIGN,
    band_matvec_batch,
    dense_matvec_batch,
)
from tpdlp_torch.ops.band import LANES, BandOp
from tpdlp_torch.ops.base import LinOp


def _ceil_to(a: int, b: int) -> int:
    return -(-a // b) * b


def _pad_last(mat: torch.Tensor) -> torch.Tensor:
    """(B, r, c) -> a contiguous (B, r, ceil(c/ROW_ALIGN)*ROW_ALIGN) copy with
    zero padding columns."""
    B, r, c = mat.shape
    out = torch.zeros((B, r, _ceil_to(max(c, 1), ROW_ALIGN)),
                      dtype=mat.dtype, device=mat.device)
    out[:, :, :c].copy_(mat)
    return out


def _cols(d: torch.Tensor) -> torch.Tensor:
    """A column factor (n,) or (B, n) as a (.., 1, n) broadcast."""
    return d.unsqueeze(-2)


def _rows(d: torch.Tensor) -> torch.Tensor:
    """A row factor (m,) or (B, m) as a (.., m, 1) broadcast."""
    return d.unsqueeze(-1)


@dataclasses.dataclass
class StackedDenseOp(LinOp):
    """B dense (m, n) matrices at one stride, products through K1's batch
    axis."""

    fwd: torch.Tensor  # (B, m, ld_n) padded stack
    m: int
    n: int
    #: (B, n, ld_m) padded stack of the transposes, built at first use.
    _bwd: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)

    @classmethod
    def from_problems(cls, problems, m: int, n: int, dtype, device):
        """The padded stack of the problems' K, scattered on `device` from
        their (duplicate-free, fp64-summed) COO triplets."""
        B = len(problems)
        ld = _ceil_to(max(n, 1), ROW_ALIGN)
        fwd = torch.zeros((B, m, ld), dtype=dtype, device=device)
        parts = []
        for b, p in enumerate(problems):
            co = sp.coo_matrix(p.K, dtype=np.float64)
            co.sum_duplicates()
            parts.append((np.full(co.nnz, b, np.int64), co.row, co.col,
                          co.data))
        b_idx, row, col, val = (np.concatenate(v) for v in zip(*parts))
        idx = tuple(torch.as_tensor(v.astype(np.int64), device=device)
                    for v in (b_idx, row, col))
        fwd.index_put_(idx, torch.as_tensor(val, dtype=dtype,
                                            device=device))
        return cls(fwd, m, n)

    @property
    def batch(self) -> int:
        return self.fwd.shape[0]

    @property
    def batch_shape(self) -> tuple:
        return (self.batch,)

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
        return self.fwd[:, :, : self.n]

    @property
    def bwd(self) -> torch.Tensor:
        if self._bwd is None:
            self._bwd = _pad_last(self.mat.transpose(1, 2))
        return self._bwd

    def mv(self, x):
        return dense_matvec_batch(self.mat, x)

    def rmv(self, y):
        return dense_matvec_batch(self.bwd[:, :, : self.m], y)

    def _abs_norms(self, ord, dim):
        if ord == "inf":
            return torch.linalg.vector_norm(self.mat, float("inf"), dim=dim)
        return (self.mat.abs() ** ord).sum(dim=dim) ** (1.0 / ord)

    def row_abs_norms(self, ord):
        return self._abs_norms(ord, 2)

    def col_abs_norms(self, ord):
        return self._abs_norms(ord, 1)

    def scale(self, d_row, d_col) -> "StackedDenseOp":
        # (K * d_row) * d_col, the JAX DenseOp's rounding order.
        fwd = self.fwd * _rows(d_row)
        fwd[:, :, : self.n].mul_(_cols(d_col))
        return StackedDenseOp(fwd, self.m, self.n)

    def scale_(self, d_row, d_col) -> "StackedDenseOp":
        self.fwd.mul_(_rows(d_row))
        self.fwd[:, :, : self.n].mul_(_cols(d_col))
        self._bwd = None
        return self

    def take(self, sel: torch.Tensor) -> "StackedDenseOp":
        """The elements `sel` (compaction)."""
        bwd = None if self._bwd is None else self._bwd[sel]
        return StackedDenseOp(self.fwd[sel], self.m, self.n, bwd)


def _window_cols(starts, d, n, WB):
    """(B, ngroups, WB) windows of the column factor d ((n,) or (B, n)),
    zero past n."""
    col = starts.long()[..., None] + torch.arange(WB, device=d.device)
    safe = col.clamp(max=n - 1)
    if d.dim() == 1:
        win = d[safe]
    else:
        B = d.shape[0]
        win = torch.gather(d, 1, safe.reshape(B, -1)).reshape(safe.shape)
    return torch.where(col < n, win, d.new_zeros(()))


@dataclasses.dataclass
class StackedBandMat:
    """One direction of a band stack: slabs (B, ngroups, R, WB), starts
    (B, ngroups) int32."""

    slabs: torch.Tensor
    starts: torch.Tensor
    m: int
    n: int

    def matvec(self, x):
        return band_matvec_batch(self.slabs, self.starts, x, self.m, self.n)

    def abs_norms(self, ord):
        if ord == "inf":
            per = torch.linalg.vector_norm(self.slabs, float("inf"), dim=3)
        else:
            per = (self.slabs.abs() ** ord).sum(dim=3) ** (1.0 / ord)
        return per.reshape(per.shape[0], -1)[:, : self.m]

    def _factors(self, d_row, d_col):
        B, ngroups, R, WB = self.slabs.shape
        dr = d_row.expand(B, self.m)
        if self.m != ngroups * R:
            dr = torch.nn.functional.pad(dr, (0, ngroups * R - self.m))
        dc = _window_cols(self.starts, d_col, self.n, WB)
        return dr.reshape(B, ngroups, R, 1), dc[:, :, None, :]

    def scaled(self, d_row, d_col) -> "StackedBandMat":
        # (slab * d_row) * d_col: the JAX `_scale_mat` rounding order.
        dr, dc = self._factors(d_row, d_col)
        slabs = self.slabs * dr
        slabs.mul_(dc)
        return StackedBandMat(slabs, self.starts, self.m, self.n)

    def scale_(self, d_row, d_col) -> "StackedBandMat":
        dr, dc = self._factors(d_row, d_col)
        self.slabs.mul_(dr)
        self.slabs.mul_(dc)
        return self

    def take(self, sel) -> "StackedBandMat":
        return StackedBandMat(self.slabs[sel], self.starts[sel], self.m,
                              self.n)


@dataclasses.dataclass
class StackedBandOp(LinOp):
    """B band-slab matrices in one common layout, products through K2's
    batch axis."""

    fwd: StackedBandMat
    bwd: StackedBandMat

    @property
    def batch(self) -> int:
        return self.fwd.slabs.shape[0]

    @property
    def batch_shape(self) -> tuple:
        return (self.batch,)

    @property
    def shape(self):
        return (self.fwd.m, self.fwd.n)

    @property
    def dtype(self):
        return self.fwd.slabs.dtype

    @property
    def device(self):
        return self.fwd.slabs.device

    def mv(self, x):
        return self.fwd.matvec(x)

    def rmv(self, y):
        return self.bwd.matvec(y)

    def row_abs_norms(self, ord):
        return self.fwd.abs_norms(ord)

    def col_abs_norms(self, ord):
        return self.bwd.abs_norms(ord)

    def scale(self, d_row, d_col) -> "StackedBandOp":
        return StackedBandOp(self.fwd.scaled(d_row, d_col),
                             self.bwd.scaled(d_col, d_row))

    def scale_(self, d_row, d_col) -> "StackedBandOp":
        self.fwd.scale_(d_row, d_col)
        self.bwd.scale_(d_col, d_row)
        return self

    def take(self, sel) -> "StackedBandOp":
        return StackedBandOp(self.fwd.take(sel), self.bwd.take(sel))


def band_stack(problems, dtype, m_max: int, n_max: int):
    """Stack DISTINCT banded matrices into one common band-slab layout
    (the JAX `_band_stack`).

    Every instance is zero-padded to (m_max, n_max), built on the host into
    the band-slab layout, and the per-group windows are widened to the
    batch's widest WB, so all elements share one (B, G, 128, WB) slab array
    per direction.  A group whose window would overrun the padded column
    count is shifted left by whole 128-lane blocks, with its slab content
    moved right by the same amount: the represented matrix is unchanged.

    Returns ((fwd_slabs, fwd_starts), (bwd_slabs, bwd_starts)) as host numpy
    arrays; raises ValueError naming the first instance whose matrix is not
    band-like."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    ops = []
    for p in problems:
        co = p.K.tocoo() if sp.issparse(p.K) else sp.coo_matrix(
            np.asarray(p.K))
        Kp = sp.coo_matrix((co.data, (co.row, co.col)),
                           shape=(m_max, n_max))
        op = BandOp.from_scipy(Kp, dtype, device_build=False, device="cpu")
        if op is None:
            raise ValueError(
                f"matrix_format='band': instance "
                f"{getattr(p, 'name', '?')!r} is not band-like at the "
                f"padded shape ({m_max} x {n_max}); use matrix_format="
                "'dense' for this fleet"
            )
        ops.append(op)

    def stack(side):
        mats = [getattr(o, side) for o in ops]
        G, R, _ = mats[0].slabs.shape
        WB = max(m_.slabs.shape[2] for m_ in mats)
        n_pad = -(-mats[0].n // LANES) * LANES
        slabs = np.zeros((len(mats), G, R, WB), np_dtype)
        starts = np.zeros((len(mats), G), np.int32)
        for i, m_ in enumerate(mats):
            wb = m_.slabs.shape[2]
            old = m_.starts.numpy().astype(np.int64)
            new_start = np.clip(old, 0, max(0, n_pad - WB))
            shift = old - new_start  # >= 0, multiples of LANES
            host = m_.slabs.numpy()
            for g in range(G):
                s = int(shift[g])
                slabs[i, g, :, s:s + wb] = host[g]
            starts[i] = new_start
        return slabs, starts

    return stack("fwd"), stack("bwd")


def band_stack_op(stack, m: int, n: int, device) -> StackedBandOp:
    """The StackedBandOp of `band_stack`'s arrays on `device`."""
    (fs, fst), (bs, bst) = stack

    def mat(slabs, starts, rows, cols):
        return StackedBandMat(torch.as_tensor(slabs, device=device),
                              torch.as_tensor(starts, device=device),
                              rows, cols)

    return StackedBandOp(mat(fs, fst, m, n), mat(bs, bst, n, m))
