"""Sharded operators: the JAX package's mesh layouts, with the collectives
written out (see tpdlp_torch/shard/mesh.py for the design).

Each operator holds only this rank's shard of K and of K', and its
products take this rank's slice of a vector and return this rank's slice
of the result (`Placement`), with one collective each:

- `ShardedDenseOp`: rank (r, c)'s (m/R, n/C) block of K as an
  ExactDenseOp, so its products launch kernel K1 (`dense_matvec`) on the
  block: K x_c, then an `all_reduce` over row r's C ranks gives y_r's
  slice of K x; K'y_r, then an `all_reduce` over column c's R ranks gives
  x_c's slice of K'y;
- `ShardedBandOp`: the rank's contiguous range of 128-row groups of the K
  and K' slabs; a product `all_gather`s the gathered side from every
  rank's strip, then launches kernel K2 (`band_matvec`) over those groups
  against the whole vector (window starts stay global): the rank's strip
  of the result, with no collective on the output;
- `ShardedBlockEllOp`: the rank's range of 8-row strips of K's and K''s
  tiles, with the einsum of ops/blocked.py (no kernel, as in the JAX
  package), gathered as band is.

`mv_sums` / `rmv_sums` carry a few scalar partials of the gathered side's
space (x for K x, y for K'y) on the same collective and return their sums
over the whole space: a 2D row (column) holds every x (y) slice once, and
a flat gather brings one partial from each rank, summed in rank order.
The scaling's row and column norms return slices too: reduced over the
row (column) subgroup in 2D (MAX for the inf-norm, the SUM of |K|^p before
the root otherwise), local in flat, where every row lies whole in one
strip; scaling a flat strip gathers the factors of the other space once.
Every shard is built on the host from K's triplets, and each rank moves
only its own to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.ops.band import GROUP_ROWS, _build_band
from tpdlp_torch.ops.base import LinOp
from tpdlp_torch.ops.blocked import (
    BC,
    BR,
    _build_ell,
    _EllMat,
    _unique,
)
from tpdlp_torch.ops.exact_dense import ExactDenseOp
from tpdlp_torch.shard.mesh import Placement, placement


def _summed(mesh, part: torch.Tensor, parts, over: str):
    """(this rank's partial product `part` and the scalar partials
    `parts`, each summed over the `over` subgroup by one all_reduce)."""
    if not parts:
        return mesh.all_reduce(part, over=over), ()
    ln = part.shape[0]
    buf = mesh.all_reduce(torch.cat([part, torch.stack(list(parts))]),
                          over=over)
    return buf[:ln], tuple(buf[ln:])


def _gathered(mesh, strip: torch.Tensor, parts):
    """(the whole vector of every rank's `strip`, the scalar partials
    `parts` summed over the ranks in rank order), by one all_gather."""
    ln = strip.shape[0]
    buf = torch.cat([strip, torch.stack(list(parts))]) if parts else strip
    G = mesh.all_gather(buf, "product")
    return G[:, :ln].reshape(-1), tuple(G[:, ln:].sum(0))


class _Sharded(LinOp):
    """What the sharded operators share: the placement of their vectors
    (`pl`: the mesh and the padded (m, n))."""

    pl: Placement

    @property
    def mesh(self):
        return self.pl.mesh

    @property
    def shape(self):
        return (self.pl.m, self.pl.n)

    @property
    def slice_shape(self):
        (y0, y1), (x0, x1) = self.pl.y_span, self.pl.x_span
        return (y1 - y0, x1 - x0)

    @property
    def red(self):
        return self.pl.red

    def mv(self, x):
        return self.mv_sums(x)[0]

    def rmv(self, y):
        return self.rmv_sums(y)[0]


@dataclasses.dataclass
class ShardedDenseOp(_Sharded):
    """Rank (r, c)'s block of a 2D-partitioned dense K: rows y_span,
    columns x_span of the padded (m, n) matrix.  Its products take x_c and
    y_r as tensors of their own, as every slice of a sharded solve is (K1
    needs 16-byte aligned bases)."""

    pl: Placement
    local: ExactDenseOp

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def mv_sums(self, x, parts=(), fast=False):
        return _summed(self.mesh, self.local.mv(x), parts, "row")

    def rmv_sums(self, y, parts=(), fast=False):
        return _summed(self.mesh, self.local.rmv(y), parts, "col")

    def _norms(self, ord, dim, over):
        mat = self.local.mat
        if ord == "inf":
            part = torch.linalg.vector_norm(mat, float("inf"), dim=dim)
            return self.mesh.all_reduce(part, "max", "norm", over)
        part = (mat.abs() ** ord).sum(dim=dim)
        return self.mesh.all_reduce(part, "sum", "norm", over) ** (
            1.0 / ord)

    def row_abs_norms(self, ord):
        return self._norms(ord, 1, "row")

    def col_abs_norms(self, ord):
        return self._norms(ord, 0, "col")

    def scale(self, d_row, d_col) -> "ShardedDenseOp":
        return dataclasses.replace(self, local=self.local.scale(d_row,
                                                                d_col))

    def scale_(self, d_row, d_col) -> "ShardedDenseOp":
        self.local.scale_(d_row, d_col)
        return self


@dataclasses.dataclass
class _FlatShardedOp(_Sharded):
    """A rank's strip of a flat 1D partition: `fwd` holds the rows y_span
    of K, `bwd` the rows x_span of K' (a BandMat or an _EllMat over the
    whole padded vector space)."""

    pl: Placement
    fwd: object
    bwd: object

    def mv_sums(self, x, parts=(), fast=False):
        full, sums = _gathered(self.mesh, x, parts)
        return self.fwd.matvec(full), sums

    def rmv_sums(self, y, parts=(), fast=False):
        full, sums = _gathered(self.mesh, y, parts)
        return self.bwd.matvec(full), sums

    def row_abs_norms(self, ord):
        return self.fwd.abs_norms(ord)

    def col_abs_norms(self, ord):
        return self.bwd.abs_norms(ord)

    def _factors(self, d_row, d_col):
        """(whole d_row, whole d_col) from this rank's slices, by one
        all_gather: a strip's windows reach columns of every rank."""
        ln = d_row.shape[0]
        G = self.mesh.all_gather(torch.cat([d_row, d_col]), "norm")
        return G[:, :ln].reshape(-1), G[:, ln:].reshape(-1)

    def scale(self, d_row, d_col):
        row_all, col_all = self._factors(d_row, d_col)
        return dataclasses.replace(self, fwd=self.fwd.scaled(d_row, col_all),
                                   bwd=self.bwd.scaled(d_col, row_all))

    def scale_(self, d_row, d_col):
        row_all, col_all = self._factors(d_row, d_col)
        self.fwd.scale_(d_row, col_all)
        self.bwd.scale_(d_col, row_all)
        return self


class ShardedBandOp(_FlatShardedOp):
    """A rank's range of 128-row groups of the band slabs of K and K'."""

    @property
    def dtype(self):
        return self.fwd.slabs.dtype

    @property
    def device(self):
        return self.fwd.slabs.device


class ShardedBlockEllOp(_FlatShardedOp):
    """A rank's range of 8-row strips of the block-ELL tiles of K and K'."""

    @property
    def dtype(self):
        return self.fwd.tiles.dtype

    @property
    def device(self):
        return self.fwd.tiles.device


# ---------------------------------------------------------------------------
# Builders: each rank's shard from K's triplets, on the host
# ---------------------------------------------------------------------------


def _span(total: int, parts: int, i: int) -> tuple[int, int]:
    if total % parts:
        raise ValueError(f"{total} does not split over {parts} ranks")
    per = total // parts
    return i * per, (i + 1) * per


def _coo(K) -> sp.coo_matrix:
    """K's triplets, duplicates summed (in fp64, once, as the unsharded
    layouts do)."""
    K = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
    if not K.has_canonical_format:
        K = K.copy()
        K.sum_duplicates()
    return K


def dense_shard(K, mesh, dtype, device) -> ShardedDenseOp:
    """Rank (r, c)'s block of the mesh-padded (m, n) K (a scipy matrix or
    an array), as an ExactDenseOp on `device`."""
    m, n = K.shape
    R, C = mesh.shape
    r0, r1 = _span(m, R, mesh.row)
    c0, c1 = _span(n, C, mesh.col)
    if sp.issparse(K):
        block = K.tocsr()[r0:r1, c0:c1].toarray()
    else:
        block = np.asarray(K)[r0:r1, c0:c1]
    local = ExactDenseOp.build(torch.as_tensor(block, dtype=dtype,
                                               device=device))
    return ShardedDenseOp(placement(mesh, "dense", m, n), local)


def band_shard(K, mesh, dtype, device) -> ShardedBandOp:
    """The rank's groups of the band layout of the mesh-padded K; None when
    K is not band-like."""
    K = _coo(K)
    m, n = K.shape
    mats = []
    for M, rows in ((K, m), (K.T.tocoo(), n)):
        g0, g1 = _span(rows // GROUP_ROWS, mesh.size, mesh.rank)
        mat = _build_band(M, dtype, device, device_build=False,
                          groups=(g0, g1))
        if mat is None:
            return None
        mats.append(mat)
    return ShardedBandOp(placement(mesh, "band", m, n), *mats)


def _ell_width(K: sp.coo_matrix) -> int:
    """W of the whole block-ELL layout of K (its widest strip's tiles)."""
    m, n = K.shape
    key = (K.row.astype(np.int64) // BR) * ((n // BC) + 2) + (
        K.col.astype(np.int64) // BC)
    uniq = _unique(key)
    counts = np.bincount(uniq // ((n // BC) + 2))
    return max(1, int(counts.max()) if uniq.size else 1)


def ell_shard(K, mesh, dtype, device) -> ShardedBlockEllOp:
    """The rank's 8-row strips of the block-ELL layout of the mesh-padded
    K, each direction with its whole layout's W."""
    K = _coo(K)
    m, n = K.shape
    mats = []
    for M, rows in ((K, m), (K.T.tocoo(), n)):
        s0, s1 = _span(rows // BR, mesh.size, mesh.rank)
        keep = (M.row >= s0 * BR) & (M.row < s1 * BR)
        part = sp.coo_matrix(
            (M.data[keep], (M.row[keep] - s0 * BR, M.col[keep])),
            shape=((s1 - s0) * BR, M.shape[1]))
        e = _build_ell(part, strips=s1 - s0, W=_ell_width(M))
        mats.append(_EllMat(torch.as_tensor(e.tiles, dtype=dtype,
                                            device=device),
                            torch.as_tensor(e.col_idx, device=device),
                            e.m, e.n))
    return ShardedBlockEllOp(placement(mesh, "sparse", m, n), *mats)


def build_shard(K, layout: str, mesh, dtype, device):
    """This rank's shard of the mesh-padded K in `layout`: "dense" (2D
    blocks), "band" or "sparse" (block-ELL), flat strips.  ValueError when
    K is not band-like for "band"."""
    build = {"dense": dense_shard, "band": band_shard,
             "sparse": ell_shard}[layout]
    op = build(K, mesh, dtype, device)
    if op is None:
        raise ValueError(
            "matrix_format='band': K is not band-like (some row-group's "
            "column span exceeds the window budget); use 'sparse' or "
            "'auto' with this mesh")
    return op
