"""Sharded operators: the JAX package's mesh layouts, with the collectives
written out (see tpdlp_torch/shard/mesh.py for the design).

Each operator holds only this rank's shard of K and of K', and runs the
layout's own product on it:

- `ShardedDenseOp`: rank (r, c)'s (m/R, n/C) block of K as an
  ExactDenseOp, so its products launch kernel K1 (`dense_matvec`, with
  K1's alignment contract: rows padded to ROW_ALIGN, 16-byte bases) on the
  block, against the block's slice of x (K x) or of y (K'y);
- `ShardedBandOp`: the rank's contiguous range of 128-row groups of the K
  and K' slabs, whose products launch kernel K2 (`band_matvec`) over those
  groups against the whole vector (window starts stay global);
- `ShardedBlockEllOp`: the rank's range of 8-row strips of K's and K''s
  tiles, with the einsum of ops/blocked.py (no kernel, as in the JAX
  package).

A product writes the rank's partial into a zero-filled vector of full
length and sums it over the group with one `all_reduce`: the full K x or
K'y on every rank.  The scaling's row and column norms reduce the same way
(MAX for the inf-norm, the SUM of |K|^p before the root otherwise).  Every
shard is built on the host from K's triplets, and each rank moves only its
own to its device.
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


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """`v`, or a copy of it when its base is off K1's 16-byte alignment (a
    slice that starts inside a vector)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _place(mesh, part: torch.Tensor, start: int, length: int,
           op: str = "sum", kind: str = "product") -> torch.Tensor:
    """The full-length vector whose entries [start, start + len(part))
    are this rank's `part`, reduced over the mesh's group."""
    buf = part.new_zeros(length)
    buf[start:start + part.shape[0]] = part
    return mesh.all_reduce(buf, op, kind)


class _Sharded(LinOp):
    """What the sharded operators share: the mesh and the padded (m, n)."""

    mesh: object
    m: int
    n: int

    @property
    def shape(self):
        return (self.m, self.n)


@dataclasses.dataclass
class ShardedDenseOp(_Sharded):
    """Rank (r, c)'s block of a 2D-partitioned dense K: rows [r0, r0 + mb),
    columns [c0, c0 + nb) of the padded (m, n) matrix."""

    mesh: object
    local: ExactDenseOp
    m: int
    n: int
    r0: int
    c0: int

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def _cols(self, x):
        return x[self.c0:self.c0 + self.local.n]

    def _rows(self, y):
        return y[self.r0:self.r0 + self.local.m]

    def mv(self, x):
        return _place(self.mesh, self.local.mv(_aligned(self._cols(x))),
                      self.r0, self.m)

    def rmv(self, y):
        return _place(self.mesh, self.local.rmv(_aligned(self._rows(y))),
                      self.c0, self.n)

    def _norms(self, ord, dim, start, length):
        mat = self.local.mat
        if ord == "inf":
            part = torch.linalg.vector_norm(mat, float("inf"), dim=dim)
            return _place(self.mesh, part, start, length, "max", "norm")
        part = (mat.abs() ** ord).sum(dim=dim)
        return _place(self.mesh, part, start, length, "sum",
                      "norm") ** (1.0 / ord)

    def row_abs_norms(self, ord):
        return self._norms(ord, 1, self.r0, self.m)

    def col_abs_norms(self, ord):
        return self._norms(ord, 0, self.c0, self.n)

    def _factors(self, d_row, d_col):
        return self._rows(d_row), self._cols(d_col)

    def scale(self, d_row, d_col) -> "ShardedDenseOp":
        return dataclasses.replace(
            self, local=self.local.scale(*self._factors(d_row, d_col)))

    def scale_(self, d_row, d_col) -> "ShardedDenseOp":
        self.local.scale_(*self._factors(d_row, d_col))
        return self


@dataclasses.dataclass
class _FlatShardedOp(_Sharded):
    """A rank's strip of a flat 1D partition: `fwd` holds rows [r0, r0 +
    fwd.m) of K, `bwd` rows [c0, c0 + bwd.m) of K' (a BandMat or an
    _EllMat over the whole padded vector space)."""

    mesh: object
    fwd: object
    bwd: object
    m: int
    n: int
    r0: int
    c0: int

    def mv(self, x):
        return _place(self.mesh, self.fwd.matvec(x), self.r0, self.m)

    def rmv(self, y):
        return _place(self.mesh, self.bwd.matvec(y), self.c0, self.n)

    def _norms(self, mat, ord, start, length):
        # Each row lies whole in one rank's strip: the sum is exact.
        return _place(self.mesh, mat.abs_norms(ord), start, length,
                      "max" if ord == "inf" else "sum", "norm")

    def row_abs_norms(self, ord):
        return self._norms(self.fwd, ord, self.r0, self.m)

    def col_abs_norms(self, ord):
        return self._norms(self.bwd, ord, self.c0, self.n)

    def _factors(self, d_row, d_col):
        return (d_row[self.r0:self.r0 + self.fwd.m],
                d_col[self.c0:self.c0 + self.bwd.m])

    def scale(self, d_row, d_col):
        dr, dc = self._factors(d_row, d_col)
        return dataclasses.replace(self, fwd=self.fwd.scaled(dr, d_col),
                                   bwd=self.bwd.scaled(dc, d_row))

    def scale_(self, d_row, d_col):
        dr, dc = self._factors(d_row, d_col)
        self.fwd.scale_(dr, d_col)
        self.bwd.scale_(dc, d_row)
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
    return ShardedDenseOp(mesh, local, m, n, r0, c0)


def band_shard(K, mesh, dtype, device) -> ShardedBandOp:
    """The rank's groups of the band layout of the mesh-padded K; None when
    K is not band-like."""
    K = _coo(K)
    m, n = K.shape
    mats, offsets = [], []
    for M, rows in ((K, m), (K.T.tocoo(), n)):
        g0, g1 = _span(rows // GROUP_ROWS, mesh.size, mesh.rank)
        mat = _build_band(M, dtype, device, device_build=False,
                          groups=(g0, g1))
        if mat is None:
            return None
        mats.append(mat)
        offsets.append(g0 * GROUP_ROWS)
    return ShardedBandOp(mesh, mats[0], mats[1], m, n, offsets[0],
                         offsets[1])


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
    mats, offsets = [], []
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
        offsets.append(s0 * BR)
    return ShardedBlockEllOp(mesh, mats[0], mats[1], m, n, offsets[0],
                             offsets[1])


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
