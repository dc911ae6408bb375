"""Block-ELL sparse layout (counterpart of tpdlp/ops/blocked.py).

The matrix is cut into (BR, BC) = (8, 128) tiles, and each strip of 8 rows
stores only its nonempty tiles, padded to the strip-wise maximum count W
(ELL):

    tiles:   (mb, W, 8, 128)   zero-padded
    col_idx: (mb, W)     int32 column-block index per slot; padding slots
                               point at block 0 and hold zero tiles

    y[8i : 8i+8] = sum_w tiles[i, w] @ x_blk[col_idx[i, w]]

The layout is the JAX package's exactly (the strip count padded to a
multiple of 8, the same slot order), so the parity tests compare `tiles`
and `col_idx` array for array.  Both K and K' are materialised.

The product is the JAX package's too: one gather of x's column blocks and
one einsum over the tiles (`"bwrc,bwc->br"`).  There is no kernel to port:
the JAX package's Pallas block-ELL kernel lost to the XLA path and was
removed (tpdlp/ops/blocked.py).  On the H100 the einsum is a batched fp32
product with TF32 off, exact like the other layouts' products; the layout
is one of the autotune's candidates (ops/autotune.py), where it contends
when its padded tiles stream fewer bytes than the dense matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops.base import LinOp

BR = 8  # rows per tile
BC = 128  # columns per tile


@dataclasses.dataclass
class _EllData:
    tiles: np.ndarray  # (mb, W, BR, BC)
    col_idx: np.ndarray  # (mb, W) int32
    m: int
    n: int
    nnz: int


def _build_ell(K: sp.coo_matrix, strips=None, W=None) -> _EllData:
    """Vectorised host-side layout build (no Python per-nnz loops).

    `strips` and `W` override the strip count and the slot count: a rank's
    strips under a mesh (tpdlp_torch/shard/ops.py), whose K holds only
    their rows, keep the whole layout's W."""
    m, n = K.shape
    # Strip count rounded to a multiple of 8 (the JAX layout's).
    mb = -(-(-(-m // BR)) // 8) * 8 if strips is None else strips
    row = K.row.astype(np.int64)
    col = K.col.astype(np.int64)
    rb = row // BR
    cb = col // BC

    # Unique (row-block, col-block) pairs define the tiles.
    key = rb * ((n // BC) + 1 + 1) + cb
    uniq, tile_of_nnz = np.unique(key, return_inverse=True)
    ntiles = uniq.size
    tile_rb = (uniq // ((n // BC) + 2)).astype(np.int64)
    tile_cb = (uniq % ((n // BC) + 2)).astype(np.int64)

    # Slot position of each tile within its row strip.
    order = np.argsort(tile_rb, kind="stable")
    slot = np.empty(ntiles, dtype=np.int64)
    counts = np.bincount(tile_rb, minlength=mb)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot[order] = np.arange(ntiles) - np.repeat(starts, counts)
    if W is None:
        W = max(1, int(counts.max()) if ntiles else 1)

    tiles = np.zeros((mb, W, BR, BC), dtype=np.float64)
    col_idx = np.zeros((mb, W), dtype=np.int32)
    col_idx[tile_rb, slot[np.arange(ntiles)]] = tile_cb.astype(np.int32)

    np.add.at(
        tiles,
        (rb, slot[tile_of_nnz], row % BR, col % BC),
        K.data,
    )
    return _EllData(tiles, col_idx, m, n, int(K.nnz))


def _unique(a: np.ndarray) -> np.ndarray:
    """np.unique(a) by a sort: numpy 2.3's hash-based np.unique is several
    times slower than a sort on millions of distinct int64 keys (the tile
    keys of a K with 10M scattered nonzeros)."""
    a = np.sort(a)
    keep = np.ones(a.size, dtype=bool)
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def ell_stored_elems(K) -> int:
    """Stored tile elements (fwd + bwd) of the block-ELL layout for K,
    without building the tiles: the cheap estimate that gates the host
    build (whose zero-padded float64 tile arrays can be tens of GB for
    scattered sparsity)."""
    K = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
    total = 0
    for row, col, m, n in (
        (K.row, K.col, K.shape[0], K.shape[1]),
        (K.col, K.row, K.shape[1], K.shape[0]),
    ):
        mb = -(-(-(-m // BR)) // 8) * 8
        rb = row.astype(np.int64) // BR
        cb = col.astype(np.int64) // BC
        key = rb * ((n // BC) + 2) + cb
        uniq = _unique(key)
        tile_rb = uniq // ((n // BC) + 2)
        counts = np.bincount(tile_rb, minlength=mb)
        W = max(1, int(counts.max()) if uniq.size else 1)
        total += mb * W * BR * BC
    return total


def _padded(v: torch.Tensor, size: int) -> torch.Tensor:
    """v ((k,) or (k, b)) zero-padded to `size` rows (v itself when it
    already has them)."""
    if v.shape[0] == size:
        return v
    out = v.new_zeros((size,) + tuple(v.shape[1:]))
    out[: v.shape[0]] = v
    return out


@dataclasses.dataclass
class _EllMat:
    """One block-ELL matrix (the mv direction)."""

    tiles: torch.Tensor  # (mb, W, BR, BC)
    col_idx: torch.Tensor  # (mb, W) int32
    m: int
    n: int

    def _blocks(self, v):
        """v's column blocks gathered per slot: (mb, W, BC[, b])."""
        nb = -(-self.n // BC)
        v_blk = _padded(v, nb * BC).reshape((nb, BC) + tuple(v.shape[1:]))
        return v_blk[self.col_idx]

    def matvec(self, x):
        if x.dim() == 2:  # a (B, n) batch: the einsum of every element
            return self.matmat(x.t()).t().contiguous()
        y = torch.einsum("bwrc,bwc->br", self.tiles.to(x.dtype),
                         self._blocks(x))
        return y.reshape(-1)[: self.m]

    def matmat(self, X):
        Y = torch.einsum("bwrc,bwcj->brj", self.tiles.to(X.dtype),
                         self._blocks(X))
        return Y.reshape(-1, X.shape[1])[: self.m]

    def abs_norms(self, ord):
        """Per-row norms of |M| (ord "inf" or a power p)."""
        a = self.tiles.abs()
        if ord == "inf":
            per = torch.amax(a, dim=(1, 3))  # (mb, BR)
        else:
            per = torch.sum(a ** ord, dim=(1, 3)) ** (1.0 / ord)
        return per.reshape(-1)[: self.m]

    def _factors(self, d_row, d_col):
        """(mb, 1, BR, 1) row factors (zero past m) and (mb, W, 1, BC) slot
        column factors (zero past n)."""
        mb = self.col_idx.shape[0]
        dr = _padded(d_row, mb * BR).reshape(mb, 1, BR, 1)
        return dr, self._blocks(d_col)[:, :, None, :]

    def scaled(self, d_row, d_col) -> "_EllMat":
        # (tiles * d_row) * d_col: the JAX `_scale_mat` rounding order.
        dr, dc = self._factors(d_row, d_col)
        return _EllMat(self.tiles * dr * dc, self.col_idx, self.m, self.n)

    def scale_(self, d_row, d_col) -> "_EllMat":
        dr, dc = self._factors(d_row, d_col)
        self.tiles.mul_(dr).mul_(dc)
        return self


@dataclasses.dataclass
class BlockEllOp(LinOp):
    """LinOp over block-ELL layouts of K and K' (both materialised)."""

    fwd: _EllMat  # K
    bwd: _EllMat  # K'
    #: Nonzeros of K (fill_ratio's numerator).
    nnz: int = 0

    @classmethod
    def from_scipy(cls, K, dtype=torch.float32, *, host: bool = False,
                   device=None):
        """Build both directions on `device` (CUDA unless the caller names
        another).  `host=True` keeps the tiles in host memory (CPU
        tensors), for a caller that places them itself."""
        dev = torch.device("cpu") if host else resolve_device(device)
        K = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
        f = _build_ell(K)
        b = _build_ell(K.T.tocoo())

        def mk(e):
            return _EllMat(torch.as_tensor(e.tiles, dtype=dtype, device=dev),
                           torch.as_tensor(e.col_idx, device=dev), e.m, e.n)

        return cls(mk(f), mk(b), f.nnz)

    @property
    def shape(self):
        return (self.fwd.m, self.fwd.n)

    @property
    def dtype(self):
        return self.fwd.tiles.dtype

    @property
    def device(self):
        return self.fwd.tiles.device

    def fill_ratio(self) -> float:
        """nnz / stored entries: the bandwidth advantage over dense."""
        return self.nnz / max(1, self.fwd.tiles.numel())

    def mv(self, x):
        return self.fwd.matvec(x)

    def rmv(self, y):
        return self.bwd.matvec(y)

    def mm(self, X):
        return self.fwd.matmat(X)

    def rmm(self, Y):
        return self.bwd.matmat(Y)

    def row_abs_norms(self, ord):
        return self.fwd.abs_norms(ord)

    def col_abs_norms(self, ord):
        return self.bwd.abs_norms(ord)

    def scale(self, d_row, d_col) -> "BlockEllOp":
        return BlockEllOp(self.fwd.scaled(d_row, d_col),
                          self.bwd.scaled(d_col, d_row), self.nnz)

    def scale_(self, d_row, d_col) -> "BlockEllOp":
        # In place, with the rounding of `scale`.
        self.fwd.scale_(d_row, d_col)
        self.bwd.scale_(d_col, d_row)
        return self

    def astype(self, dtype) -> "BlockEllOp":
        return BlockEllOp(
            _EllMat(self.fwd.tiles.to(dtype), self.fwd.col_idx, self.fwd.m,
                    self.fwd.n),
            _EllMat(self.bwd.tiles.to(dtype), self.bwd.col_idx, self.bwd.m,
                    self.bwd.n),
            self.nnz,
        )
