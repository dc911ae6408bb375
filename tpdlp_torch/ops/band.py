"""Band-slab layout of a banded K, over the hand-written band matvec kernel
(counterpart of tpdlp/ops/band.py).

Rows of K are cut into groups of R = `GROUP_ROWS` consecutive rows.  Every
group's nonzero columns fall inside one window [start_g, start_g + WB):

    slab_g : (R, WB) dense     (zero outside the band)
    start_g: int32             (a multiple of 128)

    y[g*R : (g+1)*R] = slab_g @ x[start_g : start_g + WB]

The layout is the JAX package's, kept exactly: 128-aligned starts, WB a
multiple of 128 clamped to n rounded up to 128, and the group count padded
to a multiple of 8, so the parity tests compare `slabs` and `starts` array
for array.  `BandOp.from_scipy` returns None when some group's column span
exceeds the window budget (K is then not band-like).  K and K' are both
materialised: the transpose of a banded matrix is banded with the same
bandwidth.

Every product, K x and K'y, runs the CUDA kernel `band_matvec`
(ops/_kernels.py, csrc/band_matvec.cu) for CUDA tensors and its plain
PyTorch twin for CPU tensors; a fleet sharing this K (tpdlp_torch/batch)
hands them a (B, n) batch, which takes one launch of the kernel's batch
axis.  Left out of the port, on purpose:
`mv_fast`/`rmv_fast` (`_fast_ok`, `_FAST_VMEM_BUDGET`) keep the TPU's slabs
VMEM-resident through a rounding MXU dot; on the H100 an fp32 product is
exact and `has_fast_products` stays False.  Under a mesh each rank runs
the same kernel on its own range of groups (tpdlp_torch/shard/ops.py);
the JAX package swaps Pallas for take+einsum there (`use_pallas`) only
because GSPMD cannot partition a custom kernel, so that flag is left out
too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from tpdlp_torch.device import resolve_device
from tpdlp_torch.ops._kernels import (
    band_matvec,
    band_matvec_batch,
    band_matvec_plain,
)
from tpdlp_torch.ops.base import LinOp

GB = 8  # the group count pads to a multiple of this (JAX grid stripes)
#: Window starts are multiples of this many columns, and windows read x
#: zero-padded to a multiple of it (the JAX package's 128-lane layout).
LANES = 128
#: Rows per group (R) and the cap on a group's window (WB): 16 blocks of
#: 128 = 2048 columns, at most 8 KB of fp32 staged per block by the kernel.
GROUP_ROWS = 128
MAX_WINDOW = 2048


def _ceil(a, b):
    return -(-a // b)


def band_windows(starts: torch.Tensor, v: torch.Tensor, n: int,
                 WB: int) -> torch.Tensor:
    """(ngroups, WB, ...) windows v_pad[start_g : start_g + WB] of `v`
    ((n,) or (n, b)), zero-padded to a multiple of LANES rows (the JAX
    package's `_BandMat._windows`)."""
    n_pad = _ceil(n, LANES) * LANES
    v_pad = v
    if n_pad != n:
        v_pad = v.new_zeros((n_pad,) + tuple(v.shape[1:]))
        v_pad[:n] = v
    idx = starts.long()[:, None] + torch.arange(WB, device=starts.device)
    return v_pad[idx]


def _band_layout(row, col, m, n):
    """Window layout of one direction: (ngroups, WB, starts), or None when
    some group's column span exceeds MAX_WINDOW."""
    ngroups = _ceil(_ceil(m, GROUP_ROWS), GB) * GB
    grp = row // GROUP_ROWS
    lo = np.full(ngroups, n, dtype=np.int64)
    hi = np.full(ngroups, 0, dtype=np.int64)
    np.minimum.at(lo, grp, col)
    np.maximum.at(hi, grp, col)
    empty = lo > hi
    lo[empty] = 0
    hi[empty] = 0
    start = (lo // LANES) * LANES
    span = hi - start + 1
    wb = int(span.max()) if span.size else 1
    WB = _ceil(wb, LANES) * LANES
    if WB > MAX_WINDOW:
        return None
    n_pad = _ceil(n, LANES) * LANES
    WB = min(WB, n_pad)
    start = np.minimum(start, n_pad - WB)
    return ngroups, WB, start


def band_stored_elems(K):
    """Stored slab elements (fwd + bwd) of the band layout for K, without
    building the slabs.  None when K is not band-like (either direction)."""
    K = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
    total = 0
    for row, col, m, n in (
        (K.row, K.col, K.shape[0], K.shape[1]),
        (K.col, K.row, K.shape[1], K.shape[0]),
    ):
        lay = _band_layout(row.astype(np.int64), col.astype(np.int64), m, n)
        if lay is None:
            return None
        ngroups, WB, _ = lay
        total += ngroups * GROUP_ROWS * WB
    return total


@dataclasses.dataclass
class BandMat:
    """One band-slab matrix (the mv direction)."""

    slabs: torch.Tensor  # (ngroups, R, WB)
    starts: torch.Tensor  # (ngroups,) int32
    m: int
    n: int

    def matvec(self, x):
        """y = M x through the band_matvec kernel (its twin on the CPU);
        a (B, n) batch in one launch of the kernel's batch axis."""
        if x.dim() == 2:
            return band_matvec_batch(self.slabs, self.starts, x, self.m,
                                     self.n)
        return band_matvec(self.slabs, self.starts, x, self.m, self.n)

    def matvec_plain(self, x):
        return band_matvec_plain(self.slabs, self.starts, x, self.m, self.n)

    def matmat(self, X):
        """M X for X (n, b): plain batched products, off the iteration
        path (the JAX op vmaps its einsum path here)."""
        win = band_windows(self.starts, X, self.n, self.slabs.shape[2])
        Y = torch.bmm(self.slabs.to(X.dtype), win)
        return Y.reshape(-1, X.shape[1])[: self.m]

    def abs_norms(self, ord):
        """Per-row norms of |M| (ord "inf" or a power p)."""
        if ord == "inf":
            per = torch.linalg.vector_norm(self.slabs, float("inf"), dim=2)
        else:
            per = (self.slabs.abs() ** ord).sum(dim=2) ** (1.0 / ord)
        return per.reshape(-1)[: self.m]

    def _factors(self, d_row, d_col):
        """(ngroups, R, 1) row factors (zero past m) and (ngroups, 1, WB)
        window column factors (zero past n)."""
        ngroups, R, WB = self.slabs.shape
        dr = d_row
        if self.m != ngroups * R:
            dr = d_row.new_zeros((ngroups * R,))
            dr[: self.m] = d_row
        dc = band_windows(self.starts, d_col, self.n, WB)
        return dr.reshape(ngroups, R, 1), dc[:, None, :]

    def scaled(self, d_row, d_col) -> "BandMat":
        # (slab * d_row) * d_col: the JAX `_scale_mat` rounding order.
        dr, dc = self._factors(d_row, d_col)
        slabs = self.slabs * dr
        slabs.mul_(dc)
        return BandMat(slabs, self.starts, self.m, self.n)

    def scale_(self, d_row, d_col) -> "BandMat":
        dr, dc = self._factors(d_row, d_col)
        self.slabs.mul_(dr)
        self.slabs.mul_(dc)
        return self


def _build_band(K: sp.coo_matrix, dtype, device, device_build: bool,
                groups=None):
    """One direction's BandMat on `device`; None when some group's span
    exceeds MAX_WINDOW.

    `groups` = (g0, g1) builds only those groups of the layout (a rank's
    strip under a mesh, tpdlp_torch/shard/ops.py): slabs (g1 - g0, R, WB),
    their starts, and m = the rows they cover; None builds them all.

    `device_build=True` assembles the slabs on the device by a flat scatter
    of the COO triplets (index + value per nonzero shipped instead of the
    zero-padded slab array).  The caller hands duplicate-free triplets, so
    every slot receives one add: the scatter needs no sort (which would
    double the index bytes on the device) and its atomics cannot reorder
    a sum.  False builds the slabs on the host in fp64 first."""
    m, n = K.shape
    R = GROUP_ROWS
    row = K.row.astype(np.int64)
    col = K.col.astype(np.int64)
    lay = _band_layout(row, col, m, n)
    if lay is None:
        return None
    ngroups, WB, start = lay
    grp, data = row // R, K.data
    if groups is not None:
        g0, g1 = groups
        keep = (grp >= g0) & (grp < g1)
        row, col, data = row[keep] - g0 * R, col[keep], data[keep]
        grp, start = grp[keep] - g0, start[g0:g1]
        ngroups, m = g1 - g0, (g1 - g0) * R
    if device_build:
        flat = (grp * R + row % R) * WB + (col - start[grp])
        slabs = torch.zeros(ngroups * R * WB, dtype=dtype, device=device)
        slabs.scatter_add_(
            0, torch.as_tensor(flat, device=device),
            torch.as_tensor(data, dtype=dtype, device=device),
        )
        slabs = slabs.reshape(ngroups, R, WB)
    else:
        host = np.zeros((ngroups, R, WB), dtype=np.float64)
        np.add.at(host, (grp, row % R, col - start[grp]), data)
        slabs = torch.as_tensor(host, dtype=dtype, device=device)
    starts = torch.as_tensor(start.astype(np.int32), device=device)
    return BandMat(slabs, starts, m, n)


@dataclasses.dataclass
class BandOp(LinOp):
    """LinOp over band-slab layouts of K and K' (both materialised)."""

    fwd: BandMat  # K
    bwd: BandMat  # K'
    #: Nonzeros of K (fill_ratio's numerator; 0 when unknown).
    nnz: int = 0

    @classmethod
    def from_scipy(cls, K, dtype=torch.float32, *, device_build: bool = True,
                   device=None):
        """Build both directions on `device` (CUDA unless the caller names
        another); None if either side is not band-like.

        `device_build` (default) ships COO triplets and scatters the slabs
        on the device; False builds them on the host."""
        dev = resolve_device(device)
        K = K.tocoo() if sp.issparse(K) else sp.coo_matrix(np.asarray(K))
        nnz = int(K.nnz)
        if not K.has_canonical_format:
            # Duplicates are summed here, in fp64, once for both sides.
            K = K.copy()
            K.sum_duplicates()
        f = _build_band(K, dtype, dev, device_build)
        if f is None:
            return None
        b = _build_band(K.T.tocoo(), dtype, dev, device_build)
        if b is None:
            return None
        return cls(f, b, nnz)

    @property
    def shape(self):
        return (self.fwd.m, self.fwd.n)

    @property
    def dtype(self):
        return self.fwd.slabs.dtype

    @property
    def device(self):
        return self.fwd.slabs.device

    def stored_bytes(self) -> int:
        """Bytes of the K and K' slabs, i.e. what one mv+rmv pair streams."""
        return (self.fwd.slabs.numel() + self.bwd.slabs.numel()) * (
            self.fwd.slabs.element_size())

    def fill_ratio(self) -> float:
        return self.nnz / max(1, self.fwd.slabs.numel())

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

    def scale(self, d_row, d_col) -> "BandOp":
        return BandOp(self.fwd.scaled(d_row, d_col),
                      self.bwd.scaled(d_col, d_row), self.nnz)

    def scale_(self, d_row, d_col) -> "BandOp":
        # In place, with the rounding of `scale`.
        self.fwd.scale_(d_row, d_col)
        self.bwd.scale_(d_col, d_row)
        return self

    def astype(self, dtype) -> "BandOp":
        return BandOp(
            BandMat(self.fwd.slabs.to(dtype), self.fwd.starts, self.fwd.m,
                    self.fwd.n),
            BandMat(self.bwd.slabs.to(dtype), self.bwd.starts, self.bwd.m,
                    self.bwd.n),
            self.nnz,
        )
